// One GCN layer over the ELL layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_layer_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond-table rows) per lane, h [n, D] (this layer's conv
// output), dis [n] = 1/sqrt(out_deg + 1), this layer's bond table [vocab, D],
// root, alpha, beta [D] (the root embedding and the folded BatchNorm), and on
// every layer but the last the next conv's w_next [D, D] as [in][out] and
// b_next [D]; out [n, D] in h's type. Per window row v, over its lanes
// u -> v in lane order:
//   acc = sum rnd(dis_u * relu(h_u + ee))      ee: the lane's three table rows
//   a   = acc * dis_v + relu(h_v + root) * dis_v^2
//   x   = alpha * a + beta
//   out = rnd(x) on the last layer, else rnd(rnd(relu(x)) . w_next + b_next)
// The residual takes dis_v^2, as the TPU kernel does, where the plain path
// divides by deg + 1. dis comes in h's type (it rides the TPU kernel's
// gather). A lane whose u lies outside [0, W) has dis_u = 0 and one whose v
// does lands nowhere. The JAX GCN runs it on every layer of an ELL batch with
// no spill tail that its whole-model kernel does not take.
//
// Layout and design as csrc/gin_local_layer_ell.cu: the k*B lanes of a window
// are one run sorted by v; one block of 256 threads per 128 rows of a window
// (W a whole number of 128-row tiles up to 1024), h in device memory, the
// lane runs found by binary search on v, one warp per destination row with
// the lanes over D, f32 sums, no atomics. The conv input rnd(relu(x)) [128,
// D] and w_next (f32, 40 KB at D=100) sit in shared memory; the conv is the
// register-tiled FMA of csrc/gcn_local_model.cu (8 rows x 7 columns per
// thread). ~98 KB at D=100.
//
// What bounds it on this card: per 128 rows the next conv is 128*D*D
// multiply-adds (1.28 M at D=100) against ~1.7 lanes per row of D-wide
// gathers; device memory moves the lanes, h, dis and out once. At molhiv's
// shapes both bounds are microseconds; the FMA conv on the CUDA cores sets
// the time. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kTR = 16;                // thread rows of the conv tile
constexpr int kTC = 16;                // thread columns of the conv tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, d, vocab;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t x, w, tab, vec, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d, int vocab) {
  const size_t D = d;
  Smem s;
  size_t o = 0;
  s.x = o; o += kRows * D;
  s.w = o; o += D * D;
  s.tab = o; o += size_t(vocab) * D;
  s.vec = o; o += 3 * D;
  s.lo = o; o += kRows + 1;
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bond-table row `a` in shared memory, or null outside the vocabulary.
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab,
                                                 int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gcn_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ dis, const T* __restrict__ tab,
                     const T* __restrict__ root, const T* __restrict__ alpha,
                     const T* __restrict__ beta, const T* __restrict__ w_next,
                     const T* __restrict__ b_next, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const Smem lay = smem_layout(dm.d, dm.vocab);
  const int D = dm.d, tid = threadIdx.x;
  const bool last = w_next == nullptr;
  float* x_s = smem + lay.x;      // [kRows][D] rnd(relu(x)), the next conv's input
  float* w_s = smem + lay.w;      // [D][D] w_next as [in][out]
  float* tab_s = smem + lay.tab;  // [vocab][D] this layer's bond table
  float* root_s = smem + lay.vec; // [D] root, then alpha and beta
  float* alpha_s = root_s + D;
  float* beta_s = alpha_s + D;
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs

  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab + i);
  for (int i = tid; i < D; i += kThreads) {
    root_s[i] = ld(root + i);
    alpha_s[i] = ld(alpha + i);
    beta_s[i] = ld(beta + i);
  }
  if (!last)
    for (int i = tid; i < D * D; i += kThreads) w_s[i] = ld(w_next + i);
  // Row r's lanes are [lo_s[r], lo_s[r+1]), by binary search over v.
  for (int r = tid; r <= kRows; r += kThreads) {
    const int key = part * kRows + r;
    int lo = 0, hi = dm.lanes;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(meta_w + mid * kMeta + 1) < key) lo = mid + 1; else hi = mid;
    }
    lo_s[r] = lo;
  }
  __syncthreads();

  // Messages and the tail, one warp per destination row; lane j of the warp
  // holds columns j, j + 32, ... of the row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    const bool real = row < dm.n;
    float acc[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int* m = meta_w + e * kMeta;
      const int u = __ldg(m);
      // Outside the window, or a padding row: dis_u = 0, no message.
      if (unsigned(u) >= unsigned(dm.window) || wrow0 + u >= dm.n) continue;
      const float dis_u = ld(dis + wrow0 + u);
      const T* hu = h + (wrow0 + u) * D;
      const float* e1 = bond_row(tab_s, __ldg(m + 2), dm.vocab, D);
      const float* e2 = bond_row(tab_s, __ldg(m + 3), dm.vocab, D);
      const float* e3 = bond_row(tab_s, __ldg(m + 4), dm.vocab, D);
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        float ee = 0.f;
        if (e1) ee += e1[c];
        if (e2) ee += e2[c];
        if (e3) ee += e3[c];
        acc[j] += rnd<T>(__fmul_rn(dis_u, fmaxf(ld(hu + c) + ee, 0.f)));
      }
    }
    const float dv = real ? ld(dis + row) : 0.f;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      const float hv = real ? ld(h + row * D + c) : 0.f;
      const float res = fmaxf(hv + root_s[c], 0.f);
      const float a = __fadd_rn(__fmul_rn(acc[j], dv), __fmul_rn(res, __fmul_rn(dv, dv)));
      const float x = __fadd_rn(__fmul_rn(alpha_s[c], a), beta_s[c]);
      if (!last) x_s[r * D + c] = rnd<T>(fmaxf(x, 0.f));
      else if (real) out[row * D + c] = cvt<T>(x);
    }
  }
  if (last) return;
  __syncthreads();

  // Next conv over the block's rows: out = rnd(x_s . w_next + b_next). Each
  // thread owns kRowsPT x kColsPT outputs in registers.
  const int tr = tid / kTC, tc = tid % kTC;
  float o[kRowsPT][kColsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
  for (int k = 0; k < D; ++k) {
    float a[kRowsPT], wv[kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) a[i] = x_s[(tr + kTR * i) * D + k];
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      wv[m] = c < D ? w_s[k * D + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(a[i], wv[m], o[i][m]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const long row = row0 + tr + kTR * i;
    if (row >= dm.n) continue;
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      if (c < D) out[row * D + c] = cvt<T>(o[i][m] + ld(b_next + c));
    }
  }
}

template <typename T>
cudaError_t launch(const void* meta, const void* h, const void* dis, const void* tab,
                   const void* root, const void* alpha, const void* beta,
                   const void* w_next, const void* b_next, void* out, int num_windows,
                   const Dims& dm, cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.d, dm.vocab).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_layer_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gcn_layer_ell_kernel<T><<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(dis),
      static_cast<const T*>(tab), static_cast<const T*>(root), static_cast<const T*>(alpha),
      static_cast<const T*>(beta), static_cast<const T*>(w_next),
      static_cast<const T*>(b_next), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gcn_layer_ell_max_d() { return kMaxD; }
int gcn_layer_ell_rows_per_block() { return kRows; }
int gcn_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_layer_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs.
long long gcn_layer_ell_smem_bytes(int d, int vocab) {
  return (long long)(smem_layout(d, vocab).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, dis, tab, root, alpha, beta, w_next,
// b_next, out). meta [num_windows*lanes, 5]: int32; w_next and b_next both
// null on the last layer; out [n, d]. window must be 1..kMaxWindowBlocks whole
// blocks of kRows rows. Returns a cudaError_t.
int gcn_layer_ell_launch(int dtype, const void* meta, const void* h, const void* dis,
                         const void* tab, const void* root, const void* alpha,
                         const void* beta, const void* w_next, const void* b_next, void* out,
                         int num_windows, int n, int window, int lanes, int d, int vocab,
                         int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || num_windows < 1 || lanes < 0 || vocab < 0 ||
      (w_next == nullptr) != (b_next == nullptr))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d, vocab};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h, dis, tab, root, alpha, beta, w_next, b_next, out,
                        num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h, dis, tab, root, alpha, beta, w_next, b_next, out,
                                num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gcn_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
