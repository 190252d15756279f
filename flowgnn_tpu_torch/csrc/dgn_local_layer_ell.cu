// One DGN layer, and DGN's message channels alone, over the ELL layout for
// Hopper (sm_90a): two kernels of one source.
//
// Replaces the TPU kernels flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_layer_ell (the whole layer, for an ELL batch with no spill tail)
// and dgn_local_message_ell (the channels, for the caller to merge a spill
// tail). Operands: meta [NW*lanes, 5] = (u, v, three bond rows; the bond rows
// unused) per lane, h [n, D], eig [n] and, for the whole layer, the node
// terms invd = 1/max(out_deg, 1), ews = sum over in-edges of eig_u - eig_v
// and inva = 1/sum |eig_u - eig_v| [n], the posttrans w_post [2D, D] and
// b_post [1, D]. Per window row v, over its lanes u -> v in lane order:
//   acc = sum [rnd(h_u) | rnd(eig_u * h_u)]              (f32 sums)
//   m1 = acc1,  m2 = acc2 - eig_v * m1      (the TPU kernels' factoring of
//                                            sum (eig_u - eig_v) * h_u)
// The message kernel writes [rnd(m1) | rnd(m2)] [n, 2D]; the layer kernel
//   a  = [rnd(m1 * invd_v) | rnd(|m2 - ews_v * h_v| * inva_v)]
//   h' = rnd(h + relu(a . w_post + b_post))                 [2D] -> [D]
// Rounding points are the TPU kernels': each lane's two channels before the
// f32 sum, and a; eig and the node terms come in h's type (they ride the TPU
// kernels' feature tile). The m2 and a2 chains use __fmul_rn / __fadd_rn /
// __fsub_rn: m2 - ews * h cancels, and inva reaches 1/EIG_EPS = 8192, so a
// contracted FMA would leave a residual the plain version does not have. A
// lane whose u lies outside [0, W) reads a zero source, and one whose v does
// lands nowhere.
//
// Design: the lane walk of csrc/gin_local_layer_ell.cu and the epilogue of
// csrc/dgn_local_layer_slots.cu. h lives in device memory between layers, so
// one block of 256 threads owns 128 rows of a window (grid NW*W/128, W a
// whole number of 128-row tiles up to 1024); the k*B lanes of a window are
// one run sorted by v, so the block finds each row's run by binary search on
// v (any k) and sums it one warp per row, the lanes over D, with no atomics.
// The layer kernel keeps a [128, 2D] in shared memory (102 KB at D=100) and
// runs the posttrans as register-tiled FMA (8 rows x 7 columns per thread)
// with w_post streamed from L2 in chunks of kKC = 32 input channels (12.8
// KB): ~115 KB, one block per SM. The message kernel needs only the runs.
//
// What bounds it on this card: the layer kernel, arithmetic on chip (per 128
// rows the posttrans is 128*2D*D multiply-adds, 2.6 M at D=100, against ~1.7
// lanes per row of D-wide gathers); the message kernel, the bytes (per lane
// 20 B of meta and a D-wide source row, mostly from L2, and per row h, eig
// and the 2D-wide output once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kTR = 16;                // thread rows of the posttrans tile
constexpr int kTC = 16;                // thread columns of the posttrans tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the channels
constexpr int kKC = 32;                // posttrans input channels per chunk
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, d;
};

// Shared-memory carve-up of one block, in 4-byte words: the lane runs, and
// for the layer kernel a and a chunk of w_post.
struct Smem {
  size_t lo, a, wc, total;
};

__host__ __device__ inline Smem smem_layout(int d, bool full) {
  const size_t D = d;
  Smem s;
  size_t o = 0;
  s.lo = o; o += kRows + 1;
  s.a = o; if (full) o += kRows * 2 * D;
  s.wc = o; if (full) o += size_t(kKC) * D;
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

// Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at least
// the row's window-local index, by binary search over v.
__device__ inline void lane_runs(const int* meta_w, int lanes, int part, int* lo_s) {
  for (int r = threadIdx.x; r <= kRows; r += kThreads) {
    const int key = part * kRows + r;
    int lo = 0, hi = lanes;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(meta_w + mid * kMeta + 1) < key) lo = mid + 1; else hi = mid;
    }
    lo_s[r] = lo;
  }
}

// m1 and m2 of window row r (block-local) into the warp's registers, lane j
// of the warp holding columns j, j + 32, ...
template <typename T>
__device__ inline void channels(const int* meta_w, const T* h, const T* eig, const int* lo_s,
                                int r, long wrow0, long row, const Dims& dm, float* m1,
                                float* m2) {
  const int D = dm.d, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kLaneD; ++j) { m1[j] = 0.f; m2[j] = 0.f; }
  for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
    const int u = __ldg(meta_w + e * kMeta);
    // Outside the window, or a padding row: a zero source adds nothing.
    if (unsigned(u) >= unsigned(dm.window) || wrow0 + u >= dm.n) continue;
    const T* hu = h + (wrow0 + u) * D;
    const float eu = ld(eig + wrow0 + u);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      const float x = ld(hu + c);
      m1[j] = __fadd_rn(m1[j], x);
      m2[j] = __fadd_rn(m2[j], rnd<T>(__fmul_rn(eu, x)));
    }
  }
  const float ev = ld(eig + row);
#pragma unroll
  for (int j = 0; j < kLaneD; ++j) m2[j] = __fsub_rn(m2[j], __fmul_rn(ev, m1[j]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgn_msg_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                   const T* __restrict__ eig, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  int* lo_s = reinterpret_cast<int*>(smem + smem_layout(dm.d, false).lo);
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;
  lane_runs(meta_w, dm.lanes, part, lo_s);
  __syncthreads();

  const int D = dm.d, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    float m1[kLaneD], m2[kLaneD];
    channels(meta_w, h, eig, lo_s, r, wrow0, row, dm, m1, m2);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      out[row * 2 * D + c] = cvt<T>(m1[j]);
      out[row * 2 * D + D + c] = cvt<T>(m2[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgn_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ eig, const T* __restrict__ invd,
                     const T* __restrict__ ews, const T* __restrict__ inva,
                     const T* __restrict__ w_post, const T* __restrict__ b_post,
                     T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const Smem lay = smem_layout(dm.d, true);
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs
  float* a_s = smem + lay.a;    // [kRows][2D] the rounded channels
  float* wc_s = smem + lay.wc;  // [kKC][D] a chunk of the posttrans
  const int D = dm.d, K2 = 2 * dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;
  lane_runs(meta_w, dm.lanes, part, lo_s);
  __syncthreads();

  // Channels and a, one warp per row; padding rows get a = 0.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    float* a_r = a_s + r * K2;
    if (row >= dm.n) {
      for (int c = lane; c < K2; c += 32) a_r[c] = 0.f;
      continue;
    }
    float m1[kLaneD], m2[kLaneD];
    channels(meta_w, h, eig, lo_s, r, wrow0, row, dm, m1, m2);
    const float iv = ld(invd + row), ew = ld(ews + row), ia = ld(inva + row);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      const float dir = __fsub_rn(m2[j], __fmul_rn(ew, ld(h + row * D + c)));
      a_r[c] = rnd<T>(__fmul_rn(m1[j], iv));
      a_r[D + c] = rnd<T>(__fmul_rn(fabsf(dir), ia));
    }
  }

  // Posttrans: y[r][c] = sum_k a[r][k] . w_post[k][c], the weight streamed
  // in chunks of kKC input channels; then h' = rnd(h + relu(y + b)).
  const int tr = tid / kTC, tc = tid % kTC;
  float acc[kRowsPT][kColsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
  for (int kc = 0; kc < K2; kc += kKC) {
    const int kn = K2 - kc < kKC ? K2 - kc : kKC;
    __syncthreads();  // a is written; the last chunk is consumed
    for (int i = tid; i < kn * D; i += kThreads) wc_s[i] = ld(w_post + long(kc) * D + i);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float a[kRowsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) a[i] = a_s[(tr + kTR * i) * K2 + kc + kk];
      const float* wrow = wc_s + kk * D;
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        const float wv = c < D ? wrow[c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(a[i], wv, acc[i][m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const long row = row0 + tr + kTR * i;
    if (row >= dm.n) continue;
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      if (c >= D) continue;
      const float y = __fadd_rn(acc[i][m], ld(b_post + c));
      out[row * D + c] = cvt<T>(__fadd_rn(ld(h + row * D + c), fmaxf(y, 0.f)));
    }
  }
}

template <typename T>
cudaError_t launch(bool full, const void* meta, const void* h, const void* eig,
                   const void* invd, const void* ews, const void* inva, const void* w_post,
                   const void* b_post, void* out, int num_windows, const Dims& dm,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.d, full).total * 4;
  const int blocks = num_windows * (dm.window / kRows);
  cudaError_t err;
  if (full) {
    err = cudaFuncSetAttribute(dgn_layer_ell_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    dgn_layer_ell_kernel<T><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(eig),
        static_cast<const T*>(invd), static_cast<const T*>(ews), static_cast<const T*>(inva),
        static_cast<const T*>(w_post), static_cast<const T*>(b_post), static_cast<T*>(out),
        dm);
  } else {
    dgn_msg_ell_kernel<T><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(eig),
        static_cast<T*>(out), dm);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dgn_layer_ell_max_d() { return kMaxD; }
int dgn_layer_ell_rows_per_block() { return kRows; }
int dgn_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_layer_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs: full = 1 the layer kernel,
// 0 the message kernel.
long long dgn_layer_ell_smem_bytes(int d, int full) {
  return (long long)(smem_layout(d, full != 0).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, invd, ews, inva, w_post, b_post,
// out). full = 1: the whole layer, out [n, d]; full = 0: the channels, out
// [n, 2d], and invd, ews, inva, w_post and b_post may be null. meta
// [num_windows*lanes, 5]: int32. window must be 1..kMaxWindowBlocks whole
// blocks of kRows rows. Returns a cudaError_t.
int dgn_layer_ell_launch(int dtype, int full, const void* meta, const void* h,
                         const void* eig, const void* invd, const void* ews, const void* inva,
                         const void* w_post, const void* b_post, void* out, int num_windows,
                         int n, int window, int lanes, int d, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || num_windows < 1 || lanes < 0 ||
      (full && (!invd || !ews || !inva || !w_post || !b_post)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(full != 0, meta, h, eig, invd, ews, inva, w_post, b_post, out,
                        num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(full != 0, meta, h, eig, invd, ews, inva, w_post, b_post,
                                out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* dgn_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
