// One GIN / GIN-VN layer over the ELL layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// local_scatter_apply_ell_attr with the gin_local_layer_ell epilogue, and
// _local_scatter_apply_ell_wps, the same function with wps windows per grid
// step. Same operands, same output: meta [NW*lanes, 5] = (u, v, three
// bond-table rows) per lane, h and m_spill [n, D], this layer's bond table
// [vocab, D], w1 [H, D], b1 [H], w2 [D, H], b2 [D], eps1 = 1 + eps (float32);
// out [n, D] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   acc = sum rnd(relu(h_u + ee))            ee: the lane's three table rows
//   act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z   = rnd(relu(act . w1^T + b1))         [D] -> [H]
//   out = rnd(z . w2^T + b2), with a ReLU when final_relu (every layer but the last)
// Rounding points are the TPU kernel's: the message before the f32 sum, act,
// and z. A lane whose u lies outside [0, W) reads a zero source and one whose
// v does lands nowhere, as the TPU kernel's one-hot gather and scatter give.
//
// Layout (flowgnn_tpu_torch/models/base.py:as_batch, blocked="local_ell"):
// node windows of W rows, each owning `lanes` = k*B lanes, both endpoints
// window-local. The k blocks of a window are one run stably sorted by v, pad
// lanes (u = v = W) last, so each destination row's lanes are one contiguous
// run at any k.
//
// Design: h lives in device memory between layers, so the kernel needs no
// cluster: one block of 256 threads per 128 rows of a window (grid NW*W/128,
// W a whole number of 128-row tiles up to 1024). Each block finds its rows'
// lane runs by binary search on v, then sums each row's lanes one warp per
// row, the lanes over D, in f32, with no atomics: deterministic. A source row
// is read from device memory (L1 / L2). The layer's bond table and act
// [128, D] stay in shared memory; the MLP is the register-tiled FMA of
// csrc/gin_local_model.cu (8 rows x 7 columns per thread), w1 and w2 staged
// through shared memory in chunks of 32 hidden units. ~100 KB at D=100, so
// two blocks fit an SM.
//
// What bounds it on this card: per 128 rows the MLP is 2*128*D*H
// multiply-adds (5.1 M at D=100, H=200) against ~1.7 lanes per row of D-wide
// gathers; device memory moves the lanes (20 B each), h, m_spill and out
// once, a few microseconds at hep10k's W=128 buckets, so the FMA MLP on the
// CUDA cores bounds it. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kTR = 16;                // thread rows of the MLP tile
constexpr int kTC = 16;                // thread columns of the MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, d, hid, vocab, final_relu;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t act, tab, hid, w1c, w2c, b1c, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d, int vocab) {
  const size_t D = d;
  Smem s;
  size_t o = 0;
  s.act = o; o += kRows * D;
  s.tab = o; o += size_t(vocab) * D;
  s.hid = o; o += kRows * kHC;
  s.w1c = o; o += kHC * (D + 1);
  s.w2c = o; o += D * (kHC + 1);
  s.b1c = o; o += kHC;
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
gin_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ m_spill, const T* __restrict__ tab,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const float* __restrict__ eps1, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const Smem lay = smem_layout(dm.d, dm.vocab);
  float* act_s = smem + lay.act;  // [kRows][D] act
  float* tab_s = smem + lay.tab;  // [vocab][D] this layer's bond table
  float* hid_s = smem + lay.hid;  // [kRows][kHC] a chunk of z
  float* w1c = smem + lay.w1c;    // [kHC][D+1]
  float* w2c = smem + lay.w2c;    // [D][kHC+1]
  float* b1c = smem + lay.b1c;    // [kHC]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs

  const int D = dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab + i);
  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index, by binary search over v.
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

  // Messages, one warp per destination row; lane j of the warp holds columns
  // j, j + 32, ... of the row.
  const float eps = __ldg(eps1);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float acc[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int* m = meta_w + e * kMeta;
      const int u = __ldg(m);
      const T* hu = unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n
                        ? h + (wrow0 + u) * D : nullptr;
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
        acc[j] += rnd<T>(fmaxf((hu ? ld(hu + c) : 0.f) + ee, 0.f));
      }
    }
    const long row = row0 + r;
    const bool real = row < dm.n;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      const float hv = real ? ld(h + row * D + c) : 0.f;
      const float sp = real && m_spill != nullptr ? ld(m_spill + row * D + c) : 0.f;
      act_s[r * D + c] = rnd<T>(__fadd_rn(__fadd_rn(acc[j], sp), __fmul_rn(eps, hv)));
    }
  }

  // MLP over the block's rows: out = relu(act.w1^T + b1).w2^T + b2 (-> relu),
  // in chunks of kHC hidden units. Each thread owns kRowsPT x kColsPT outputs
  // in registers across all chunks.
  const int tr = tid / kTC, tc = tid % kTC;
  float o[kRowsPT][kColsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
  for (int j0 = 0; j0 < dm.hid; j0 += kHC) {
    __syncthreads();  // act is written; the previous chunk's readers are done
    for (int i = tid; i < kHC * D; i += kThreads) {
      const int j = i / D, k = i - j * D;
      w1c[j * (D + 1) + k] = j0 + j < dm.hid ? ld(w1 + long(j0 + j) * D + k) : 0.f;
    }
    for (int i = tid; i < D * kHC; i += kThreads) {
      const int c = i / kHC, j = i - c * kHC;
      w2c[c * (kHC + 1) + j] = j0 + j < dm.hid ? ld(w2 + long(c) * dm.hid + j0 + j) : 0.f;
    }
    for (int j = tid; j < kHC; j += kThreads) b1c[j] = j0 + j < dm.hid ? ld(b1 + j0 + j) : 0.f;
    __syncthreads();

    float z[kRowsPT][kHcPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kHcPT; ++m) z[i][m] = 0.f;
    for (int k = 0; k < D; ++k) {
      float a[kRowsPT], wv[kHcPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) a[i] = act_s[(tr + kTR * i) * D + k];
#pragma unroll
      for (int m = 0; m < kHcPT; ++m) wv[m] = w1c[(tc + kTC * m) * (D + 1) + k];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kHcPT; ++m) z[i][m] = fmaf(a[i], wv[m], z[i][m]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kHcPT; ++m) {
        const int j = tc + kTC * m;
        hid_s[(tr + kTR * i) * kHC + j] = rnd<T>(fmaxf(z[i][m] + b1c[j], 0.f));
      }
    __syncthreads();

    for (int j = 0; j < kHC; ++j) {
      float hv[kRowsPT], wv[kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) hv[i] = hid_s[(tr + kTR * i) * kHC + j];
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        wv[m] = c < D ? w2c[c * (kHC + 1) + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(hv[i], wv[m], o[i][m]);
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
      float v = o[i][m] + ld(b2 + c);
      if (dm.final_relu) v = fmaxf(v, 0.f);
      out[row * D + c] = cvt<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* meta, const void* h, const void* m_spill, const void* tab,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* eps1, void* out, int num_windows, const Dims& dm,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.d, dm.vocab).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gin_layer_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gin_layer_ell_kernel<T><<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h),
      static_cast<const T*>(m_spill), static_cast<const T*>(tab),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps1), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gin_layer_ell_max_d() { return kMaxD; }
int gin_layer_ell_rows_per_block() { return kRows; }
int gin_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_layer_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs.
long long gin_layer_ell_smem_bytes(int d, int vocab) {
  return (long long)(smem_layout(d, vocab).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, m_spill, tab, w1, b1, w2, b2, out).
// meta [num_windows*lanes, 5]: int32; eps1: float32 [1]; m_spill may be null
// (no spill messages); out [n, d]. window must be 1..kMaxWindowBlocks whole
// blocks of kRows rows. Returns a cudaError_t.
int gin_layer_ell_launch(int dtype, const void* meta, const void* h, const void* m_spill,
                         const void* tab, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* eps1, void* out, int num_windows, int n,
                         int window, int lanes, int d, int hid, int vocab, int final_relu,
                         int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || hid < 1 || num_windows < 1 || lanes < 0 || vocab < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d, hid, vocab, final_relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h, m_spill, tab, w1, b1, w2, b2, eps1, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h, m_spill, tab, w1, b1, w2, b2, eps1, out,
                                num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gin_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
