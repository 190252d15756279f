// One GIN / GIN-VN layer over blocked lanes for Hopper (sm_90a): the kernel
// shared by csrc/gin_local_layer_blocks.cu (the legacy local layout and the
// ELL layout with per-lane bond embeddings) and csrc/gin_layer_fused.cu (the
// edge-block layout with the messages already formed).
//
// Lanes come in blocks of `block` lanes; each block belongs to one node
// window of W rows, the blocks of a window are consecutive (block_window [NB]
// non-decreasing; null: a static grid, window w owns block w), and within a
// window's run of blocks the lanes are stably sorted by destination row
// v_local, pad lanes (v = W, the sentinel) last, so each destination row's
// lanes are one contiguous run. Per window row v over its lanes in lane
// order:
//   kGather:  acc = sum rnd(relu(h_u + vals))    vals: the lane's bond embedding
//   !kGather: acc = sum vals                     vals: the lane's message
//   act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z   = rnd(relu(act . w1^T + b1))             [D] -> [H]
//   out = rnd(z . w2^T + b2), with a ReLU when final_relu
// with f32 sums and products. Rounding points are the TPU kernels': the
// message before the f32 sum, act, and z. A lane whose u lies outside [0, W)
// reads a zero source and one whose v does lands nowhere, as the TPU kernels'
// one-hot gather and scatter give.
//
// Design, after csrc/gin_local_layer_ell.cu: h lives in device memory between
// layers; one block of 256 threads per 128 rows of a window. The TPU kernels
// walk the lane blocks in order on one core, a scalar-prefetched window id
// per grid step choosing the output tile, and carry the window's accumulator
// from step to step; here a block finds its window's run of lane blocks by
// binary search on block_window, then each row's lanes by binary search on v
// over that run, and sums them one warp per row, the lanes over D, with no
// atomics: deterministic, in lane order. act [128, D] stays in shared memory;
// the MLP is the register-tiled FMA of csrc/gin_local_layer_ell.cu (8 rows x
// 7 columns per thread), w1 and w2 staged through shared memory in chunks of
// 32 hidden units.
//
// What bounds it on this card: per 128 rows the MLP is 2*128*D*H multiply-adds
// on the CUDA cores against a few D-wide lane reads per row; device memory
// moves each lane's values, h, m_spill and out once. The FMA MLP bounds it,
// as it bounds csrc/gin_local_layer_ell.cu. wgmma and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gin_blocks {

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

// nb lane blocks of `block` lanes; u_local / v_local are `stride` ints apart.
struct Dims {
  int n, window, nb, block, stride, d, hid, final_relu;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t act, hid, w1c, w2c, b1c, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d) {
  const size_t D = d;
  Smem s;
  size_t o = 0;
  s.act = o; o += kRows * D;
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

// The first block b in [0, nb) with block_window[b] >= key.
__device__ inline int first_block(const int* __restrict__ block_window, int nb, int key) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(block_window + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
gin_blocks_kernel(const T* __restrict__ vals, const int* __restrict__ u_local,
                  const int* __restrict__ v_local, const int* __restrict__ block_window,
                  const T* __restrict__ h, const T* __restrict__ m_spill,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  const float* __restrict__ eps1, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  __shared__ long run_s[2];  // the window's lanes are [run_s[0], run_s[1])
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const Smem lay = smem_layout(dm.d);
  float* act_s = smem + lay.act;  // [kRows][D] act
  float* hid_s = smem + lay.hid;  // [kRows][kHC] a chunk of z
  float* w1c = smem + lay.w1c;    // [kHC][D+1]
  float* w2c = smem + lay.w2c;    // [D][kHC+1]
  float* b1c = smem + lay.b1c;    // [kHC]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs, from run_s[0]

  const int D = dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(part) * kRows;

  if (tid == 0) {
    const int b0 = block_window ? first_block(block_window, dm.nb, win) : min(win, dm.nb);
    const int b1 = block_window ? first_block(block_window, dm.nb, win + 1)
                                : min(win + 1, dm.nb);
    run_s[0] = long(b0) * dm.block;
    run_s[1] = long(b1) * dm.block;
  }
  __syncthreads();
  const long p0 = run_s[0];
  const int run = int(run_s[1] - p0);
  const int* v_run = v_local + p0 * dm.stride;
  // Row r's lanes are [lo_s[r], lo_s[r+1]) of the run: the first lane whose
  // v is at least the row's window-local index, by binary search over v.
  for (int r = tid; r <= kRows; r += kThreads) {
    const int key = part * kRows + r;
    int lo = 0, hi = run;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(v_run + long(mid) * dm.stride) < key) lo = mid + 1; else hi = mid;
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
      const long p = p0 + e;
      const T* val = vals + p * D;
      const T* hu = nullptr;
      if (kGather) {
        const int u = __ldg(u_local + p * dm.stride);
        if (unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n) hu = h + (wrow0 + u) * D;
      }
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        const float x = ld(val + c);
        if (kGather) acc[j] += rnd<T>(fmaxf(__fadd_rn(hu ? ld(hu + c) : 0.f, x), 0.f));
        else acc[j] += x;
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

template <typename T, bool kGather>
cudaError_t launch_typed(const void* vals, const void* u_local, const void* v_local,
                         const void* block_window, const void* h, const void* m_spill,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* eps1, void* out, int num_windows, const Dims& dm,
                         cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.d).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gin_blocks_kernel<T, kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gin_blocks_kernel<T, kGather>
      <<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
          static_cast<const T*>(vals), static_cast<const int*>(u_local),
          static_cast<const int*>(v_local), static_cast<const int*>(block_window),
          static_cast<const T*>(h), static_cast<const T*>(m_spill),
          static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
          static_cast<const T*>(b2), static_cast<const float*>(eps1), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
template <bool kGather>
int launch(int dtype, const void* vals, const void* u_local, const void* v_local,
           const void* block_window, const void* h, const void* m_spill, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* eps1, void* out,
           int num_windows, const Dims& dm, int device, void* stream) {
  if (dm.window % kRows || dm.window / kRows < 1 || dm.window / kRows > kMaxWindowBlocks ||
      dm.d < 1 || dm.d > kMaxD || dm.hid < 1 || num_windows < 1 || dm.nb < 1 || dm.block < 1 ||
      dm.stride < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_typed<float, kGather>(vals, u_local, v_local, block_window, h, m_spill, w1, b1,
                                       w2, b2, eps1, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16, kGather>(vals, u_local, v_local, block_window, h, m_spill,
                                               w1, b1, w2, b2, eps1, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
inline long long smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

}  // namespace gin_blocks
