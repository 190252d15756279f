// Spill-tail windowed segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/spmm.py:windowed_segment_sum.
// Same operands, same output: values [P, D] in blocked lane order (P = NB *
// block), v_local [P] each lane's row in its window (sentinel >= window on pad
// lanes), block_window [NB] each block's output window, non-decreasing; out
// [num_windows * window, D] in the values' type, row t*window + v the sum of
// the lanes of window t's blocks whose v_local is v. A window with no block
// comes out zero (the TPU kernel leaves such a window unwritten).
//
// The TPU kernel walks the blocks in order on one core and carries a window's
// f32 accumulator from one grid step to the next, flushing it at the window's
// last block. Blocks of a CUDA grid run in no order and share no state, so
// here one block owns one output window t and a chunk of kCols = 32 columns:
// it finds the run of blocks of window t by binary search on block_window,
// accumulates their lanes into an f32 shared-memory tile [window][32], and
// writes the tile once, cast to the values' type. A whole window of D = 200
// f32 columns (400 KB at window 512) does not fit one block's shared memory;
// the column chunk does (64 KB). No atomics: warp j owns the rows v with
// v % 8 == j and walks every lane of the run in order, lane k of the warp on
// column k, so each sum has the TPU kernel's lane order and is deterministic.
// Sentinel lanes add nothing.
//
// What bounds it on this card: the bytes. Each lane's values are read once
// and each output row written once (most rows of a window receive no lane and
// are written as zeros); a lane costs one add per column. So the kernel is
// bound by device memory, mostly by the output writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;  // output columns per block, one per lane

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The first block b in [0, nb) with block_window[b] > key (upper == true) or
// >= key (upper == false).
__device__ int bound(const int* __restrict__ block_window, int nb, int key, bool upper) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int w = __ldg(block_window + mid);
    if (w < key || (upper && w == key)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wss_kernel(const T* __restrict__ values, const int* __restrict__ vloc,
           const int* __restrict__ block_window, T* __restrict__ out, int nb,
           int block, int d, int window) {
  extern __shared__ float acc[];  // [window][kCols]
  const int t = blockIdx.x, c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < window * kCols; i += kThreads) acc[i] = 0.f;
  const long p0 = long(bound(block_window, nb, t, false)) * block;
  const long p1 = long(bound(block_window, nb, t, true)) * block;
  __syncthreads();

  const int c = c0 + lane;
  for (long p = p0; p < p1; ++p) {
    const int v = __ldg(vloc + p);  // the same for the whole warp
    if (unsigned(v) >= unsigned(window) || v % kWarps != warp) continue;
    if (c < d) acc[v * kCols + lane] += ld(values + p * d + c);
  }
  __syncthreads();

  T* out_t = out + long(t) * window * d;
  for (int i = tid; i < window * kCols; i += kThreads) {
    const int r = i / kCols, j = i - r * kCols;
    if (c0 + j < d) out_t[long(r) * d + c0 + j] = cvt<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* values, const void* vloc, const void* block_window,
                   void* out, int nb, int block, int d, int window, int num_windows,
                   cudaStream_t stream) {
  const size_t bytes = size_t(window) * kCols * 4;
  cudaError_t err = cudaFuncSetAttribute(
      wss_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(num_windows, (d + kCols - 1) / kCols);
  wss_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(vloc),
      static_cast<const int*>(block_window), static_cast<T*>(out), nb, block, d, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long wss_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this window.
long long wss_smem_bytes(int window) { return (long long)window * kCols * 4; }

// dtype: 0 = float32, 1 = bfloat16 (values, out). values [nb*block, d]; vloc
// [nb*block] and block_window [nb]: int32; out [num_windows*window, d].
// Returns a cudaError_t.
int wss_launch(int dtype, const void* values, const void* vloc,
               const void* block_window, void* out, int nb, int block, int d,
               int window, int num_windows, int device, void* stream) {
  if (nb < 1 || block < 1 || d < 1 || window < 1 || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(values, vloc, block_window, out, nb, block, d, window,
                        num_windows, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(values, vloc, block_window, out, nb, block, d,
                                window, num_windows, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* wss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
