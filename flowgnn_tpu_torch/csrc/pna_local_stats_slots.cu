// PNA per-layer slot aggregates for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_stats_ell (which, despite its name, runs over the slot layout).
// Same operands, same output: slot_src [NW*W, S] each row's in-window sources
// (sentinel W for an empty slot), h [n, D]; out [n, 4D] in h's type, per row
// [sum h_u | sum h_u^2 | min h_u | max h_u] over its valid slots in slot
// order, the min seeded at min_init and the max at max_init. The PNA model
// passes (MAX_INIT, MIN_INIT): the min's seed is the upper ap_fixed extreme.
// An empty slot adds nothing to the sums and leaves min and max alone, so a
// row with no local source keeps the seeds. The spill tail's terms are merged
// by the caller after this output is rounded to h's type, as in the JAX
// package.
//
// The TPU kernel gathers each slot's sources with a [W, W] one-hot matmul on
// the MXU. Here a block owns one window: it stages the window's h in shared
// memory as f32 (40 KB at W=128, D=80) with its slot table, and one warp per
// destination row, lanes over D, reads its sources by index: the stats loop
// of csrc/pna_local_model.cu. Sums use __fadd_rn / __fmul_rn, as the plain
// version rounds each product and sum.
//
// What bounds it on this card: the bytes. h is read once, the slot table
// once, and 4D values written per row; the arithmetic (five operations per
// valid slot and column) is small against it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;  // widest D: kLaneD columns per lane
constexpr int kLaneD = kMaxD / 32;
constexpr int kMaxSlots = 8;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ inline size_t smem_words(int window, int d, int slots) {
  return size_t(window) * d + size_t(window) * slots;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pna_stats_kernel(const int* __restrict__ slot_src, const T* __restrict__ h,
                 T* __restrict__ out, int n, int window, int d, int slots,
                 float min_init, float max_init) {
  extern __shared__ float smem[];
  const int W = window, D = d, S = slots, tid = threadIdx.x;
  float* h_s = smem;                                       // [W][D]
  int* src_s = reinterpret_cast<int*>(smem + size_t(W) * D);  // [W][S]
  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < n ? ld(h + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int i = tid; i < W * S; i += kThreads) src_s[i] = slot_src[row0 * S + i];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < W && row0 + r < n; r += kWarps) {
    float s[kLaneD], q[kLaneD], mn[kLaneD], mx[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      s[j] = 0.f; q[j] = 0.f; mn[j] = min_init; mx[j] = max_init;
    }
    for (int k = 0; k < S; ++k) {
      const int src = src_s[r * S + k];
      if (unsigned(src) >= unsigned(W)) continue;  // empty slot
      const float* hu = h_s + src * D;
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        const float x = hu[c];
        s[j] = __fadd_rn(s[j], x);
        q[j] = __fadd_rn(q[j], __fmul_rn(x, x));
        mn[j] = fminf(mn[j], x);
        mx[j] = fmaxf(mx[j], x);
      }
    }
    T* o = out + (row0 + r) * 4 * D;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      o[c] = cvt<T>(s[j]);
      o[D + c] = cvt<T>(q[j]);
      o[2 * D + c] = cvt<T>(mn[j]);
      o[3 * D + c] = cvt<T>(mx[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* slot_src, const void* h, void* out, int num_windows,
                   int n, int window, int d, int slots, float min_init,
                   float max_init, cudaStream_t stream) {
  const size_t bytes = smem_words(window, d, slots) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pna_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  pna_stats_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_src), static_cast<const T*>(h),
      static_cast<T*>(out), n, window, d, slots, min_init, max_init);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pna_stats_max_d() { return kMaxD; }
int pna_stats_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_stats_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long pna_stats_smem_bytes(int window, int d, int slots) {
  return (long long)(smem_words(window, d, slots) * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, out). slot_src [num_windows*window,
// slots]: int32; out [n, 4d]. Returns a cudaError_t.
int pna_stats_launch(int dtype, const void* slot_src, const void* h, void* out,
                     int num_windows, int n, int window, int d, int slots,
                     float min_init, float max_init, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_src, h, out, num_windows, n, window, d, slots,
                        min_init, max_init, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_src, h, out, num_windows, n, window, d, slots,
                                min_init, max_init, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* pna_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
