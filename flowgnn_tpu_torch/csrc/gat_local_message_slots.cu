// GAT per-layer edge softmax over the slot layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_message_slots. Same operands, same output: slot_stack [NW*S*W]
// the dest-major sources, slot_stack[w][s][r] the s-th in-window source of
// row r of window w (sentinel W for an empty slot); h [n, H*D] head-major;
// s_src and s_tgt [n, H]. Per destination row v, head k and valid slot
// source u, in slot order:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))      (raw exp, no max)
//   num[k*D:(k+1)*D] += score * h_u[k*D:(k+1)*D],  den[k] += score
// With divide, out [n, H*D] = num / den (a zero den taken as 1); else out
// [n, H*D + H] = [num | den], for the caller to merge the spill tail's sums.
// Both in h's type. s_tgt comes in h's type: the TPU kernel rounds it to it
// (it rides h's gather tile).
//
// An empty slot is skipped, not multiplied by a mask: the TPU kernel computes
// exp(raw) * valid on every slot, and an empty slot's raw is the row's own
// s_src, so once that passes f32 exp's overflow (88.7) it returns 0 * inf =
// NaN (ROADMAP queue 3). Here an empty slot adds nothing, whatever its score.
//
// The TPU kernel gathers every slot's [h | s_tgt] with one stacked [S*W, W]
// one-hot matmul. Here a block owns one window: it stages the window's h, s_tgt
// and s_src in shared memory as f32 (41 KB at W=128, H*D=64, S=8 with the slot
// table), and one warp per destination row, lanes over H*D, reads the sources
// by index; lane k (< H) also keeps head k's denominator, which the divide
// reads by a warp shuffle.
//
// What bounds it on this card: the bytes. h and the scores are read once and
// one row of H*D (+H) values written per node; the arithmetic is a few
// operations and one exp per valid slot and column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHD = 128;  // widest H*D: kLaneD columns per lane
constexpr int kLaneD = kMaxHD / 32;
constexpr int kMaxHeads = 32;  // one denominator per lane
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

__host__ __device__ inline size_t smem_words(int window, int hd, int heads, int slots) {
  return size_t(window) * (hd + 2 * heads + slots);
}

__device__ __forceinline__ float leaky_exp(float raw) {
  return expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_msg_kernel(const int* __restrict__ slot_stack, const T* __restrict__ h,
               const T* __restrict__ s_src, const T* __restrict__ s_tgt,
               T* __restrict__ out, int n, int window, int hd, int heads, int slots,
               int divide) {
  extern __shared__ float smem[];
  const int W = window, H = heads, S = slots, dh = hd / heads, tid = threadIdx.x;
  float* h_s = smem;                       // [W][HD]
  float* st_s = h_s + size_t(W) * hd;      // [W][H] s_tgt
  float* ss_s = st_s + size_t(W) * H;      // [W][H] s_src
  int* src_s = reinterpret_cast<int*>(ss_s + size_t(W) * H);  // [S][W]
  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * hd; i += kThreads) {
    const int r = i / hd;
    h_s[i] = row0 + r < n ? ld(h + (row0 + r) * hd + (i - r * hd)) : 0.f;
  }
  for (int i = tid; i < W * H; i += kThreads) {
    const int r = i / H;
    const bool real = row0 + r < n;
    st_s[i] = real ? ld(s_tgt + (row0 + r) * H + (i - r * H)) : 0.f;
    ss_s[i] = real ? ld(s_src + (row0 + r) * H + (i - r * H)) : 0.f;
  }
  for (int i = tid; i < S * W; i += kThreads) src_s[i] = slot_stack[row0 * S + i];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int width = divide ? hd : hd + H;
  for (int r = warp; r < W && row0 + r < n; r += kWarps) {
    float num[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) num[j] = 0.f;
    float den = 0.f;  // lane k < H: head k's
    for (int k = 0; k < S; ++k) {
      const int src = src_s[k * W + r];
      if (unsigned(src) >= unsigned(W)) continue;  // empty slot: adds nothing
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= hd) break;
        const int head = c / dh;
        const float sc = leaky_exp(__fadd_rn(ss_s[r * H + head], st_s[src * H + head]));
        num[j] = __fadd_rn(num[j], __fmul_rn(sc, h_s[src * hd + c]));
      }
      if (lane < H)
        den = __fadd_rn(den, leaky_exp(__fadd_rn(ss_s[r * H + lane], st_s[src * H + lane])));
    }
    T* o = out + (row0 + r) * width;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      const float dv = __shfl_sync(0xffffffffu, den, c < hd ? c / dh : 0);
      if (c >= hd) continue;
      o[c] = cvt<T>(divide ? num[j] / (dv == 0.f ? 1.f : dv) : num[j]);
    }
    if (!divide && lane < H) o[hd + lane] = cvt<T>(den);
  }
}

template <typename T>
cudaError_t launch(const void* slot_stack, const void* h, const void* s_src,
                   const void* s_tgt, void* out, int num_windows, int n, int window,
                   int hd, int heads, int slots, int divide, cudaStream_t stream) {
  const size_t bytes = smem_words(window, hd, heads, slots) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gat_msg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gat_msg_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_stack), static_cast<const T*>(h),
      static_cast<const T*>(s_src), static_cast<const T*>(s_tgt),
      static_cast<T*>(out), n, window, hd, heads, slots, divide);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_msg_max_d() { return kMaxHD; }
int gat_msg_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_msg_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long gat_msg_smem_bytes(int window, int hd, int heads, int slots) {
  return (long long)(smem_words(window, hd, heads, slots) * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, s_src, s_tgt, out). slot_stack
// [num_windows*slots*window]: int32; out [n, hd] (divide) or [n, hd + heads].
// Returns a cudaError_t.
int gat_msg_launch(int dtype, const void* slot_stack, const void* h, const void* s_src,
                   const void* s_tgt, void* out, int num_windows, int n, int window,
                   int hd, int heads, int slots, int divide, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || hd < 1 || hd > kMaxHD || heads < 1 ||
      heads > kMaxHeads || hd % heads || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_stack, h, s_src, s_tgt, out, num_windows, n, window, hd,
                        heads, slots, divide, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_stack, h, s_src, s_tgt, out, num_windows, n,
                                window, hd, heads, slots, divide, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_msg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
