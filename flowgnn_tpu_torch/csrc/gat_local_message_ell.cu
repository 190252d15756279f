// GAT's per-layer edge-softmax sums over the ELL layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_message_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond rows; the bond rows unused) per lane, h [n, H*D]
// head-major, s_src and s_tgt [n, H]; out [n, H*D + H] in h's type. Per
// window row v, head k and lane u -> v, in lane order:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))      (raw exp, no max)
//   out[v][k*D:(k+1)*D] += rnd(score * h_u[k*D:(k+1)*D]),  out[v][H*D+k] += rnd(score)
// with f32 sums, rounded to h's type at the end; the caller adds the spill
// tail's sums and divides. s_tgt comes in h's type: the TPU kernel rounds it
// to it (it rides h's gather tile); each lane's [score * h_u | score] is
// rounded before the sum, as the TPU kernel casts it for its scatter matmul.
// A lane whose u lies outside [0, W) reads a zero source and a zero s_tgt.
//
// A lane whose v lies outside the window (a sentinel lane) is skipped, not
// multiplied by a mask: the TPU kernel computes exp(raw) * valid on every
// lane, which is 0 * inf = NaN once raw passes f32 exp's overflow (88.7).
// Here a sentinel lane adds nothing, whatever its score.
//
// The TPU kernel gathers [h | s_tgt] and s_src with one-hot matmuls per edge
// block of a window and scatters with a third. Here, as in
// csrc/gin_local_layer_ell.cu, h lives in device memory: one block of 256
// threads owns 128 rows of a window (grid NW*W/128, W a whole number of
// 128-row tiles up to 1024), finds each row's run of lanes by binary search
// on v (the k*B lanes of a window are one run sorted by v, so any k) and sums
// it one warp per row, the lanes over H*D, with no atomics. Per lane, warp
// lane k < H computes head k's score, which the other lanes read by a warp
// shuffle (csrc/gat_local_message_slots.cu's per-head accumulate); lane k
// also keeps head k's sum of scores.
//
// What bounds it on this card: the bytes. Per lane it reads 20 B of meta and
// an H*D-wide source row (mostly from L2) and H source scores; per row s_src
// once and H*D + H values written; the arithmetic is a few operations per
// lane and column and H exps per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kMaxHD = 128;            // widest H*D: kLaneD columns per lane
constexpr int kLaneD = kMaxHD / 32;
constexpr int kMaxHeads = 32;          // one head's score per lane
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, hd, heads;
};

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

__device__ __forceinline__ float leaky_exp(float raw) {
  return expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_msg_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                   const T* __restrict__ s_src, const T* __restrict__ s_tgt,
                   T* __restrict__ out, Dims dm) {
  __shared__ int lo_s[kRows + 1];  // row r's lanes are [lo_s[r], lo_s[r+1])
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const int HD = dm.hd, H = dm.heads, dh = dm.hd / dm.heads, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  // The first lane whose v is at least the row's window-local index, by
  // binary search over v.
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

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    const float ss = lane < H ? ld(s_src + row * H + lane) : 0.f;
    float num[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) num[j] = 0.f;
    float den = 0.f;  // lane k < H: head k's
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int u = __ldg(meta_w + e * kMeta);
      // Outside the window, or a padding row: a zero source and s_tgt.
      const T* hu = unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n
                        ? h + (wrow0 + u) * HD : nullptr;
      float sc = 0.f;
      if (lane < H) {
        const float st = hu ? ld(s_tgt + (wrow0 + u) * H + lane) : 0.f;
        sc = leaky_exp(__fadd_rn(ss, st));
        den = __fadd_rn(den, rnd<T>(sc));
      }
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        const float sc_c = __shfl_sync(0xffffffffu, sc, c < HD ? c / dh : 0);
        if (c >= HD) continue;
        const float x = hu ? ld(hu + c) : 0.f;
        num[j] = __fadd_rn(num[j], rnd<T>(__fmul_rn(sc_c, x)));
      }
    }
    T* o = out + row * (HD + H);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c < HD) o[c] = cvt<T>(num[j]);
    }
    if (lane < H) o[HD + lane] = cvt<T>(den);
  }
}

template <typename T>
cudaError_t launch(const void* meta, const void* h, const void* s_src, const void* s_tgt,
                   void* out, int num_windows, const Dims& dm, cudaStream_t stream) {
  gat_msg_ell_kernel<T><<<num_windows * (dm.window / kRows), kThreads, 0, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h),
      static_cast<const T*>(s_src), static_cast<const T*>(s_tgt), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_msg_ell_max_d() { return kMaxHD; }
int gat_msg_ell_max_heads() { return kMaxHeads; }
int gat_msg_ell_rows_per_block() { return kRows; }
int gat_msg_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_msg_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs: none (the lane runs are
// static shared memory).
long long gat_msg_ell_smem_bytes(int hd, int heads) {
  (void)hd;
  (void)heads;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (h, s_src, s_tgt, out). meta
// [num_windows*lanes, 5]: int32; out [n, hd + heads]. window must be
// 1..kMaxWindowBlocks whole blocks of kRows rows. Returns a cudaError_t.
int gat_msg_ell_launch(int dtype, const void* meta, const void* h, const void* s_src,
                       const void* s_tgt, void* out, int num_windows, int n, int window,
                       int lanes, int hd, int heads, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      hd < 1 || hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads ||
      num_windows < 1 || lanes < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, hd, heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
