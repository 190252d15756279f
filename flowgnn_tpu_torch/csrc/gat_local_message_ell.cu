// GAT's per-layer edge-softmax sums over the ELL layout for Hopper (sm_90a):
// kernel table row 17.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_message_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond rows; the bond rows unused) per lane, h [n, H*D]
// head-major, s_src and s_tgt [n, H]; out [n, H*D + H] = [sum score * h_u |
// sum score] in h's type, the f32 sums rounded once; the caller adds the
// spill tail's sums and divides. The numerics are gat_messages.cuh's (the
// TPU kernel's): score = exp(leaky_0.2(s_src[v] + s_tgt[u])) with no max,
// s_tgt in h's type (the TPU kernel rounds it: it rides h's gather tile),
// each lane's [score * h_u | score] rounded before the f32 sum, in lane
// order; a lane whose u lies outside [0, W) reads a zero source and a zero
// s_tgt. A lane whose v lies outside the window (a sentinel lane) is
// skipped, not multiplied by a mask: the TPU kernel computes exp(raw) *
// valid on every lane, which is 0 * inf = NaN once raw passes f32 exp's
// overflow (88.7).
//
// The TPU kernel gathers [h | s_tgt] and s_src with one-hot matmuls per edge
// block of a window and scatters with a third. Here h lives in device
// memory, so a block of 256 threads owns 128 rows of a window (grid
// NW*W/128, W a whole number of 128-row tiles up to 1024) and needs no
// shared memory but its rows' lane runs: the walk of row 23's message phase
// (gat_messages.cuh), lane sources loaded G at a time, kBatch lanes' h_u
// rows and scores in flight, a row's inputs one row ahead, each row's run
// from one pass over the lanes (lanes::ell_runs). The walk's shape follows
// the heads and H*D alone: a half-warp a row, two rows' chains a warp,
// where H <= 16 (4 columns a thread where H*D <= 64, else 8), else a warp a
// row at 4 columns a thread. On both GAT ELL cells (H*D = 64, 4 heads) a
// half-warp a row ran 26% faster than a warp a row, and 4 columns a thread
// 19% faster than 8; blocks of 64 rows lost to the half-warp (PERF.md,
// section 6).
//
// What bounds it on this card: the latency of the dependent gathers, not the
// bytes (per lane 20 B of meta, an H*D-wide source row, mostly from L2, and
// H source scores; per row s_src once and H*D + H values written): the work
// in flight (rows a warp, warps an SM) sets its speed.
//
// Dims::knockout is a timing knob, never set on the model path: bit 1 skips
// the messages (every row's sums are written as zero); the phase split of
// chip_smoke.py times the kernel with it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gat_messages.cuh"

namespace {

namespace gm = gat_messages;

constexpr int kThreads = 256;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kMaxHD = 128;            // widest H*D
constexpr int kMaxHeads = 32;          // one head's score per thread of a row's group
constexpr int kHalfHeads = 16;         // a half-warp a row up to 16 heads
constexpr int kNarrowHD = 64;          // a half-warp's 4 columns a thread cover H*D <= 64
constexpr int kNoMessages = 2;         // Dims::knockout bit

struct Dims {
  int n, window, lanes, hd, heads, knockout;
};

// G threads a row, C columns a thread.
template <typename T, int G, int C>
__global__ void __launch_bounds__(kThreads)
gat_msg_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                   const T* __restrict__ s_src, const T* __restrict__ s_tgt,
                   T* __restrict__ out, Dims dm) {
  __shared__ int lo_s[kRows + 1];  // row r's lanes are [lo_s[r], lo_s[r+1])
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  if (row0 >= dm.n) return;  // padding rows only
  const int* meta_w = meta + long(win) * dm.lanes * gm::kMeta;
  const bool gather = !(dm.knockout & kNoMessages);
  if (gather) lanes::ell_runs<kRows>(meta_w, dm.lanes, part * kRows, lo_s, threadIdx.x, kThreads);
  __syncthreads();
  gm::messages<T, T, G, C, kRows, true>(meta_w, h, s_src, s_tgt, nullptr, lo_s, out, row0, wrow0,
                                        row0, dm.n, dm.window, dm.lanes, dm.hd, dm.heads, gather,
                                        threadIdx.x, kThreads);
}

template <typename T, int G, int C>
cudaError_t launch(const void* meta, const void* h, const void* s_src, const void* s_tgt,
                   void* out, int num_windows, const Dims& dm, cudaStream_t stream) {
  gat_msg_ell_kernel<T, G, C><<<num_windows * (dm.window / kRows), kThreads, 0, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h),
      static_cast<const T*>(s_src), static_cast<const T*>(s_tgt), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

// The walk's shape for this launch's heads and H*D.
template <typename T>
cudaError_t launch_shape(const void* meta, const void* h, const void* s_src, const void* s_tgt,
                         void* out, int num_windows, const Dims& dm, cudaStream_t s) {
  if (dm.heads > kHalfHeads)
    return launch<T, 32, kMaxHD / 32>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  if (dm.hd <= kNarrowHD)
    return launch<T, 16, kNarrowHD / 16>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  return launch<T, 16, kMaxHD / 16>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
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
// 1..kMaxWindowBlocks whole blocks of kRows rows. knockout: 0 (see Dims).
// Returns a cudaError_t.
int gat_msg_ell_launch(int dtype, const void* meta, const void* h, const void* s_src,
                       const void* s_tgt, void* out, int num_windows, int n, int window,
                       int lanes, int hd, int heads, int knockout, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      hd < 1 || hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads ||
      num_windows < 1 || lanes < 0)
    return int(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, hd, heads, knockout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_shape<float>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch_shape<__nv_bfloat16>(meta, h, s_src, s_tgt, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
