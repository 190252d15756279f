// GAT's per-layer edge softmax over the slot layout for Hopper (sm_90a):
// kernel table row 21.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_message_slots. Same operands, same output: slot_stack [NW*S*W]
// the dest-major sources, slot_stack[w][s][r] the s-th in-window source of
// row r of window w (sentinel W for an empty slot); h [n, H*D] head-major;
// s_src and s_tgt [n, H]. Per destination row v, head k and valid slot
// source u, in slot order:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))      (raw exp, no max)
//   num[k*D:(k+1)*D] += score * h_u[k*D:(k+1)*D],  den[k] += score
// in f32, unrounded. With divide, out [n, H*D] = num / den (a zero den taken
// as 1); else out [n, H*D + H] = [num | den], for the caller to merge the
// spill tail's sums. Both in h's type, rounded once. s_tgt comes in h's type:
// the TPU kernel rounds it to it (it rides h's gather tile). A source on a
// padding row reads as zero; its score counts.
//
// An empty slot is skipped, not multiplied by a mask: the TPU kernel computes
// exp(raw) * valid on every slot, and an empty slot's raw is the row's own
// s_src, so once that passes f32 exp's overflow (88.7) it returns 0 * inf =
// NaN (ROADMAP queue 3). Here an empty slot adds nothing, whatever its score.
//
// The TPU kernel gathers every slot's [h | s_tgt] with one stacked [S*W, W]
// one-hot matmul per window. Here the sources' h stays in device memory (L1
// / L2), so a block of 256 threads owns 128 rows of a window (grid NW*W/128,
// W a whole number of 128-row tiles up to 1024) and needs no shared memory:
// the walk of rows 17 and 23 (gat_messages.cuh) with the slot rows
// (SlotRows): a row's S slots loaded by its group's first S threads at once
// and the valid ones packed by one ballot, kBatch sources' h_u rows and
// scores in flight, one exp a head and valid slot, formed by the head's
// thread and handed to its columns by shuffle, a row's inputs one row
// ahead. The walk's shape follows the heads and H*D alone, as row 17's: a
// half-warp a row, two rows' chains a warp, where H <= 16 (4 columns a
// thread where H*D <= 64, else 8), else a warp a row at 4 columns a thread.
//
// What bounds it on this card: the latency of the dependent gathers, not the
// bytes (per valid slot an H*D-wide source row, mostly from L2, and H source
// scores; per row S slot indices and s_src once and H*D (+ H) values
// written): the work in flight (rows a warp, warps an SM) sets its speed.
//
// Dims::knockout is a timing knob, never set on the model path: bit 1 skips
// the messages (every row's sums are zero, and so its quotients); the phase
// split of chip_smoke.py times the kernel with it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gat_messages.cuh"
#include "hopper.cuh"  // device_bytes

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
  int n, window, hd, heads, slots, knockout;
};

// G threads a row, C columns a thread.
template <typename T, int G, int C, bool kDivide>
__global__ void __launch_bounds__(kThreads)
gat_msg_kernel(const int* __restrict__ slot_stack, const T* __restrict__ h,
               const T* __restrict__ s_src, const T* __restrict__ s_tgt, T* __restrict__ out,
               Dims dm) {
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  if (row0 >= dm.n) return;  // padding rows only
  const gm::SlotRows walk{slot_stack + wrow0 * dm.slots, part * kRows, dm.slots};
  const bool gather = !(dm.knockout & kNoMessages);
  gm::messages<T, T, G, C, kRows, true, kDivide>(walk, h, s_src, s_tgt, nullptr, out, row0, wrow0,
                                                 row0, dm.n, dm.window, dm.hd, dm.heads, gather,
                                                 threadIdx.x, kThreads);
}

template <typename T, int G, int C>
cudaError_t launch(const void* slot_stack, const void* h, const void* s_src, const void* s_tgt,
                   void* out, int num_windows, bool divide, const Dims& dm, cudaStream_t stream) {
  const dim3 grid(num_windows * (dm.window / kRows));
  const int* ss = static_cast<const int*>(slot_stack);
  const T *hh = static_cast<const T*>(h), *sa = static_cast<const T*>(s_src),
          *sb = static_cast<const T*>(s_tgt);
  T* o = static_cast<T*>(out);
  if (divide)
    gat_msg_kernel<T, G, C, true><<<grid, kThreads, 0, stream>>>(ss, hh, sa, sb, o, dm);
  else
    gat_msg_kernel<T, G, C, false><<<grid, kThreads, 0, stream>>>(ss, hh, sa, sb, o, dm);
  return cudaGetLastError();
}

// The walk's shape for this launch's heads and H*D.
template <typename T>
cudaError_t launch_shape(const void* slot_stack, const void* h, const void* s_src,
                         const void* s_tgt, void* out, int num_windows, bool divide,
                         const Dims& dm, cudaStream_t s) {
  if (dm.heads > kHalfHeads)
    return launch<T, 32, kMaxHD / 32>(slot_stack, h, s_src, s_tgt, out, num_windows, divide, dm,
                                      s);
  if (dm.hd <= kNarrowHD)
    return launch<T, 16, kNarrowHD / 16>(slot_stack, h, s_src, s_tgt, out, num_windows, divide,
                                         dm, s);
  return launch<T, 16, kMaxHD / 16>(slot_stack, h, s_src, s_tgt, out, num_windows, divide, dm, s);
}

}  // namespace

extern "C" {

int gat_msg_max_d() { return kMaxHD; }
int gat_msg_max_heads() { return kMaxHeads; }
int gat_msg_max_slots() { return lanes::kMaxSlots; }
int gat_msg_rows_per_block() { return kRows; }
int gat_msg_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_msg_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block needs: none.
long long gat_msg_smem_bytes(int hd, int heads) {
  (void)hd;
  (void)heads;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (h, s_src, s_tgt, out). slot_stack
// [num_windows*slots*window]: int32; out [n, hd] (divide) or [n, hd + heads].
// window must be 1..kMaxWindowBlocks whole blocks of kRows rows. knockout: 0
// (see Dims). Returns a cudaError_t.
int gat_msg_launch(int dtype, const void* slot_stack, const void* h, const void* s_src,
                   const void* s_tgt, void* out, int num_windows, int n, int window, int hd,
                   int heads, int slots, int divide, int knockout, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      slots < 1 || slots > lanes::kMaxSlots || hd < 1 || hd > kMaxHD || heads < 1 ||
      heads > kMaxHeads || hd % heads || num_windows < 1)
    return int(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, hd, heads, slots, knockout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_shape<float>(slot_stack, h, s_src, s_tgt, out, num_windows, divide, dm, s);
  else if (dtype == 1)
    err = launch_shape<__nv_bfloat16>(slot_stack, h, s_src, s_tgt, out, num_windows, divide, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_msg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
