// GIN / GIN-VN whole-model slot megakernel for Hopper (sm_90a): kernel
// table row 1.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_model_slots (with its helpers _slot_prefix_geom, _slot_accumulate
// and _pool_epilogue). Same operands, same output: [NW*GMAX, T] float32
// per-window pool sums of the prediction head, for all L GIN layers plus
// the finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows, rows sorted by in-degree so that slot k of rows 0..caps[k]-1
// sits in prefix lanes offs[k]..offs[k]+caps[k] of the window's Σc lanes.
// slot_meta holds per lane (src − half, three bond attrs with vocabulary
// offsets), half = W/2 up to W = 512 and 0 above; an empty lane has src =
// W − half and attrs −1 and is dropped. pool_gl holds each row's
// window-local graph id, GMAX for padding rows.
//
// The kernel is gin_model.cuh's, which row 8 runs too: a window of W = 128
// to 1024 rows on a cluster of W/128 blocks, h and act in shared memory for
// all L layers (the TPU kernel's VMEM residency), the bf16 update MLP on the
// tensor cores (gin_mlp.cuh) with its weight chunks streamed through a ring
// of bulk copies, the f32 MLP register-tiled FMA. This file runs it with
// the slot message stage (lanes.cuh: Slots): one warp per destination row reads the row's ≤ S lanes
// (lane offs[k] + row for each slot k with row < caps[k]) from device memory
// through L1, once per row, and its lanes walk D; the messages are summed in
// slot order, as the TPU kernel and the plain version sum them, with no
// division per element and no atomics. An empty lane is skipped.
//
// What bounds it on this card: the MLP is 4·W·D·H operations per window and
// layer (at W = 128, D = 100, H = 200, 45 GFLOP per molhiv stream: 0.046 ms
// at the tensor cores' 989 TFLOP/s bf16, 0.67 ms at the CUDA cores' 67 f32)
// against Σc·D gathered values from shared memory for the messages; h is
// read once and GMAX·T floats are written per window, so the kernel is
// bound on chip. In bf16 the messages, the VN stage and the barriers beside
// the tensor-core MLP bound it, in f32 the FMA MLP.

#include "gin_model.cuh"
#include "lanes.cuh"

static_assert(gin_model::kRows == lanes::kRows && gin_model::kThreads == lanes::kThreads,
              "the lane walk's block shape");

extern "C" {

int gin_slots_max_d() { return gin_model::kMaxD; }
int gin_slots_max_slots() { return lanes::kMaxSlots; }
int gin_slots_rows_per_block() { return gin_model::kRows; }
int gin_slots_max_cluster() { return gin_model::kMaxCluster; }

// The bf16 form's weight chunks, as gin_ell_mlp_dims gives them.
void gin_slots_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

long long gin_slots_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gin_slots_launch, stages the bf16 form's weight ring. The slot geometry
// does not enter it: the slot lanes stay in device memory.
long long gin_slots_smem_bytes(int dtype, int d, int hid, int vocab, int gmax, int tout,
                               int stages) {
  return (long long)gin_model::smem_layout(dtype == 1, d, hid, vocab, gmax, tout, stages).total;
}

// dtype: 0 = float32, 1 = bfloat16 (h0, tables, weights, biases, pred_w,
// vn_col). meta [num_windows*Σcaps, 4], pool_gl: int32; eps: float32 [L];
// out: float32 [num_windows*gmax, tout]. vn_col may be null. bfloat16 also
// takes `tiles` (the L·C weight chunks) and a ring of `stages` chunk
// buffers, at least gin_mlp::min_stages (float32: null and 0). window must be
// 1..kMaxCluster whole blocks of kRows rows, every cap at most the window.
// Returns a cudaError_t.
int gin_slots_launch(int dtype, const void* meta, const void* h0, const void* pool_gl,
                     const void* tab, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* eps, const void* predw, const void* vn_col,
                     const void* tiles, void* out, int num_windows, int n, int window, int half,
                     int d, int hid, int layers, int vocab, int gmax, int tout, const int* caps,
                     int slots, int stages, int device, void* stream) {
  lanes::Slots walk;
  if (!lanes::make_slots(walk, meta, half, caps, slots, window)) return int(cudaErrorInvalidValue);
  const gin_model::Dims dm{n, window, d, hid, layers, vocab, gmax, tout, stages};
  return gin_model::launch(dtype, walk, h0, pool_gl, tab, w1, b1,
                           w2, b2, eps, predw, vn_col, tiles, out, num_windows, dm, device,
                           stream);
}

const char* gin_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
