// GCN whole-model slot megakernel for Hopper (sm_90a): kernel table row 2.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_model_slots (with its helpers _slot_prefix_geom, _slot_accumulate
// and _pool_epilogue). Same operands, same output: [NW*GMAX, T] float32
// per-window pool sums of the prediction head, for all L GCN layers after
// the conv-0 matmul plus the finalize, in one launch. It computes row 9's
// function (gcn_local_model) over another lane layout.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows, rows sorted by in-degree so that slot k of rows 0..caps[k]-1
// sits in prefix lanes offs[k]..offs[k]+caps[k] of the window's Σc lanes.
// slot_meta holds per lane (src − half, three bond attrs with vocabulary
// offsets), half = W/2 up to W = 512 and 0 above; an empty lane has src =
// W − half and attrs −1 and is skipped. pool_gl holds each row's
// window-local graph id, GMAX for padding rows.
//
// The kernel is gcn_model.cuh's, which row 9 runs too: a window of W = 128
// to 1024 rows on a cluster of W/128 blocks, h and the conv input in shared
// memory for all L layers (the TPU kernel's VMEM residency), the bf16 next
// conv on the tensor cores (linear_wgmma.cuh, weight chunks packed once by
// ops.local_layer.gcn_conv_tiles and streamed through a ring of bulk
// copies), two blocks an SM, the f32 conv register-tiled FMA. This file
// runs it with the slot message stage (lanes.cuh: Slots): one warp per
// destination row reads the row's ≤ S lanes (lane offs[k] + row for each
// slot k with row < caps[k]) from device memory through L1, once per row,
// and its lanes walk D in column pairs; the messages are summed in slot
// order, as the TPU kernel and the plain version sum them, with no division
// per element and no atomics.
//
// What bounds it on this card: the next conv is 2·W·D² operations a window
// and layer against Σc·D gathered values for the messages; h is read once
// and GMAX·T floats are written per window, so the kernel is bound on chip:
// in bf16 by the messages, barriers and set-up beside the tensor-core conv,
// in f32 by the FMA conv.

#include "gcn_model.cuh"

extern "C" {

int gcn_slots_max_d() { return gcn_model::kMaxD; }
int gcn_slots_max_slots() { return lanes::kMaxSlots; }
int gcn_slots_rows_per_block() { return gcn_model::kRows; }
int gcn_slots_max_cluster() { return gcn_model::kMaxCluster; }

// The bf16 form's weight chunks, as gcn_ell_conv_dims gives them.
void gcn_slots_conv_dims(int d, int* dims) { gcn_model::conv_dims(d, dims); }

long long gcn_slots_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

long long gcn_slots_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gcn_slots_launch, stages the bf16 form's weight ring. The slot geometry
// does not enter it: the slot lanes stay in device memory.
long long gcn_slots_smem_bytes(int dtype, int d, int vocab, int gmax, int tout, int stages) {
  return (long long)gcn_model::smem_layout(dtype == 1, d, vocab, gmax, tout, stages).total;
}

// What the occupancy calculator says of a launch, as gcn_ell_occupancy.
int gcn_slots_occupancy(int dtype, int window, int d, int vocab, int gmax, int tout, int stages,
                        int device, int* out) {
  return gcn_model::occupancy<false, lanes::Slots>(dtype, window, d, vocab, gmax, tout, stages,
                                                   device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, dis, tables, roots, alphas, betas,
// wn, bn, pred_w). meta [num_windows*Σcaps, 4], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. bfloat16 also takes `tiles` and a ring
// of `stages` chunk buffers, as gcn_ell_launch does (float32: null and 0).
// window must be 1..kMaxCluster whole blocks of kRows rows, every cap at
// most the window, d even. knockout: 0 (see gcn_model::Dims). Returns a
// cudaError_t.
int gcn_slots_launch(int dtype, const void* meta, const void* h0, const void* dis,
                     const void* pool_gl, const void* tab, const void* roots, const void* alphas,
                     const void* betas, const void* wn, const void* bn, const void* predw,
                     const void* tiles, void* out, int num_windows, int n, int window, int half,
                     int d, int layers, int vocab, int gmax, int tout, const int* caps, int slots,
                     int stages, int knockout, int device, void* stream) {
  lanes::Slots walk;
  if (!lanes::make_slots(walk, meta, half, caps, slots, window)) return int(cudaErrorInvalidValue);
  const gcn_model::Dims dm{n, window, d, layers, vocab, gmax, tout, stages, knockout};
  return gcn_model::launch<false>(dtype, walk, h0, dis, pool_gl, tab, roots, alphas, betas, wn,
                                  bn, predw, tiles, out, nullptr, num_windows, dm, device, stream);
}

const char* gcn_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
