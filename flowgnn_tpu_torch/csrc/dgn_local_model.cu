// DGN whole-model slot megakernel for Hopper (sm_90a): kernel table row 4.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_model (with its helpers _slot_onehot and _pool_epilogue). Same
// operands, same output: [NW*GMAX, T] float32 per-window pool sums of
// h . mlp1_w (readout MLP-1), for all L DGN conv layers plus the finalize,
// in one launch.
//
// The kernel is dgn_model.cuh's whole-model form, whose one-layer form row
// 22 runs (dgn_local_layer_slots.cu): a window of W = 128..1024 rows on a
// cluster of W/128 blocks, h in shared memory for all L layers (the TPU
// kernel's VMEM residency) and updated in place, slot sources in other
// blocks' rows read through distributed shared memory, the channels one
// warp per destination row in slot order; the bf16 posttrans on the tensor
// cores (linear_wgmma.cuh, the weight chunks packed once by
// ops.local_layer.dgn_posttrans_tiles and streamed through a ring of bulk
// copies), two blocks an SM, the f32 posttrans register-tiled FMA; then the
// readout pool, a per-block partial per graph reduced across the cluster in
// rank order.
//
// What bounds it on this card: per 128 rows and layer the posttrans is
// 128*2D*D multiply-adds (2.6 M at D=100) against 2*S*128*D for the two
// channels; h is read once and GMAX*T floats written per window, so the
// kernel is bound on chip.

#include "dgn_model.cuh"

extern "C" {

int dgn_model_max_d() { return dgn_model::kMaxD; }
int dgn_model_max_slots() { return dgn_model::kMaxSlots; }
int dgn_model_rows_per_block() { return dgn_model::kRows; }
int dgn_model_max_cluster() { return dgn_model::kMaxCluster; }

// The bf16 form's weight chunks at width d: K' (2d padded to whole chunks
// of 32), N (the product's width), the bytes of a chunk.
void dgn_model_posttrans_dims(int d, int* dims) { dgn_model::posttrans_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_model_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long dgn_model_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// dgn_model_launch, stages the bf16 form's weight ring. The window and the
// slot geometry do not enter it: a block holds 128 rows, and the slot lanes
// stay in device memory.
long long dgn_model_smem_bytes(int dtype, int d, int gmax, int tout, int stages) {
  return (long long)dgn_model::smem_bytes<false, dgn_model::SlotWalk>(dtype, d, gmax, tout, stages);
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
int dgn_model_occupancy(int dtype, int window, int d, int gmax, int tout, int stages, int device,
                        int* out) {
  return dgn_model::occupancy<false, dgn_model::SlotWalk>(dtype, window, d, gmax, tout, stages,
                                                          device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, eig, invd, ews, inva, w_all, b_all,
// mlp1_w). slot_src [num_windows*window, slots], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. bfloat16 also takes `tiles`, the L
// layers' posttrans chunks as dgn_model_posttrans_dims gives them, and a
// ring of `stages` chunk buffers, at least two (float32: null and 0).
// window must be 1..kMaxCluster whole blocks of kRows rows, every cap at
// most the window. knockout: 0 (see dgn_model::Dims). Returns a cudaError_t.
int dgn_model_launch(int dtype, const void* slot_src, const void* h0, const void* eig,
                     const void* invd, const void* ews, const void* inva, const void* w_all,
                     const void* b_all, const void* pool_gl, const void* mlp1_w,
                     const void* tiles, void* out, int num_windows, int n, int window, int d,
                     int layers, int gmax, int tout, const int* caps, int slots, int stages,
                     int knockout, int device, void* stream) {
  dgn_model::SlotWalk walk;
  if (!dgn_model::make_slot_walk(walk, slot_src, caps, slots, window))
    return int(cudaErrorInvalidValue);
  const dgn_model::Dims dm{n, window, d, layers, gmax, tout, stages, knockout};
  return dgn_model::launch<false>(dtype, walk, h0, eig, invd, ews, inva, w_all, b_all, pool_gl,
                                  mlp1_w, nullptr, tiles, out, nullptr, num_windows, dm, device,
                                  stream);
}

const char* dgn_model_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
