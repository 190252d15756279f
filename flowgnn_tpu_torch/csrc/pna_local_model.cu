// PNA whole-model slot megakernel for Hopper (sm_90a): kernel table row 3.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_model (with its helpers _slot_onehot and _pool_epilogue). Same
// operands, same output: [NW*GMAX, T] float32 per-window pool sums of
// h . mlp1_w (readout MLP-1), for all L PNA conv layers plus the finalize,
// in one launch.
//
// The kernel is pna_model.cuh's whole-model form, whose one-layer form row
// 20 runs (pna_local_layer_slots.cu): a window of W = 128..1024 rows on a
// cluster of W/128 blocks, h and the next h in shared memory for all L
// layers (the TPU kernel's VMEM residency), slot sources in other blocks'
// rows read through distributed shared memory, the stats one warp per
// destination row in slot order; the bf16 tower [128, 4D] . [4D, 240] on
// the tensor cores (linear_wgmma.cuh, the weight chunks packed once by
// ops.local_layer.pna_tower_tiles and streamed through a ring of bulk
// copies), the f32 tower register-tiled FMA; then the readout pool, a
// per-block partial per graph reduced across the cluster in rank order.
//
// What bounds it on this card: per 128 rows and layer the tower is
// 128*4D*3D multiply-adds (9.8 M at D=80), the largest dense product of any
// model, against S*128*D gathered values for the four aggregates; h is read
// once and GMAX*T floats written per window, so the kernel is bound on chip.

#include "pna_model.cuh"

extern "C" {

int pna_model_max_d() { return pna_model::kMaxD; }
int pna_model_max_slots() { return pna_model::kMaxSlots; }
int pna_model_rows_per_block() { return pna_model::kRows; }
int pna_model_max_cluster() { return pna_model::kMaxCluster; }

// The bf16 form's weight chunks at width d: K' (4d padded to whole chunks
// of 32), N (the tower's width, three scalers at a pitch of 80), the bytes of
// a chunk.
void pna_model_tower_dims(int d, int* dims) { pna_model::tower_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_model_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// pna_model_launch, stages the bf16 form's weight ring. The window and the
// slot geometry do not enter it: a block holds 128 rows, and the slot lanes
// stay in device memory.
long long pna_model_smem_bytes(int dtype, int d, int gmax, int tout, int stages) {
  return (long long)pna_model::smem_layout(dtype == 1, true, d, gmax, tout, stages).total;
}

// dtype: 0 = float32, 1 = bfloat16 (h0, invd, t, scale, w_all, b_all,
// mlp1_w). slot_src [num_windows*window, slots], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. min_init / max_init seed the running min
// and max. bfloat16 also takes `tiles`, the L layers' tower chunks as
// pna_model_tower_dims gives them, and a ring of `stages` chunk buffers, at
// least two (float32: null and 0). window must be 1..kMaxCluster whole
// blocks of kRows rows, every cap at most the window. knockout: 0 (see
// pna_model::Dims). Returns a cudaError_t.
int pna_model_launch(int dtype, const void* slot_src, const void* h0, const void* invd,
                     const void* tdeg, const void* scale, const void* w_all, const void* b_all,
                     const void* pool_gl, const void* mlp1_w, const void* tiles, void* out,
                     int num_windows, int n, int window, int d, int layers, int gmax, int tout,
                     float min_init, float max_init, const int* caps, int slots, int stages,
                     int knockout, int device, void* stream) {
  const pna_model::Dims dm{n,     window, d,        layers,   gmax,    tout,
                           slots, stages, knockout, min_init, max_init};
  return pna_model::launch<false>(dtype, slot_src, h0, invd, tdeg, scale, w_all, b_all, pool_gl,
                                  mlp1_w, tiles, out, nullptr, num_windows, dm, caps, device,
                                  stream);
}

const char* pna_model_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
