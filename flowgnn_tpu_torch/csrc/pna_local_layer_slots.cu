// One PNA layer over the slot layout for Hopper (sm_90a): kernel table row 20.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_layer. Same operands, same output: slot_src [NW*W, S] each row's
// in-window sources (sentinel W for an empty slot), h [n, D], the node terms
// invd = 1/max(in_deg, 1), t and scale [n], the tower w_cat [4D, 3D] =
// [w_none^T | w_t^T | w_scale^T] and b [1, D]; out [n, D] in h's type. Per row
// v over its valid slot sources u, in slot order:
//   s, q, mn, mx = sum, sum of squares, min and max of h_u, mn seeded at
//                  min_init and mx at max_init (a row with no source keeps them)
//   mean = s * invd_v, std = sqrt(max(q * invd_v - mean^2, 0))
//   y    = [rnd(mean) | rnd(mn) | rnd(mx) | rnd(std)] . w_cat     [4D] -> [3D]
//   acc  = y[:D] + t_v * y[D:2D] + scale_v * y[2D:] + b
//   h'   = rnd(h + relu(acc))
// The node terms come in h's type: the TPU kernel rounds them to it (they
// ride its feature tile). The seeds come in pna_local_stats_ell's order (the
// min's first). The JAX PNA runs it on every layer of a slot batch with no
// spill tail that the whole-model kernel does not take (intermediates asked
// for, or more graphs in a window than its pooling layout holds).
//
// The kernel is one layer of row 3 (pna_model.cuh's one-layer form, every
// slot counted): a window of W = 128..1024 rows on a cluster of W/128
// blocks, each holding its 128 rows of h in shared memory, slot sources in
// other blocks' rows read through distributed shared memory; the stats one
// warp per destination row in slot order; the bf16 tower on the tensor
// cores (linear_wgmma.cuh: the stats written straight into wgmma's A
// layout, the layer's weight chunks, packed once per weight set for all
// layers by ops.local_layer.pna_tower_tiles, streamed through a ring of
// bulk copies), the f32 tower register-tiled FMA over two row blocks of 64;
// the scalers, bias and residual on the accumulators; h' staged in shared
// memory and written out as the block's contiguous run of rows. Two cluster
// barriers: after h is in place (before any gather) and before a block
// exits (while another may still read its h). One block an SM in either
// form (bf16 at D = 80: h and h' 41 KB, the stats 82 KB, the ring).
//
// Against the plain version the f32 form differs in summation order only;
// the bf16 form also in the tensor cores' summation of the tower's bf16
// products, so in bf16 it is not bit-equal to the plain version.
//
// What bounds it on this card: arithmetic on chip. Per window of 128 rows
// the tower is 128*4D*3D multiply-adds (9.8 M at D=80) against S*128*D
// gathered values for the four aggregates, while h and the node terms are
// read once and h' written once.

#include "pna_model.cuh"

extern "C" {

int pna_layer_max_d() { return pna_model::kMaxD; }
int pna_layer_max_slots() { return pna_model::kMaxSlots; }
int pna_layer_rows_per_block() { return pna_model::kRows; }
int pna_layer_max_cluster() { return pna_model::kMaxCluster; }

// The bf16 form's weight chunks, as pna_model_tower_dims gives them.
void pna_layer_tower_dims(int d, int* dims) { pna_model::tower_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_layer_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long pna_layer_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// pna_layer_launch, stages the bf16 form's weight ring. Neither the window
// nor the slot geometry enters it.
long long pna_layer_smem_bytes(int dtype, int d, int stages) {
  return (long long)pna_model::smem_layout(dtype == 1, false, d, 0, 0, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int pna_layer_occupancy(int dtype, int window, int d, int stages, int device, int* out) {
  return pna_model::occupancy<true>(dtype, window, d, 0, 0, stages, device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, invd, t, scale, w_cat, b, out).
// slot_src [num_windows*window, slots]: int32; out [n, d]. min_init /
// max_init seed the running min and max. bfloat16 also takes `tiles`, the
// layer's tower chunks as pna_layer_tower_dims gives them, and a ring of
// `stages` chunk buffers, at least two (float32: null and 0). window must be
// 1..kMaxCluster whole blocks of kRows rows. knockout: 0 (see
// pna_model::Dims). Returns a cudaError_t.
int pna_layer_launch(int dtype, const void* slot_src, const void* h, const void* invd,
                     const void* tdeg, const void* scale, const void* w_cat, const void* b,
                     const void* tiles, void* out, int num_windows, int n, int window, int d,
                     int slots, float min_init, float max_init, int stages, int knockout,
                     int device, void* stream) {
  if (slots < 1 || slots > pna_model::kMaxSlots) return int(cudaErrorInvalidValue);
  int caps[pna_model::kMaxSlots];
  for (int k = 0; k < slots; ++k) caps[k] = window;  // every slot counts for every row
  const pna_model::Dims dm{n, window, d, 1, 0, 0, slots, stages, knockout, min_init, max_init};
  return pna_model::launch<true>(dtype, slot_src, h, invd, tdeg, scale, w_cat, b, nullptr,
                                 nullptr, tiles, nullptr, out, num_windows, dm, caps, device,
                                 stream);
}

const char* pna_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
