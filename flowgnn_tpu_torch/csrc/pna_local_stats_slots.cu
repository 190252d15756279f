// PNA per-layer slot aggregates for Hopper (sm_90a): kernel table row 19.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_stats_ell (which, despite its name, runs over the slot layout).
// Same operands, same output: slot_src [NW*W, S] each row's in-window sources
// (sentinel W for an empty slot), h [n, D]; out [n, 4D] in h's type, per row
// [sum h_u | sum h_u^2 | min h_u | max h_u] over its valid slots in slot
// order, the min seeded at min_init and the max at max_init. The PNA model
// passes (MAX_INIT, MIN_INIT): the min's seed is the upper ap_fixed extreme.
// An empty slot adds nothing to the sums and leaves min and max alone, so a
// row with no local source keeps the seeds; a source on a padding row reads
// zeros. The spill tail's terms are merged by the caller after this output
// is rounded to h's type, as in the JAX package.
//
// The TPU kernel gathers each slot's sources with a [W, W] one-hot matmul on
// the MXU. Here the kernel is the stats-only form of the PNA kernel of rows 3
// and 20 (pna_model.cuh: pna_stats_kernel), the stats stage of row 20's layer
// with the raw stats written out: a window of W = 128..1024 rows on a cluster
// of W/128 blocks of 512 threads, each staging its 128 rows of h (in h's
// type) and of the slot table in shared memory, a source in another block's
// rows read through distributed shared memory; a half-warp per destination
// row, four column pairs a thread, a row's slots loaded at once and packed by
// one ballot; any D from 1 to 128 and S from 1 to 8. Sums use __fadd_rn /
// __fmul_rn, as the plain version rounds each product and sum. The
// shared-memory carve-up is computed on the host (stats_smem_layout) and
// passed in.
//
// What bounds it on this card: the bytes, most of them the writes. h is read
// once, the slot table once, and 4D values written per row; the arithmetic
// (five operations per valid slot and column) is small against it.

#include "pna_model.cuh"

extern "C" {

int pna_stats_max_d() { return pna_model::kStatsMaxD; }
int pna_stats_max_slots() { return pna_model::kMaxSlots; }
int pna_stats_rows_per_block() { return pna_model::kRows; }
int pna_stats_max_cluster() { return pna_model::kMaxCluster; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_stats_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// pna_stats_launch.
long long pna_stats_smem_bytes(int dtype, int d, int slots) {
  return (long long)pna_model::stats_smem_layout(dtype == 1, d, slots).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks that fit
// one SM, out[1] the clusters of W/128 blocks that run at once. Returns a
// cudaError_t.
int pna_stats_occupancy(int dtype, int window, int d, int slots, int device, int* out) {
  return pna_model::stats_occupancy(dtype, window, d, slots, device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, out). slot_src [num_windows*window,
// slots]: int32; out [n, 4d]. window must be 1..kMaxCluster whole blocks of
// kRows rows, d 1..kStatsMaxD, slots 1..kMaxSlots. knockout: 0 (bit 1 skips
// the stats: timing only). Returns a cudaError_t.
int pna_stats_launch(int dtype, const void* slot_src, const void* h, void* out, int num_windows,
                     int n, int window, int d, int slots, float min_init, float max_init,
                     int knockout, int device, void* stream) {
  const pna_model::StatsDims dm{n, window, d, slots, knockout, min_init, max_init};
  return pna_model::launch_stats(dtype, slot_src, h, out, num_windows, dm, device, stream);
}

const char* pna_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
