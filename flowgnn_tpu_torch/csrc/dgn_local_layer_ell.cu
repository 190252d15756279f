// DGN's two message channels over the ELL layout for Hopper (sm_90a):
// kernel table row 16.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_message_ell (the channels, for the caller to merge a spill
// tail). Operands: meta [NW*lanes, 5] = (u, v, three bond rows; the bond
// rows unused) per lane, h [n, D], eig [n]; out [n, 2D] = [rnd(m1) |
// rnd(m2)] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   acc = sum [h_u | rnd(eig_u * h_u)]                   (f32 sums)
//   m1 = acc1,  m2 = acc2 - eig_v * m1      (the TPU kernel's factoring of
//                                            sum (eig_u - eig_v) * h_u)
// Rounding points are the TPU kernel's: each lane's e_u * h_u before the f32
// sum; eig comes in h's type (it rides the TPU kernel's feature tile). The m2
// chain uses __fmul_rn / __fadd_rn / __fsub_rn, so a contracted FMA leaves no
// residual the plain version does not have. A lane whose u lies outside
// [0, W), or on a padding row, adds nothing, and one whose v does lands
// nowhere. Row 18, the whole layer over the same layout, is
// dgn_local_layer_ell_model.cu.
//
// The kernel is the channels-only form of the DGN kernel of rows 4, 22 and
// 18 (dgn_model.cuh: dgn_channels_kernel), the channel stage of row 18's
// layer with [rnd(m1) | rnd(m2)] written out: a window of W = 128..1024 rows
// on a cluster of W/128 blocks of 512 threads, each staging its 128 rows of h
// and eig in shared memory, a source in another block's rows read through
// distributed shared memory; each row's lane run found by one marking pass
// over the window's k*B lanes (lanes::ell_runs, any k); a half-warp per
// destination row, four column pairs a thread, the row's lanes loaded 16 at
// a time and handed round by shuffles, f32 sums in lane order, no atomics;
// any D from 1 to 128. The shared-memory carve-up is computed on the host
// (chan_smem_layout) and passed in.
//
// What bounds it on this card: bytes. Per lane it reads 20 B of meta and a
// D-wide source row from shared memory; each row of h and eig is read and
// the 2D-wide output written once through device memory; the arithmetic is
// 3 operations per lane and column.

#include "dgn_model.cuh"

extern "C" {

int dgn_msg_ell_max_d() { return dgn_model::kChanMaxD; }
int dgn_msg_ell_rows_per_block() { return dgn_model::kRows; }
int dgn_msg_ell_max_window_blocks() { return dgn_model::kMaxCluster; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_msg_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// dgn_msg_ell_launch.
long long dgn_msg_ell_smem_bytes(int dtype, int d) {
  return (long long)dgn_model::chan_smem_layout(dtype == 1, d).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks that fit
// one SM, out[1] the clusters of W/128 blocks that run at once. Returns a
// cudaError_t.
int dgn_msg_ell_occupancy(int dtype, int window, int d, int device, int* out) {
  return dgn_model::chan_occupancy(dtype, window, d, device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, out). meta [num_windows*lanes,
// 5]: int32; out [n, 2d]. window must be 1..kMaxCluster whole blocks of kRows
// rows, d 1..kChanMaxD. knockout: 0 (bit 1 skips the channels: timing only).
// Returns a cudaError_t.
int dgn_msg_ell_launch(int dtype, const void* meta, const void* h, const void* eig, void* out,
                       int num_windows, int n, int window, int lanes, int d, int knockout,
                       int device, void* stream) {
  const dgn_model::ChanDims dm{n, window, d, knockout};
  return dgn_model::launch_channels(dtype, meta, lanes, h, eig, out, num_windows, dm, device,
                                    stream);
}

const char* dgn_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
