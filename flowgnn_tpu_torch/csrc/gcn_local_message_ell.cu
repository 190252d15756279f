// GCN's message sum over the ELL layout for Hopper (sm_90a): kernel table row 14.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_message_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond-table rows) per lane, h [n, D] (this layer's conv
// output), dis [n] = 1/sqrt(out_deg + 1), this layer's bond table [vocab, D];
// out [n, D] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   m[v] = rnd(dis_v * sum rnd(dis_u * relu(h_u + ee)))
// dis comes in h's type (the TPU kernel rounds it: it rides the gather), the
// message is rounded before the f32 sum, and dis_v factors out of the sum as
// in the TPU kernel. A lane whose u lies outside [0, W), or on a padding row,
// gives no message, and one whose v does lands nowhere. The JAX GCN runs it
// on every layer of an ELL batch with a spill tail, whose messages the caller
// adds through the spill scatter.
//
// The kernel is the messages-only form of the GCN kernel of rows 9, 2 and 15
// (gcn_model.cuh: gcn_messages_kernel), the message stage of row 15's layer
// with rnd(acc * dis_v) in place of its tail and conv: a window of W =
// 128..1024 rows on a cluster of W/128 blocks, each staging its 128 rows of h
// and dis and the bond table in shared memory, a source in another block's
// rows read through distributed shared memory; each row's lane run found by
// one marking pass over the window's k*B lanes (lanes::ell_runs, any k); a
// half-warp per destination row, four column pairs a thread, the row's lanes
// loaded 16 at a time and handed round by shuffles, f32 sums in lane order,
// no atomics; any D from 1 to 128. The shared-memory carve-up is computed on
// the host (msg_smem_layout) and passed in.
//
// What bounds it on this card: bytes. Per lane it reads 20 B of meta and a
// D-wide source row from shared memory, and each row of h, dis and out moves
// once through device memory; the arithmetic is 5 operations per lane and
// column. The lanes' dependent loads (meta, then the source row) and the
// cluster barriers set the time at these sizes.

#include "gcn_model.cuh"

extern "C" {

int gcn_msg_ell_max_d() { return gcn_model::kMsgMaxD; }
int gcn_msg_ell_rows_per_block() { return gcn_model::kRows; }
int gcn_msg_ell_max_window_blocks() { return gcn_model::kMaxCluster; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_msg_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gcn_msg_ell_launch.
long long gcn_msg_ell_smem_bytes(int dtype, int d, int vocab) {
  return (long long)gcn_model::msg_smem_layout(dtype == 1, d, vocab).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks that fit
// one SM, out[1] the clusters of W/128 blocks that run at once. Returns a
// cudaError_t.
int gcn_msg_ell_occupancy(int dtype, int window, int d, int vocab, int device, int* out) {
  return gcn_model::msg_occupancy(dtype, window, d, vocab, device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, dis, tab, out). meta
// [num_windows*lanes, 5]: int32; out [n, d]. window must be 1..kMaxCluster
// whole blocks of kRows rows, d 1..kMsgMaxD. knockout: 0 (bit 1 skips the
// messages: timing only). Returns a cudaError_t.
int gcn_msg_ell_launch(int dtype, const void* meta, const void* h, const void* dis,
                       const void* tab, void* out, int num_windows, int n, int window,
                       int lanes, int d, int vocab, int knockout, int device, void* stream) {
  const gcn_model::MsgDims dm{n, window, d, vocab, knockout};
  return gcn_model::launch_messages(dtype, meta, lanes, h, dis, tab, out, num_windows, dm, device,
                                    stream);
}

const char* gcn_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
