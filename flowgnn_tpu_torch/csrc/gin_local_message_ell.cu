// GIN's message sum over the ELL layout for Hopper (sm_90a): kernel table
// row 31.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_message_ell, which runs row 13's pallas_call
// (local_scatter_apply_ell_attr, and _local_scatter_apply_ell_wps at wps > 1)
// with a pass-through epilogue. Same operands, same output: meta
// [NW*lanes, 5] = (u, v, three bond-table rows) per lane, h [n, D], this
// layer's bond table [vocab, D]; out [n, D] in h's type (the JAX function adds
// a spill operand of zeros, which adds nothing). Per window row v, over its
// lanes u -> v in lane order:
//   out_v = rnd(sum rnd(relu(h_u + ee)))    ee: the lane's three table rows
// with f32 sums; each lane's message is rounded before the sum and the output
// once, as in the TPU kernel. A lane whose u lies outside [0, W), or on a
// padding row, reads a zero source, and one whose v does lands nowhere. The
// JAX GIN runs it on the halo-sharded ELL path, where the boundary rows'
// messages are added after it.
//
// The kernel is the messages-only form of row 13's (gin_layer.cuh, kMessages,
// with the ELL lane walk EllBondWalk): one block of 256 threads per 128 rows
// of a window (W = 128..1024, any k lane blocks a window), the layer's bond
// table staged in shared memory as f32, each row's lane run found by binary
// search on v, a warp a row, f32 sums in lane order, no atomics. Its block
// holds the table and the row runs only (5.7 KB at D = 100), where row 13's
// holds act and the weight ring too. What bounds it: bytes (gin_layer.cuh).

#include "gin_layer.cuh"

namespace {

template <typename T>
using Walk = gin_layer::EllBondWalk<T>;

}  // namespace

extern "C" {

int gin_msg_ell_max_d() { return gin_layer::kMsgMaxD; }
int gin_msg_ell_rows_per_block() { return gin_layer::kRows; }
int gin_msg_ell_max_window_blocks() { return gin_layer::kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_msg_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block needs: the bond table in f32 and
// the row runs (the same in both types).
long long gin_msg_ell_smem_bytes(int dtype, int d, int vocab) {
  (void)dtype;
  return (long long)gin_layer::msg_smem_layout(Walk<float>::ext_bytes(d, vocab)).total;
}

// The blocks of the form of `dtype` with `bytes` of dynamic shared memory
// that fit one SM, in out[0]. Returns a cudaError_t.
int gin_msg_ell_occupancy(int dtype, long long bytes, int* out) {
  return gin_layer::msg_occupancy<Walk>(dtype, bytes, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, tab, out). meta [num_windows*lanes,
// 5]: int32; out [n, d]. window must be 1..kMaxWindowBlocks whole blocks of
// kRows rows, d 1..kMsgMaxD. Returns a cudaError_t.
int gin_msg_ell_launch(int dtype, const void* meta, const void* h, const void* tab, void* out,
                       int num_windows, int n, int window, int lanes, int d, int vocab,
                       int device, void* stream) {
  if (lanes < 0 || vocab < 0) return int(cudaErrorInvalidValue);
  const int* m = static_cast<const int*>(meta);
  const Walk<float> w32{m, static_cast<const float*>(tab), lanes, vocab};
  const Walk<__nv_bfloat16> w16{m, static_cast<const __nv_bfloat16*>(tab), lanes, vocab};
  return gin_layer::launch_messages(dtype, w32, w16, Walk<float>::ext_bytes(d, vocab), h,
                                    nullptr, out, num_windows, n, window, d, device, stream);
}

const char* gin_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
