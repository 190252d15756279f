// GIN's message sum over the ELL layout with each lane's bond embedding given,
// for Hopper (sm_90a): row 12's pass-through form.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// local_scatter_apply_ell (row 12's pallas_call) with the pass-through
// epilogue acc + m_spill that the ELL stage bench
// (flowgnn_tpu/bench/spmm_stage.py:measure_spmm_stage) runs it with. Same
// operands, same output: ee [NW*lanes, D] each lane's bond embedding in h's
// type, u_local / v_local the lane's in-window endpoints (sentinel W on pad
// lanes; `stride` ints apart, so they may be columns of the ELL kernels'
// [P, 5] lane array), h [n, D], an optional m_spill [n, D]; out [n, D] in h's
// type. Per window row v over its lanes u -> v in lane order:
//   out_v = rnd(sum rnd(relu(h_u + ee)) + m_spill_v)
// with f32 sums, each lane's message rounded before the sum.
//
// The kernel is the messages-only form of rows 10 / 12's (gin_layer.cuh,
// kMessages, with the block lane walk BlockWalk<T, true> on the static ELL
// grid: window w owns lane block w): one block of 256 threads per 128 rows of
// a window (W = 128..1024), each row's lane run found by binary search on v,
// a warp a row reading ee and h_u as column pairs, f32 sums in lane order.
// Its block holds the row runs only (0.5 KB). What bounds it: bytes
// (gin_layer.cuh).

#include "gin_layer.cuh"

namespace {

template <typename T>
using Walk = gin_layer::BlockWalk<T, true>;

}  // namespace

extern "C" {

int gin_msg_lanes_max_d() { return gin_layer::kMsgMaxD; }
int gin_msg_lanes_rows_per_block() { return gin_layer::kRows; }
int gin_msg_lanes_max_window_blocks() { return gin_layer::kMaxWindowBlocks; }

long long gin_msg_lanes_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block needs: the row runs.
long long gin_msg_lanes_smem_bytes(int dtype, int d) {
  (void)dtype;
  (void)d;
  return (long long)gin_layer::msg_smem_layout(0).total;
}

// The blocks of the form of `dtype` with `bytes` of dynamic shared memory
// that fit one SM, in out[0]. Returns a cudaError_t.
int gin_msg_lanes_occupancy(int dtype, long long bytes, int* out) {
  return gin_layer::msg_occupancy<Walk>(dtype, bytes, out);
}

// dtype: 0 = float32, 1 = bfloat16 (ee, h, m_spill, out). ee
// [num_windows*lanes, d]; u_local, v_local: int32, lane p at [p*stride];
// m_spill may be null; out [n, d]. window must be 1..8 whole blocks of 128
// rows, d 1..kMsgMaxD. Returns a cudaError_t.
int gin_msg_lanes_launch(int dtype, const void* ee, const void* u_local, const void* v_local,
                         const void* h, const void* m_spill, void* out, int num_windows, int n,
                         int window, int lanes, int stride, int d, int device, void* stream) {
  if (lanes < 1 || stride < 1) return int(cudaErrorInvalidValue);
  const int *u = static_cast<const int*>(u_local), *v = static_cast<const int*>(v_local);
  const Walk<float> w32{static_cast<const float*>(ee), u, v, nullptr, num_windows, lanes, stride};
  const Walk<__nv_bfloat16> w16{static_cast<const __nv_bfloat16*>(ee), u, v, nullptr,
                                num_windows, lanes, stride};
  return gin_layer::launch_messages(dtype, w32, w16, 0, h, m_spill, out, num_windows, n, window,
                                    d, device, stream);
}

const char* gin_msg_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
