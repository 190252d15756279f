// One GIN / GIN-VN layer with per-lane bond embeddings for Hopper (sm_90a):
// the legacy dynamic-window local layout and the ELL layout, one kernel.
//
// Replaces two TPU kernels of flowgnn_tpu/ops/pallas/local_layer.py, which
// compute the same function: local_scatter_apply behind gin_local_layer
// (a window owns as many 128-lane blocks as its edges need; block_window
// names each block's window) and local_scatter_apply_ell behind
// gin_local_layer_ell without edge_attr (every window owns the same k*B
// lanes: the case block_window = null here, window w owning lane block w).
// Same operands, same output: ee [P, D] each lane's bond embedding in h's
// type, u_local / v_local [P] the lane's in-window endpoints (sentinel W on
// pad lanes; `stride` ints apart, so they may be columns of the ELL
// kernels' [P, 5] lane array), h and m_spill [n, D], w1 [H, D], b1 [H], w2
// [D, H], b2 [D], eps1 = 1 + eps (float32); out [n, D] in h's type. Per
// window row v over its lanes u -> v in lane order:
//   acc = sum rnd(relu(h_u + ee));  act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z = rnd(relu(act . w1^T + b1)); out = rnd(z . w2^T + b2) (-> relu)
// Against csrc/gin_local_layer_ell.cu, which sums each lane's three bond
// table rows in f32 inside the kernel, ee arrives rounded to h's type: in
// f32 the two agree to summation order, in bf16 they need not be bit-equal.
//
// The design, what bounds it and the kernel itself: csrc/gin_layer_blocks.cuh.

#include "gin_layer_blocks.cuh"

extern "C" {

int gin_layer_blocks_max_d() { return gin_blocks::kMaxD; }
int gin_layer_blocks_rows_per_block() { return gin_blocks::kRows; }
int gin_layer_blocks_max_window_blocks() { return gin_blocks::kMaxWindowBlocks; }

long long gin_layer_blocks_smem_optin(int device) { return gin_blocks::smem_optin(device); }

// Dynamic shared memory (bytes) one block needs.
long long gin_layer_blocks_smem_bytes(int d) {
  return (long long)(gin_blocks::smem_layout(d).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (ee, h, m_spill, w1, b1, w2, b2, out).
// ee [nb*block, d]; u_local, v_local: int32, lane p at [p*stride];
// block_window [nb] int32, or null for the static grid (nb = num_windows,
// block = the lanes per window); eps1: float32 [1]; m_spill may be null; out
// [n, d]. window must be 1..8 whole blocks of 128 rows. Returns a cudaError_t.
int gin_layer_blocks_launch(int dtype, const void* ee, const void* u_local, const void* v_local,
                            const void* block_window, const void* h, const void* m_spill,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* eps1, void* out, int num_windows, int n, int window,
                            int nb, int block, int stride, int d, int hid, int final_relu,
                            int device, void* stream) {
  const gin_blocks::Dims dm{n, window, nb, block, stride, d, hid, final_relu};
  return gin_blocks::launch<true>(dtype, ee, u_local, v_local, block_window, h, m_spill, w1, b1,
                                  w2, b2, eps1, out, num_windows, dm, device, stream);
}

const char* gin_layer_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
