// The fused edge-block GIN layer for Hopper (sm_90a): windowed scatter and
// MLP in one kernel.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/fused_layer.py:
// windowed_scatter_apply with the gin_layer_fused epilogue. Same operands,
// same output: vals [P, D] each lane's message relu(h_u + ee), already formed
// and rounded to h's type, in the edge-block order of
// flowgnn_tpu_torch/core/blocking.py:build_edge_blocks (blocks of 128 lanes,
// each window's edges sorted by receiver and padded to whole blocks, the
// blocks left over parked on the last window), v_local [P] the lane's
// receiver row in its window (sentinel W on pad lanes), block_window [NB] each
// block's window, h [n, D], w1 [H, D], b1 [H], w2 [D, H], b2 [D], eps1 = 1 +
// eps (float32); out [n, D] in h's type. Per window row v over its lanes in
// lane order:
//   acc = sum vals;  act = rnd(acc + (1+eps) h_v)
//   z = rnd(relu(act . w1^T + b1));  out = rnd(z . w2^T + b2) (-> relu)
// No gather and no spill operand: the [n, D] message sums never reach device
// memory.
//
// The design, what bounds it and the kernel itself: csrc/gin_layer_blocks.cuh
// (the same row walk as csrc/gin_local_layer_blocks.cu, without the gather).

#include "gin_layer_blocks.cuh"

extern "C" {

int gin_fused_max_d() { return gin_blocks::kMaxD; }
int gin_fused_rows_per_block() { return gin_blocks::kRows; }
int gin_fused_max_window_blocks() { return gin_blocks::kMaxWindowBlocks; }

long long gin_fused_smem_optin(int device) { return gin_blocks::smem_optin(device); }

// Dynamic shared memory (bytes) one block needs.
long long gin_fused_smem_bytes(int d) {
  return (long long)(gin_blocks::smem_layout(d).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (vals, h, w1, b1, w2, b2, out). vals
// [nb*block, d]; v_local [nb*block] and block_window [nb]: int32; eps1:
// float32 [1]; out [n, d]. window must be 1..8 whole blocks of 128 rows.
// Returns a cudaError_t.
int gin_fused_launch(int dtype, const void* vals, const void* v_local, const void* block_window,
                     const void* h, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* eps1, void* out, int num_windows, int n,
                     int window, int nb, int block, int d, int hid, int final_relu, int device,
                     void* stream) {
  if (block_window == nullptr) return int(cudaErrorInvalidValue);
  const gin_blocks::Dims dm{n, window, nb, block, 1, d, hid, final_relu};
  return gin_blocks::launch<false>(dtype, vals, nullptr, v_local, block_window, h, nullptr, w1,
                                   b1, w2, b2, eps1, out, num_windows, dm, device, stream);
}

const char* gin_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
