// The fused edge-block GIN layer for Hopper (sm_90a): windowed scatter and
// MLP in one kernel (kernel table row 25).
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
// The kernel is gin_layer.cuh's (row 13's body), with the block lane walk
// without the gather (BlockWalk<T, false>); in bf16 the MLP on the tensor
// cores (gin_mlp.cuh), its weight chunks packed once per weight set. What
// bounds it and the design: gin_layer.cuh.

#include "gin_layer.cuh"

namespace {

template <typename T>
using Walk = gin_layer::BlockWalk<T, false>;

}  // namespace

extern "C" {

int gin_fused_max_d() { return gin_layer::kMaxD; }
int gin_fused_rows_per_block() { return gin_layer::kRows; }
int gin_fused_max_window_blocks() { return gin_layer::kMaxWindowBlocks; }

// The bf16 form's weight chunks, as gin_ell_mlp_dims gives them.
void gin_fused_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

long long gin_fused_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

long long gin_fused_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block needs; dtype as in
// gin_fused_launch, stages the bf16 form's weight ring.
long long gin_fused_smem_bytes(int dtype, int d, int hid, int stages) {
  return (long long)gin_layer::smem_layout(dtype == 1, d, hid, 0, stages).total;
}

// Opt the kernel's forms in to `bytes` of dynamic shared memory on `device`
// (once per launch plan). Returns a cudaError_t.
int gin_fused_prepare(long long bytes, int device) {
  return gin_layer::prepare<Walk>(bytes, device);
}

// The blocks of the form of `dtype` with `bytes` of dynamic shared memory
// that fit one SM, in out[0]. Returns a cudaError_t.
int gin_fused_occupancy(int dtype, int d, int hid, long long bytes, int* out) {
  return gin_layer::occupancy<Walk>(dtype, d, hid, bytes, out);
}

// dtype: 0 = float32, 1 = bfloat16 (vals, h, w1, b1, w2, b2, out). vals
// [nb*block, d]; v_local [nb*block] and block_window [nb]: int32; eps1:
// float32 [1]; out [n, d]. bfloat16 also takes `tiles`, this layer's weight
// chunks as gin_fused_mlp_dims gives them, and a ring of `stages` chunk
// buffers (float32: null and 0). window must be 1..8 whole blocks of 128
// rows; the host opted the kernel in to the block's shared memory first
// (gin_fused_prepare). knockout: 0 (see gin_layer::Dims). Returns a
// cudaError_t.
int gin_fused_launch(int dtype, const void* vals, const void* v_local, const void* block_window,
                     const void* h, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* eps1, const void* tiles, void* out,
                     int num_windows, int n, int window, int nb, int block, int d, int hid,
                     int final_relu, int stages, int knockout, int device, void* stream) {
  if (block_window == nullptr || nb < 1 || block < 1) return int(cudaErrorInvalidValue);
  const gin_layer::Dims dm{n, window, d, hid, final_relu, stages, knockout};
  const int *v = static_cast<const int*>(v_local), *bw = static_cast<const int*>(block_window);
  const Walk<float> w32{static_cast<const float*>(vals), nullptr, v, bw, nb, block, 1};
  const Walk<__nv_bfloat16> w16{static_cast<const __nv_bfloat16*>(vals), nullptr, v, bw, nb,
                                block, 1};
  return gin_layer::launch(dtype, w32, w16, 0, h, nullptr, w1, b1, w2, b2, eps1, tiles, out,
                           num_windows, dm, device, stream);
}

const char* gin_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
