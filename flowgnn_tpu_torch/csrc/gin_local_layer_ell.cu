// One GIN / GIN-VN layer over the ELL layout for Hopper (sm_90a): kernel
// table row 13.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// local_scatter_apply_ell_attr with the gin_local_layer_ell epilogue, and
// _local_scatter_apply_ell_wps, the same function with wps windows per grid
// step. Same operands, same output: meta [NW*lanes, 5] = (u, v, three
// bond-table rows) per lane, h and m_spill [n, D], this layer's bond table
// [vocab, D], w1 [H, D], b1 [H], w2 [D, H], b2 [D], eps1 = 1 + eps (float32);
// out [n, D] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   acc = sum rnd(relu(h_u + ee))            ee: the lane's three table rows
//   act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z   = rnd(relu(act . w1^T + b1))         [D] -> [H]
//   out = rnd(z . w2^T + b2), with a ReLU when final_relu (every layer but the last)
//
// Layout (flowgnn_tpu_torch/models/base.py:as_batch, blocked="local_ell"):
// node windows of W rows, each owning `lanes` = k*B lanes, both endpoints
// window-local. The k blocks of a window are one run stably sorted by v, pad
// lanes (u = v = W) last, so each destination row's lanes are one contiguous
// run at any k.
//
// The kernel is gin_layer.cuh's, shared with rows 10, 12 and 25, with the
// ELL lane walk (EllBondWalk): the layer's bond table is staged in shared
// memory as f32 and each lane's three rows summed there. What bounds it on
// this card (the MLP is 2.6 GFLOP a launch on a 257-window hep10k bucket:
// 0.04 ms at 67 TFLOP/s in f32, 2.6 µs at 989 in bf16) and the design:
// gin_layer.cuh.

#include "gin_layer.cuh"

namespace {

template <typename T>
using Walk = gin_layer::EllBondWalk<T>;

}  // namespace

extern "C" {

int gin_layer_ell_max_d() { return gin_layer::kMaxD; }
int gin_layer_ell_rows_per_block() { return gin_layer::kRows; }
int gin_layer_ell_max_window_blocks() { return gin_layer::kMaxWindowBlocks; }

// The bf16 form's weight chunks, as gin_ell_mlp_dims gives them.
void gin_layer_ell_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_layer_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gin_layer_ell_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block needs; dtype as in
// gin_layer_ell_launch, stages the bf16 form's weight ring.
long long gin_layer_ell_smem_bytes(int dtype, int d, int hid, int vocab, int stages) {
  return (long long)gin_layer::smem_layout(dtype == 1, d, hid, Walk<float>::ext_bytes(d, vocab),
                                           stages).total;
}

// Opt the kernel's forms in to `bytes` of dynamic shared memory on `device`
// (once per launch plan). Returns a cudaError_t.
int gin_layer_ell_prepare(long long bytes, int device) {
  return gin_layer::prepare<Walk>(bytes, device);
}

// The blocks of the form of `dtype` with `bytes` of dynamic shared memory
// that fit one SM, in out[0]. Returns a cudaError_t.
int gin_layer_ell_occupancy(int dtype, int d, int hid, long long bytes, int* out) {
  return gin_layer::occupancy<Walk>(dtype, d, hid, bytes, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, m_spill, tab, w1, b1, w2, b2, out).
// meta [num_windows*lanes, 5]: int32; eps1: float32 [1]; m_spill may be null
// (no spill messages); out [n, d]. bfloat16 also takes `tiles`, this layer's
// C weight chunks packed as gin_layer_ell_mlp_dims gives them, and a ring of
// `stages` chunk buffers, at least gin_mlp::min_stages (float32: null and 0).
// window must be 1..kMaxWindowBlocks whole blocks of kRows rows; the host
// opted the kernel in to the block's shared memory first
// (gin_layer_ell_prepare). knockout: 0 (see gin_layer::Dims). Returns a
// cudaError_t.
int gin_layer_ell_launch(int dtype, const void* meta, const void* h, const void* m_spill,
                         const void* tab, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* eps1, const void* tiles, void* out,
                         int num_windows, int n, int window, int lanes, int d, int hid,
                         int vocab, int final_relu, int stages, int knockout, int device,
                         void* stream) {
  if (lanes < 0 || vocab < 0) return int(cudaErrorInvalidValue);
  const gin_layer::Dims dm{n, window, d, hid, final_relu, stages, knockout};
  const int* m = static_cast<const int*>(meta);
  const Walk<float> w32{m, static_cast<const float*>(tab), lanes, vocab};
  const Walk<__nv_bfloat16> w16{m, static_cast<const __nv_bfloat16*>(tab), lanes, vocab};
  return gin_layer::launch(dtype, w32, w16, Walk<float>::ext_bytes(d, vocab), h, m_spill, w1, b1,
                           w2, b2, eps1, tiles, out, num_windows, dm, device, stream);
}

const char* gin_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
