// One GIN / GIN-VN layer with per-lane bond embeddings for Hopper (sm_90a):
// the legacy dynamic-window local layout and the ELL layout, one kernel
// (kernel table rows 10 and 12).
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
// The kernel is gin_layer.cuh's (row 13's body), with the block lane walk
// (BlockWalk, gathering): the run of a window's lane blocks by binary search
// on block_window, then each row's lanes by binary search on v, ee and h_u
// read as column pairs; in bf16 the MLP on the tensor cores (gin_mlp.cuh),
// its weight chunks packed once per weight set. What bounds it and the
// design: gin_layer.cuh.

#include "gin_layer.cuh"

namespace {

template <typename T>
using Walk = gin_layer::BlockWalk<T, true>;

}  // namespace

extern "C" {

int gin_layer_blocks_max_d() { return gin_layer::kMaxD; }
int gin_layer_blocks_rows_per_block() { return gin_layer::kRows; }
int gin_layer_blocks_max_window_blocks() { return gin_layer::kMaxWindowBlocks; }

// The bf16 form's weight chunks, as gin_ell_mlp_dims gives them.
void gin_layer_blocks_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

long long gin_layer_blocks_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

long long gin_layer_blocks_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block needs; dtype as in
// gin_layer_blocks_launch, stages the bf16 form's weight ring.
long long gin_layer_blocks_smem_bytes(int dtype, int d, int hid, int stages) {
  return (long long)gin_layer::smem_layout(dtype == 1, d, hid, 0, stages).total;
}

// Opt the kernel's forms in to `bytes` of dynamic shared memory on `device`
// (once per launch plan). Returns a cudaError_t.
int gin_layer_blocks_prepare(long long bytes, int device) {
  return gin_layer::prepare<Walk>(bytes, device);
}

// The blocks of the form of `dtype` with `bytes` of dynamic shared memory
// that fit one SM, in out[0]. Returns a cudaError_t.
int gin_layer_blocks_occupancy(int dtype, int d, int hid, long long bytes, int* out) {
  return gin_layer::occupancy<Walk>(dtype, d, hid, bytes, out);
}

// dtype: 0 = float32, 1 = bfloat16 (ee, h, m_spill, w1, b1, w2, b2, out).
// ee [nb*block, d]; u_local, v_local: int32, lane p at [p*stride];
// block_window [nb] int32, or null for the static grid (nb = num_windows,
// block = the lanes per window); eps1: float32 [1]; m_spill may be null; out
// [n, d]. bfloat16 also takes `tiles`, this layer's weight chunks as
// gin_layer_blocks_mlp_dims gives them, and a ring of `stages` chunk buffers
// (float32: null and 0). window must be 1..8 whole blocks of 128 rows; the
// host opted the kernel in to the block's shared memory first
// (gin_layer_blocks_prepare). knockout: 0 (see gin_layer::Dims). Returns a
// cudaError_t.
int gin_layer_blocks_launch(int dtype, const void* ee, const void* u_local, const void* v_local,
                            const void* block_window, const void* h, const void* m_spill,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* eps1, const void* tiles, void* out, int num_windows,
                            int n, int window, int nb, int block, int stride, int d, int hid,
                            int final_relu, int stages, int knockout, int device,
                            void* stream) {
  if (nb < 1 || block < 1 || stride < 1) return int(cudaErrorInvalidValue);
  const gin_layer::Dims dm{n, window, d, hid, final_relu, stages, knockout};
  const int *u = static_cast<const int*>(u_local), *v = static_cast<const int*>(v_local),
            *bw = static_cast<const int*>(block_window);
  const Walk<float> w32{static_cast<const float*>(ee), u, v, bw, nb, block, stride};
  const Walk<__nv_bfloat16> w16{static_cast<const __nv_bfloat16*>(ee), u, v, bw, nb, block,
                                stride};
  return gin_layer::launch(dtype, w32, w16, 0, h, m_spill, w1, b1, w2, b2, eps1, tiles, out,
                           num_windows, dm, device, stream);
}

const char* gin_layer_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
