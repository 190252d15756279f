// GIN / GIN-VN whole-model ELL kernel for Hopper (sm_90a): kernel table row 8.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_model (with its helpers _ell_meta and _pool_epilogue). Same
// function, same output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GIN layers plus the finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch with
// blocked="local_ell", k = 1): node windows of W rows in packed order, each
// owning `block` lanes of `meta` = (u, v, three bond-table rows) per lane,
// both endpoints window-local. Within a window the lanes are sorted by v (a
// stable sort by receiver), so each destination row's lanes are one
// contiguous run; pad lanes carry u = v = W and come last. pool_gl holds
// each row's window-local graph id, GMAX for padding rows. A lane whose u
// lies outside the window reads a zero source and one whose v does lands
// nowhere, as the TPU kernel's one-hot gather and scatter give.
//
// The kernel is gin_model.cuh's, a cluster of W/128 blocks per window with
// its bf16 update MLP on the tensor cores (gin_mlp.cuh); this file runs it
// with the ELL message stage (lanes.cuh: Ell): each block finds its rows'
// lane runs once, before the layers, by one pass over the window's lanes
// that marks where v changes, and a row's lanes are read from device
// memory through L1 in lane order.
//
// What bounds it on this card: the MLP is 4·n·D·H operations a layer
// against ~1.5 lanes per row of D-wide gathers from shared memory; h is
// read once and GMAX·T floats are written per window, so device-memory
// traffic is small and the kernel is bound on chip: in bf16 by the
// messages, the VN stage and the cluster barriers beside the tensor-core MLP
// (28-65x its bound on an H100 80GB HBM3 at 700 W, PERF.md), in f32 by the
// FMA MLP on the CUDA cores.

#include "gin_model.cuh"
#include "lanes.cuh"

static_assert(gin_model::kRows == lanes::kRows && gin_model::kThreads == lanes::kThreads,
              "the lane walk's block shape");

extern "C" {

int gin_ell_max_d() { return gin_model::kMaxD; }
int gin_ell_rows_per_block() { return gin_model::kRows; }
int gin_ell_max_cluster() { return gin_model::kMaxCluster; }

// The bf16 form's weight chunks for width d and hidden width hid
// (gin_mlp.cuh): dims[0] = D', dims[1] = H', dims[2] = N2, dims[3] = the
// bytes of one chunk.
void gin_ell_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

long long gin_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gin_ell_launch, stages the bf16 form's weight ring.
long long gin_ell_smem_bytes(int dtype, int d, int hid, int vocab, int gmax, int tout,
                             int stages) {
  return (long long)gin_model::smem_layout(dtype == 1, d, hid, vocab, gmax, tout, stages).total;
}

// dtype: 0 = float32, 1 = bfloat16 (h0, tables, weights, biases, pred_w,
// vn_col). meta [num_windows*block, 5], pool_gl: int32; eps: float32 [L];
// out: float32 [num_windows*gmax, tout]. vn_col may be null. bfloat16 also
// takes `tiles`, the L·C weight chunks packed as gin_ell_mlp_dims gives
// them, and a ring of `stages` chunk buffers, at least gin_mlp::min_stages
// (float32: null and 0). window must be 1..kMaxCluster whole blocks of kRows
// rows. knockout: 0, or the timing knockouts of gin_model.cuh's Dims. Returns
// a cudaError_t.
int gin_ell_launch(int dtype, const void* meta, const void* h0, const void* pool_gl,
                   const void* tab, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* eps, const void* predw, const void* vn_col,
                   const void* tiles, void* out, int num_windows, int n, int window, int block,
                   int d, int hid, int layers, int vocab, int gmax, int tout, int stages,
                   int knockout, int device, void* stream) {
  if (block < 0) return int(cudaErrorInvalidValue);
  const gin_model::Dims dm{n, window, d, hid, layers, vocab, gmax, tout, stages, knockout};
  return gin_model::launch(dtype, lanes::Ell{static_cast<const int*>(meta), block}, h0, pool_gl,
                           tab, w1, b1, w2, b2, eps, predw, vn_col, tiles, out, num_windows, dm,
                           device, stream);
}

const char* gin_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
