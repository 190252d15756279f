// GCN whole-model ELL kernel for Hopper (sm_90a): kernel table row 9.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_model (with its helpers _ell_meta and _pool_epilogue). Same
// function, same output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GCN layers after the conv-0 matmul plus the
// finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch with
// blocked="local_ell", k = 1): node windows of W rows in packed order, each
// owning `block` lanes of `meta` = (u, v, three bond-table rows) per lane,
// both endpoints window-local, sorted by v within the window (pad lanes,
// u = v = W, last). pool_gl holds each row's window-local graph id, GMAX for
// padding rows. A lane whose u lies outside the window has dis_u = 0 (no
// message) and one whose v does lands nowhere.
//
// The kernel is gcn_model.cuh's, which row 2 runs too: a cluster of W/128
// blocks per window (W up to 1024), h and the conv input in shared memory
// for all L layers, the bf16 next conv on the tensor cores
// (linear_wgmma.cuh) with its weight chunks streamed through a ring of bulk
// copies, two blocks an SM, the f32 conv register-tiled FMA. This file runs
// it with the ELL message stage (lanes.cuh: Ell): each block finds its rows'
// lane runs once, before the layers, by one pass over the window's lanes
// that marks where v changes, and sums each row's lanes in lane order.
//
// What bounds it on this card: per 128 rows and layer the next conv is
// 128*D*D multiply-adds (1.28 M at D=100) against ~1.5 lanes per row of
// D-wide gathers; device-memory traffic is small, so the kernel is bound on
// chip: in bf16 by the messages, barriers and set-up beside the tensor-core
// conv (PERF.md, phase 5g), in f32 by the FMA conv.

#include "gcn_model.cuh"

extern "C" {

int gcn_ell_max_d() { return gcn_model::kMaxD; }
int gcn_ell_rows_per_block() { return gcn_model::kRows; }
int gcn_ell_max_cluster() { return gcn_model::kMaxCluster; }

// The bf16 form's weight chunks at width d: K' (d padded to whole chunks of
// 32), N (the product's width), the bytes of a chunk.
void gcn_ell_conv_dims(int d, int* dims) { gcn_model::conv_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gcn_ell_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gcn_ell_launch, stages the bf16 form's weight ring.
long long gcn_ell_smem_bytes(int dtype, int d, int vocab, int gmax, int tout, int stages) {
  return (long long)gcn_model::smem_layout(dtype == 1, d, vocab, gmax, tout, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int gcn_ell_occupancy(int dtype, int window, int d, int vocab, int gmax, int tout, int stages,
                      int device, int* out) {
  return gcn_model::occupancy<false, lanes::Ell>(dtype, window, d, vocab, gmax, tout, stages,
                                                 device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, dis, tables, roots, alphas, betas,
// wn, bn, pred_w). meta [num_windows*block, 5], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. bfloat16 also takes `tiles`, the (L-1)
// layers' weight chunks as gcn_ell_conv_dims gives them, and a ring of
// `stages` chunk buffers, at least two (float32: null and 0). window must be
// 1..kMaxCluster whole blocks of kRows rows, d even. knockout: 0 (see
// gcn_model::Dims). Returns a cudaError_t.
int gcn_ell_launch(int dtype, const void* meta, const void* h0, const void* dis,
                   const void* pool_gl, const void* tab, const void* roots, const void* alphas,
                   const void* betas, const void* wn, const void* bn, const void* predw,
                   const void* tiles, void* out, int num_windows, int n, int window, int block,
                   int d, int layers, int vocab, int gmax, int tout, int stages, int knockout,
                   int device, void* stream) {
  if (block < 0) return int(cudaErrorInvalidValue);
  const gcn_model::Dims dm{n, window, d, layers, vocab, gmax, tout, stages, knockout};
  return gcn_model::launch<false>(dtype, lanes::Ell{static_cast<const int*>(meta), block}, h0,
                                  dis, pool_gl, tab, roots, alphas, betas, wn, bn, predw, tiles,
                                  out, nullptr, num_windows, dm, device, stream);
}

const char* gcn_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
