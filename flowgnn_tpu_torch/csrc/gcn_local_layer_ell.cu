// One GCN layer over the ELL layout for Hopper (sm_90a): kernel table row 15.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_layer_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond-table rows) per lane, h [n, D] (this layer's conv
// output), dis [n] = 1/sqrt(out_deg + 1), this layer's bond table [vocab, D],
// root, alpha, beta [D] (the root embedding and the folded BatchNorm), and on
// every layer but the last the next conv's w_next [D, D] as [in][out] and
// b_next [D]; out [n, D] in h's type. Per window row v, over its lanes
// u -> v in lane order:
//   acc = sum rnd(dis_u * relu(h_u + ee))      ee: the lane's three table rows
//   a   = acc * dis_v + relu(h_v + root) * dis_v^2
//   x   = alpha * a + beta
//   out = rnd(x) on the last layer, else rnd(rnd(relu(x)) . w_next + b_next)
// The residual takes dis_v^2, as the TPU kernel does, where the plain path
// divides by deg + 1. dis comes in h's type (it rides the TPU kernel's
// gather). A lane whose u lies outside [0, W) has dis_u = 0 and one whose v
// does lands nowhere. The JAX GCN runs it on every layer of an ELL batch with
// no spill tail that its whole-model kernel does not take.
//
// The kernel is the one-layer form of the GCN kernel of rows 9 and 2
// (gcn_model.cuh) with the ELL lane walk (lanes.cuh's Ell, block = k*B: any
// k): a window of W = 128..1024 rows on a cluster of W/128 blocks, each
// holding its 128 rows of h and dis in shared memory, a source in another
// block's rows read through distributed shared memory; each row's run found
// once by one pass over the window's lanes; the messages one warp per row
// and a column pair a lane, summed in lane order, and the tail exactly as
// row 9's layer; the bf16 next conv on the tensor cores (linear_wgmma.cuh:
// rnd(relu(x)) written straight into wgmma's A layout, the layer's weight
// chunks, packed once per weight set by ops.local_layer.gcn_conv_tiles and
// sliced a layer by the model, streamed through a ring of bulk copies); the
// f32 conv register-tiled FMA (TF32 would break the f32 gate of 1e-4) on
// w_next streamed through shared memory in chunks of 8 input channels; both
// forms two blocks an SM at D = 100 (f32 one at D = 112); h' staged and
// written out as the block's contiguous run of rows. The last layer has no conv and no ring: rnd(x)
// leaves from the messages.
//
// What bounds it on this card: per 128 rows the next conv is 128*D*D
// multiply-adds (1.28 M at D=100) against ~1.7 lanes per row of D-wide
// gathers from shared memory; device memory moves the lanes, h, dis and out
// once. At molhiv's shapes both bounds are microseconds; the messages'
// latency chains, the barriers and the set-up beside the conv set the time.

#include "gcn_model.cuh"

extern "C" {

int gcn_layer_ell_max_d() { return gcn_model::kMaxD; }
int gcn_layer_ell_rows_per_block() { return gcn_model::kRows; }
int gcn_layer_ell_max_window_blocks() { return gcn_model::kMaxCluster; }

// The bf16 form's weight chunks at width d: K' (d padded to whole chunks of
// 32), N (the product's width), the bytes of a chunk.
void gcn_layer_ell_conv_dims(int d, int* dims) { gcn_model::conv_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_layer_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gcn_layer_ell_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gcn_layer_ell_launch, stages the bf16 form's weight ring.
long long gcn_layer_ell_smem_bytes(int dtype, int d, int vocab, int stages) {
  return (long long)gcn_model::smem_layout(dtype == 1, d, vocab, 0, 0, stages, false).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int gcn_layer_ell_occupancy(int dtype, int window, int d, int vocab, int stages, int device,
                            int* out) {
  return gcn_model::occupancy<true, lanes::Ell>(dtype, window, d, vocab, 0, 0, stages, device,
                                                out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, dis, table, root, alpha, beta, w_next,
// b_next, out). meta [num_windows*lanes, 5]: int32; out [n, d]. w_next and
// b_next null: the last layer. bfloat16 with a next conv also takes `tiles`,
// its weight chunks as gcn_layer_ell_conv_dims gives them, and a ring of
// `stages` chunk buffers, at least two (float32: null and 0). window must be
// 1..kMaxCluster whole blocks of kRows rows, d even. knockout: 0 (see
// gcn_model::Dims). Returns a cudaError_t.
int gcn_layer_ell_launch(int dtype, const void* meta, const void* h, const void* dis,
                         const void* tab, const void* root, const void* alpha, const void* beta,
                         const void* w_next, const void* b_next, const void* tiles, void* out,
                         int num_windows, int n, int window, int lanes, int d, int vocab,
                         int stages, int knockout, int device, void* stream) {
  if (lanes < 0 || vocab < 0 || (w_next == nullptr) != (b_next == nullptr))
    return int(cudaErrorInvalidValue);
  const gcn_model::Dims dm{n, window, d, 1, vocab, 0, 0, dtype == 1 ? stages : 0, knockout};
  return gcn_model::launch<true>(dtype, lanes::Ell{static_cast<const int*>(meta), lanes}, h, dis,
                                 nullptr, tab, root, alpha, beta, w_next, b_next, nullptr, tiles,
                                 nullptr, out, num_windows, dm, device, stream);
}

const char* gcn_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
