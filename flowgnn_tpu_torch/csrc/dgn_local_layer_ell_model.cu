// One whole DGN layer over the ELL layout for Hopper (sm_90a): kernel table
// row 18.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_layer_ell (for an ELL batch with no spill tail). Same operands,
// same output: meta [NW*lanes, 5] = (u, v, three bond rows; the bond rows
// unused) per lane, h [n, D], eig [n], the node terms invd = 1/max(out_deg,
// 1), ews = sum over in-edges of eig_u - eig_v and inva = 1/sum |eig_u -
// eig_v| [n], the posttrans w_post [2D, D] and b_post [1, D]; out [n, D] in
// h's type. Per window row v, over its lanes u -> v in lane order:
//   acc = sum [rnd(h_u) | rnd(eig_u * h_u)]              (f32 sums)
//   m1 = acc1,  m2 = acc2 - eig_v * m1      (the TPU kernel's factoring of
//                                            sum (eig_u - eig_v) * h_u)
//   a  = [rnd(m1 * invd_v) | rnd(|m2 - ews_v * h_v| * inva_v)]
//   h' = rnd(h + relu(a . w_post + b_post))                 [2D] -> [D]
// Rounding points are the TPU kernel's: each lane's two channels before the
// f32 sum, and a; eig and the node terms come in h's type (they ride the TPU
// kernel's feature tile). The m2 and a2 chains use __fmul_rn / __fadd_rn /
// __fsub_rn: m2 - ews * h cancels, and inva reaches 1/EIG_EPS = 8192, so a
// contracted FMA would leave a residual the plain version does not have. A
// lane whose u lies outside [0, W), or on a padding row, adds nothing, and
// one whose v does lands nowhere.
//
// The kernel is the one-layer form of the DGN kernel of rows 4 and 22
// (dgn_model.cuh) with the ELL lane walk (EllWalk over lanes.cuh's Ell,
// block = k*B: any k; each lane's e_u * h_u rounded before the sum): a
// window of W = 128..1024 rows on a cluster of W/128 blocks, each holding
// its 128 rows of h in shared memory, a source in another block's rows read
// through distributed shared memory; each row's run found once by one pass
// over the window's lanes; the channels one warp per row, a row's first
// lanes loaded one row ahead; the bf16 posttrans on the tensor cores
// (linear_wgmma.cuh: the channels written straight into wgmma's A layout,
// the layer's weight chunks, packed once per weight set by
// ops.local_layer.dgn_posttrans_tiles, streamed through a ring of bulk
// copies), two blocks an SM; the f32 posttrans register-tiled FMA (TF32
// would break the f32 gate of 1e-4), one block an SM; bias, relu and
// residual on the accumulators, h' staged and written out as the block's
// contiguous run of rows.
//
// What bounds it on this card: arithmetic on chip (per 128 rows the
// posttrans is 128*2D*D multiply-adds, 2.6 M at D=100, against ~1.9 lanes a
// row of D-wide gathers from shared memory); in bf16 the channels' latency
// chains beside the tensor-core product.

#include "dgn_model.cuh"

extern "C" {

int dgn_layer_ell_max_d() { return dgn_model::kMaxD; }
int dgn_layer_ell_rows_per_block() { return dgn_model::kRows; }
int dgn_layer_ell_max_window_blocks() { return dgn_model::kMaxCluster; }

// The bf16 form's weight chunks at width d: K' (2d padded to whole chunks
// of 32), N (the product's width), the bytes of a chunk.
void dgn_layer_ell_posttrans_dims(int d, int* dims) { dgn_model::posttrans_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_layer_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long dgn_layer_ell_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// dgn_layer_ell_launch, stages the bf16 form's weight ring.
long long dgn_layer_ell_smem_bytes(int dtype, int d, int stages) {
  return (long long)dgn_model::smem_bytes<true, dgn_model::EllWalk>(dtype, d, 0, 0, stages);
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int dgn_layer_ell_occupancy(int dtype, int window, int d, int stages, int device, int* out) {
  return dgn_model::occupancy<true, dgn_model::EllWalk>(dtype, window, d, 0, 0, stages, device,
                                                        out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, invd, ews, inva, w_post, b_post,
// out). meta [num_windows*lanes, 5]: int32; out [n, d]. bfloat16 also takes
// `tiles`, the layer's posttrans chunks as dgn_layer_ell_posttrans_dims
// gives them, and a ring of `stages` chunk buffers, at least two (float32:
// null and 0). window must be 1..kMaxCluster whole blocks of kRows rows.
// knockout: 0 (see dgn_model::Dims). Returns a cudaError_t.
int dgn_layer_ell_launch(int dtype, const void* meta, const void* h, const void* eig,
                         const void* invd, const void* ews, const void* inva,
                         const void* w_post, const void* b_post, const void* tiles, void* out,
                         int num_windows, int n, int window, int lanes, int d, int stages,
                         int knockout, int device, void* stream) {
  if (lanes < 0 || !invd || !ews || !inva || !w_post || !b_post)
    return int(cudaErrorInvalidValue);
  const dgn_model::EllWalk walk{::lanes::Ell{static_cast<const int*>(meta), lanes}};
  const dgn_model::Dims dm{n, window, d, 1, 0, 0, dtype == 1 ? stages : 0, knockout};
  return dgn_model::launch<true>(dtype, walk, h, eig, invd, ews, inva, w_post, b_post, nullptr,
                                 nullptr, nullptr, tiles, nullptr, out, num_windows, dm, device,
                                 stream);
}

const char* dgn_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
