// One DGN layer over the slot layout for Hopper (sm_90a): kernel table row 22.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_layer_slots. Same operands, same output: slot_src [NW*W, S] each
// row's in-window sources (sentinel W for an empty slot), h [n, D], the node
// terms eig, invd = 1/max(out_deg, 1), ews = sum of eig_u - eig_v over
// in-edges and inva = 1/sum |eig_u - eig_v| [n], the posttrans w_post [2D, D]
// and b_post [1, D], and optionally m_spill [n, 2D], the spill tail's two
// channels summed per node; out [n, D] in h's type. Per row v over its valid
// slot sources u, in slot order:
//   m1 = sum h_u,  m2 = sum e_u * h_u - e_v * m1     (the TPU kernel's factoring)
//   m1 += m_spill[:D],  m2 += m_spill[D:]            (already weighted)
//   a1 = m1 * invd_v,  a2 = |m2 - ews_v * h_v| * inva_v
//   y  = [rnd(a1) | rnd(a2)] . w_post + b_post        [2D] -> [D]
//   h' = rnd(h + relu(y))
// The node terms come in h's type: the TPU kernel rounds them to it (they
// ride its feature tile). The m2 and a2 chains use __fmul_rn / __fadd_rn /
// __fsub_rn, as row 4 does: m2 - ews * h cancels, and inva reaches
// 1/EIG_EPS = 8192, so a contracted FMA would leave a residual the plain
// version does not have. A row with spill channels and no slot source gets
// its channels all the same.
//
// The kernel is one layer of row 4 (dgn_model.cuh's one-layer form, every
// slot counted): a window of W = 128..1024 rows on a cluster of W/128
// blocks, each holding its 128 rows of h in shared memory, slot sources in
// other blocks' rows read through distributed shared memory; the channels
// one warp per destination row in slot order, m_spill added before a1 and
// a2; the bf16 posttrans on the tensor cores (linear_wgmma.cuh: the
// channels written straight into wgmma's A layout, the layer's weight
// chunks, packed once per weight set for all layers by
// ops.local_layer.dgn_posttrans_tiles, streamed through a ring of bulk
// copies), two blocks an SM; the f32 posttrans register-tiled FMA; bias,
// relu and residual on the accumulators; h' staged over the channels once
// the product has read them and written out as the block's contiguous run
// of rows. Two cluster barriers: after h is in place (before any gather)
// and before a block exits (while another may still read its h).
//
// Against the plain version the f32 form differs in summation order only;
// the bf16 form also in the tensor cores' summation of the posttrans's bf16
// products, so in bf16 it is not bit-equal to the plain version.
//
// What bounds it on this card: arithmetic on chip. Per window of 128 rows
// the posttrans is 128*2D*D multiply-adds (2.6 M at D=100) against 2*S*128*D
// for the channels, while h, the node terms and m_spill are read once and
// h' written once.

#include "dgn_model.cuh"

extern "C" {

int dgn_layer_max_d() { return dgn_model::kMaxD; }
int dgn_layer_max_slots() { return dgn_model::kMaxSlots; }
int dgn_layer_rows_per_block() { return dgn_model::kRows; }
int dgn_layer_max_cluster() { return dgn_model::kMaxCluster; }

// The bf16 form's weight chunks, as dgn_model_posttrans_dims gives them.
void dgn_layer_posttrans_dims(int d, int* dims) { dgn_model::posttrans_dims(d, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_layer_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long dgn_layer_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// dgn_layer_launch, stages the bf16 form's weight ring. Neither the window
// nor the slot geometry enters it.
long long dgn_layer_smem_bytes(int dtype, int d, int stages) {
  return (long long)dgn_model::smem_layout(dtype == 1, false, d, 0, 0, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int dgn_layer_occupancy(int dtype, int window, int d, int stages, int device, int* out) {
  return dgn_model::occupancy<true>(dtype, window, d, 0, 0, stages, device, out);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, invd, ews, inva, w_post, b_post,
// m_spill, out). slot_src [num_windows*window, slots]: int32; m_spill may be
// null; out [n, d]. bfloat16 also takes `tiles`, the layer's posttrans
// chunks as dgn_layer_posttrans_dims gives them, and a ring of `stages`
// chunk buffers, at least two (float32: null and 0). window must be
// 1..kMaxCluster whole blocks of kRows rows. knockout: 0 (see
// dgn_model::Dims). Returns a cudaError_t.
int dgn_layer_launch(int dtype, const void* slot_src, const void* h, const void* eig,
                     const void* invd, const void* ews, const void* inva, const void* w_post,
                     const void* b_post, const void* m_spill, const void* tiles, void* out,
                     int num_windows, int n, int window, int d, int slots, int stages,
                     int knockout, int device, void* stream) {
  if (slots < 1 || slots > dgn_model::kMaxSlots) return int(cudaErrorInvalidValue);
  int caps[dgn_model::kMaxSlots];
  for (int k = 0; k < slots; ++k) caps[k] = window;  // every slot counts for every row
  const dgn_model::Dims dm{n, window, d, 1, 0, 0, slots, stages, knockout};
  return dgn_model::launch<true>(dtype, slot_src, h, eig, invd, ews, inva, w_post, b_post,
                                 nullptr, nullptr, m_spill, tiles, nullptr, out, num_windows, dm,
                                 caps, device, stream);
}

const char* dgn_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
