// GAT whole-model slot megakernel for Hopper (sm_90a): kernel table row 5,
// the Row5 form of csrc/gat_model.cuh (which holds the kernel, what it
// replaces and its design).
//
// Replaces the TPU kernels flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_model_pairs (the default), gat_local_model_slots and
// gat_local_model_dense (with their helper _pool_epilogue). Output:
// [NW*GMAX, T] float32 per-window pool sums of the head-averaged
// prediction, in one launch.

#include "gat_model.cuh"

namespace {

using namespace gat_model;

bool bad_row5(int dtype, int window, int hd, int heads, int layers, int stages) {
  return bad_geometry(0, dtype, window, hd, heads, layers, stages);
}

Smem row5_layout(int dtype, int hd, int heads, int gmax, int tout, int stages) {
  return smem_layout(0, dtype == 1, kRows, hd, heads, gmax, tout, stages, 0);
}

}  // namespace

extern "C" {

int gat_slots_max_d() { return kMaxHD; }
int gat_slots_max_slots() { return kMaxSlots; }
int gat_slots_rows_per_block() { return kRows; }
int gat_slots_max_cluster() { return kMaxCluster; }

// The bf16 form's weight chunks at width hd: K' (hd padded to whole chunks
// of 32), N (the glue's width: proj's outputs at columns c, skip's at 64 +
// c), the bytes of a chunk.
void gat_slots_glue_dims(int hd, int* dims) {
  const lw::Geom g = lw::geom(hd, Row5::kGlueN);
  dims[0] = g.kp;
  dims[1] = Row5::kGlueN;
  dims[2] = g.chunk_bytes;
}

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_slots_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gat_slots_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gat_slots_launch, stages the bf16 form's weight ring. The window and the
// slot geometry do not enter it: a block holds 128 rows, and the slot lanes
// stay in device memory.
long long gat_slots_smem_bytes(int dtype, int hd, int heads, int gmax, int tout, int stages) {
  return (long long)row5_layout(dtype, hd, heads, gmax, tout, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
int gat_slots_occupancy(int dtype, int window, int hd, int heads, int gmax, int tout,
                        int stages, int device, int* out) {
  if (bad_row5(dtype, window, hd, heads, 2, stages)) return int(cudaErrorInvalidValue);
  return int(occupancy<Row5>(dtype, window,
                             row5_layout(dtype, hd, heads, gmax, tout, stages).total, device, out));
}

// dtype: 0 = float32, 1 = bfloat16 (h0, skip0, proj_w, skip_w, a_all,
// pred_hd). slot_pstack [num_windows*sum(caps)], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. bfloat16 also takes `tiles`, the L-1
// layers' glue chunks as gat_slots_glue_dims gives them, and a ring of
// `stages` chunk buffers, at least min_stages (float32: null and 0). window
// must be 1..kMaxCluster whole blocks of kRows rows, every cap at most the
// window. knockout: 0 (see Dims). Returns a cudaError_t.
int gat_slots_launch(int dtype, const void* pstack, const void* h0, const void* skip0,
                     const void* proj_w, const void* skip_w, const void* a_all,
                     const void* pool_gl, const void* pred_hd, const void* tiles, void* out,
                     int num_windows, int n, int window, int hd, int heads, int layers, int gmax,
                     int tout, const int* caps, int slots, int stages, int knockout, int device,
                     void* stream) {
  Caps cp;
  int lanes = 0;
  if (num_windows < 1 || bad_row5(dtype, window, hd, heads, layers, stages) ||
      (dtype == 1 && layers > 1 && tiles == nullptr) ||
      !prefix_caps(caps, slots, window, &cp, &lanes))
    return int(cudaErrorInvalidValue);
  const Dims dm{n, window, hd, heads, layers, gmax, tout, slots, lanes, stages, knockout, 0, hd};
  const Operands<void> op{static_cast<const int*>(pstack), nullptr, h0, skip0, nullptr, skip_w,
                          proj_w, a_all, static_cast<const int*>(pool_gl), pred_hd,
                          static_cast<const unsigned char*>(tiles), static_cast<float*>(out)};
  return int(launch<Row5>(dtype, op, num_windows, dm, cp,
                          row5_layout(dtype, hd, heads, gmax, tout, stages), device, stream));
}

const char* gat_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
