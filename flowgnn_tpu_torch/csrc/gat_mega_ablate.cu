// GAT megakernel ablation for Hopper (sm_90a): kernel table rows 27-30, the
// forms V1, V3, V4 and V5 of csrc/gat_model.cuh, row 5's kernel (which holds
// the design and each form's operands and rounding points), each with one
// stage knocked out by a runtime flag; and form 0, Row5Ablate, row 5's own
// form with the flags read (row 5's stage stubs, bench/ablate_gat_pairs.py).
//
// Replaces the TPU kernels of flowgnn_tpu/bench/ablate_gat_mega.py:
// _variant_model (v1, :50, pallas_call :198), _variant_model_v3 (:224 /
// :406), _variant_model_v4 (:428 / :536) and _variant_model_v5 (:558 /
// :688), with their helper _pool_epilogue. The variants that compute their
// form's full function (v1 repeat, v3 bf16hu / split / stackexp, v5 split:
// TPU matmul-layout experiments) run the full path (flags 0).

#include "gat_model.cuh"

namespace {

using namespace gat_model;

template <typename Fn>
cudaError_t by_form(int form, Fn&& f) {
  switch (form) {
    case 0: return f(Row5Ablate{});
    case 1: return f(V1{});
    case 3: return f(V3{});
    case 4: return f(V4{});
    case 5: return f(V5{});
    default: return cudaErrorInvalidValue;
  }
}

bool known_form(int form) {
  return form == 0 || form == 1 || form == 3 || form == 4 || form == 5;
}

}  // namespace

extern "C" {

int gma_max_d() { return kMaxHD; }
int gma_max_heads() { return kMaxHeads; }
int gma_max_slots() { return kMaxSlots; }
int gma_rows_per_block() { return kRows; }
int gma_max_cluster() { return kMaxCluster; }
int gma_max_window() { return kRows * kMaxCluster; }

// The blocks an SM form `form`'s bf16 kernel is built for (its
// __launch_bounds__; float32 takes what its shared memory allows), or -1.
int gma_blocks_per_sm(int form) {
  switch (form) {
    case 0: return Row5Ablate::kBlocksWg;
    case 1: return V1::kBlocksWg;
    case 3: return V3::kBlocksWg;
    case 4: return V4::kBlocksWg;
    case 5: return V5::kBlocksWg;
    default: return -1;
  }
}

// Form `form`'s bf16 glue chunks at width hd: K' (hd padded to whole chunks
// of 32), N (the product's width), the bytes of a chunk; v1's layer-0 skip
// product (N = 64) takes the first half of a chunk of this size.
void gma_glue_dims(int form, int hd, int* dims) {
  const lw::Geom g = lw::geom(hd, glue_n(form));
  dims[0] = g.kp;
  dims[1] = glue_n(form);
  dims[2] = g.chunk_bytes;
}

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gma_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gma_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gma_launch, stages the bf16 weight ring, flags the knockouts (v1's
// staticcat / addcat keep layer 0's payload, v4's nogather needs no gather
// buffers).
long long gma_smem_bytes(int form, int dtype, int window, int hd, int heads, int gmax, int tout,
                         int stages, int flags) {
  if (!known_form(form)) return -(long long)cudaErrorInvalidValue;
  return (long long)smem_layout(form, dtype == 1, window, hd, heads, gmax, tout, stages, flags)
      .total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
int gma_occupancy(int form, int dtype, int window, int hd, int heads, int gmax, int tout,
                  int stages, int flags, int device, int* out) {
  if (!known_form(form) || bad_geometry(form, dtype, window, hd, heads, 2, stages))
    return int(cudaErrorInvalidValue);
  const size_t bytes =
      smem_layout(form, dtype == 1, window, hd, heads, gmax, tout, stages, flags).total;
  return int(by_form(form, [&](auto tag) {
    return occupancy<decltype(tag)>(dtype, window, bytes, device, out);
  }));
}

// form: 0 (row 5's), 1, 3, 4 or 5; dtype: 0 = float32, 1 = bfloat16 (h0,
// x0, s0, the weights, pred_hd and v4's one-hot tiles). stack: int32
// sources (row 5, v1, v3, v5) or the one-hot tiles (v4), num_windows * lanes
// rows (v1 S*W lanes a window, else sum(caps)); x0: v1's prev0, else skip0;
// s0 [n, 2*SW] the layer-0 scores [s_src | s_tgt] (row 5: null, it maps
// them); w: v1's skip_w, row 5's skip_w of layers 1..L-1, else the glue
// weight with row stride ldw; proj_w: v1's and row 5's (layers 1..L-1);
// a_next: v1's, row 5's a_all (every layer); null otherwise. bfloat16 also takes
// `tiles`, the glue chunks as gma_glue_dims gives them, and a ring of
// `stages` chunk buffers (float32: null and 0). window: 1..kMaxCluster whole
// blocks of kRows rows; nopool needs gmax <= window and tout <= hd. out:
// float32 [num_windows * gmax, tout]. Returns a cudaError_t.
int gma_launch(int form, int dtype, const void* stack, const void* h0, const void* x0,
               const void* s0, const void* w, const void* proj_w, const void* a_next,
               const void* pool_gl, const void* pred_hd, const void* tiles, void* out,
               int num_windows, int n, int window, int hd, int heads, int layers, int gmax,
               int tout, const int* caps, int slots, int ldw, int stages, int flags, int device,
               void* stream) {
  if (!known_form(form) || num_windows < 1 ||
      bad_geometry(form, dtype, window, hd, heads, layers, stages) ||
      (dtype == 1 && tiles == nullptr) ||
      ((flags & kNoPool) && (gmax > window || tout > hd)))
    return int(cudaErrorInvalidValue);
  int full[kMaxSlots];
  for (int k = 0; k < slots && k < kMaxSlots; ++k) full[k] = window;
  Caps cp;
  int lanes = 0;
  if (!prefix_caps(form == 1 ? full : caps, slots, window, &cp, &lanes))
    return int(cudaErrorInvalidValue);
  const Dims dm{n, window, hd, heads, layers, gmax, tout, slots, lanes, stages, 0, flags, ldw};
  const bool tiles4 = form == 4;
  const Operands<void> op{tiles4 ? nullptr : static_cast<const int*>(stack),
                          tiles4 ? stack : nullptr, h0, x0, s0, w, proj_w, a_next,
                          static_cast<const int*>(pool_gl), pred_hd,
                          static_cast<const unsigned char*>(tiles), static_cast<float*>(out)};
  const Smem lay = smem_layout(form, dtype == 1, window, hd, heads, gmax, tout, stages, flags);
  return int(by_form(form, [&](auto tag) {
    return launch<decltype(tag)>(dtype, op, num_windows, dm, cp, lay, device, stream);
  }));
}

const char* gma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
