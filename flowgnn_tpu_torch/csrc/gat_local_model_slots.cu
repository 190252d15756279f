// GAT whole-model slot megakernel for Hopper (sm_90a): kernel table row 5.
//
// Replaces the TPU kernels flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_model_pairs (the default), gat_local_model_slots and
// gat_local_model_dense (with their helper _pool_epilogue). The three compute
// the same function, the whole GAT model per node window; they differ in how
// they fill the TPU's 128-lane tiles (two windows per tile, a fused glue
// matmul, a dense [W, W] mask) and, in bf16 only, in where the scores round.
// This kernel follows the numerics of the default, gat_local_model_pairs.
// Output: [NW*GMAX, T] float32 per-window pool sums of the head-averaged
// prediction, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; slot_pstack [NW*sum(c)] holds, for slot k
// and row r < caps[k], the source of row r's k-th in-edge at lane
// offs[k] + r, sentinel W for an empty lane. GAT's self edges come first, so
// slot 0 is full. pool_gl holds each row's window-local graph id, GMAX for
// padding rows.
//
// Per layer, for window row v, its valid lanes u -> v and each head k:
//   [s_src | s_tgt] = h . a_l           (from the rounded h, kept float32)
//   score = exp(leaky(s_src[v,k] + s_tgt[u,k], 0.2))  (no max subtraction)
//   msg   = rnd(sum score * h_u / sum score)            (zero sum -> 1)
// then, between layers,
//   feat = rnd(ELU(msg + skip)),  h = rnd(feat . proj_{l+1}),
//   skip = feat . skip_{l+1}      (float32, not rounded)
// and on the last layer the head pools rnd(msg + skip) . pred_hd, the head
// average composed with the prediction head (_pool_epilogue). The exp is
// expf, the reference's raw exp: a valid edge whose score overflows gives
// inf / inf as the reference does. An empty lane is skipped, not multiplied
// by a zero mask, so a non-edge's score never enters a sum.
//
// What bounds it on this card: per 128 rows and layer the messages are
// Σc lanes x H*D multiply-adds plus Σc x H exps, the glue 128 x H*D x 2*H*D
// multiply-adds (1 M at H*D = 64); h0 and skip0 are read once and GMAX*T
// floats written per window, so the kernel is bound on chip (latency of
// the dependent layer chain and shared-memory traffic). A window of W =
// 128..1024 rows runs on a thread-block cluster of W/128 blocks (1 to 8),
// each owning 128 rows of h, skip and the scores for all L layers (the TPU
// kernel's VMEM residency). A remote source's h_u and s_tgt[u] are read from
// its block's shared memory (cluster.map_shared_rank), the slot lanes from
// device memory through L1, once per row. The messages run one warp per
// destination row with the lanes over H*D (each lane's head sum computed
// beside its numerator, in the same order), in slot order, with no atomics.
// h, skip and the scores are updated in place, so the cluster synchronises
// twice a layer: after they are in place everywhere (before any block
// gathers from them) and after the messages (before any block overwrites
// them). The readout pool of a graph that spans blocks is a per-block
// partial reduced across the cluster in rank order: deterministic, summed in
// another order than the plain version (the f32 comparisons allow 1e-4 of
// the output's scale).
//
// The two forms run the glue differently:
// - bfloat16 on the tensor cores through linear_wgmma.cuh: h stays bf16 (it
//   is rounded every layer), the messages write feat straight into wgmma's A
//   layout [K'/8][128][8] (K' = H*D padded to whole chunks of 32), and one
//   product feat . [proj_{l+1} | skip_{l+1}] ([128, 64] . [64, 128] at H*D =
//   64, one m64n128k16 a K step, proj's outputs at columns c and skip's at
//   64 + c) runs over all 128 rows a layer, its weights packed once on the
//   host (ops.local_layer.gat_glue_tiles) into chunks of 32 input channels
//   and streamed through a ring of bulk copies, every layer one sequence; h
//   is rounded and skip kept f32 on the accumulators. The score maps h . a_l
//   stay FMA over the rounded h: riding as extra columns of the glue they
//   would be feat . (proj . a), computed before h is rounded, and the
//   rounding point would move. At H*D = 64: h 16 KB, skip 32 KB, feat 16 KB,
//   the ring 2 x 8 KB, ~8 KB of the rest: 88 KB, two blocks an SM;
// - float32 keeps register-tiled FMA (TF32 would break the f32 gate of
//   1e-4), each thread holding 8 rows x 8 columns of [h | skip], the layer's
//   weights staged in f32: 136 KB, one block an SM.
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the glue's product (and the weight ring), bit 1 skips the messages; the
// phase split of chip_smoke.py times the kernel with each.
//
// Numerics: activations and weights are float or bfloat16 (T); every
// product and sum is float32; msg, feat, h and the final msg + skip round
// to T where the TPU kernel casts to its compute dtype; the scores and the
// skip term of layers >= 1 stay float32, as in gat_local_model_pairs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "linear_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;
namespace lw = linear_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 glue tile
constexpr int kTC = 16;                // thread columns of the f32 glue tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 8;             // output columns per thread
constexpr int kMaxHD = kTC * kColsPT / 2;  // widest H*D either form's tile covers (64)
constexpr int kGlueN = 2 * kMaxHD;     // the bf16 glue's width: skip's outputs at 64 + c
constexpr int kLaneHD = (kMaxHD + 31) / 32;  // H*D columns per lane in the messages
constexpr int kMaxHeads = 8;
constexpr int kMaxSlots = 8;
constexpr int kNoProduct = 1, kNoMessages = 2;  // Dims::knockout bits

static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");

struct Dims {
  int n, window, hd, heads, layers, gmax, tout, slots, lanes, stages, knockout;
};

// The prefix layout: slot k's lanes at offs[k]..offs[k]+caps[k].
struct Caps {
  int caps[kMaxSlots];
  int offs[kMaxSlots];
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and feat are bf16 and which holds the weight ring (ring,
// bars); the f32 form stages its layer's weights in w.
struct Smem {
  size_t h, skip, m, sc, a, w, p, gl, rows, gstart, ring, bars, total;
};

inline Smem smem_layout(bool wg, int hd, int heads, int gmax, int tout, int stages) {
  const size_t HD = hd, H2 = 2 * size_t(heads);
  const lw::Geom lg = lw::geom(hd, kGlueN);
  size_t p = (size_t(kRows) + gmax) * tout * 4;  // head outputs and partials
  if (size_t(gmax) * 4 > p) p = size_t(gmax) * 4;  // CSR cursor
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(kRows * HD * (wg ? 2 : 4));
  s.skip = take(kRows * HD * 4);
  s.m = take(wg ? size_t(kRows) * lg.kp * 2 : kRows * HD * 4);
  s.sc = take(kRows * H2 * 4);
  s.a = take(HD * H2 * 4);
  s.w = take(wg ? 0 : HD * 2 * HD * 4);
  s.p = take(p);
  s.gl = take(kRows * 4);
  s.rows = take(kRows * 4);
  s.gstart = take((gmax + 1) * 4);
  s.ring = take(wg ? size_t(stages) * lg.chunk_bytes : 0);
  s.bars = take(wg ? size_t(stages) * 8 : 0);
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// h and feat in shared memory: float, or bf16 for the wgmma form.
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename S> __device__ __forceinline__ S store(float x);
template <> __device__ __forceinline__ float store<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kWg: the bf16 form with the wgmma glue; tiles its packed weight chunks
// (linear_wgmma.cuh), layers 1..L-1 in order. lay: the shared-memory
// carve-up, computed once on the host (smem_layout).
template <typename T, bool kWg>
__global__ void __launch_bounds__(kThreads, kWg ? 2 : 1)
gat_slots_kernel(const int* __restrict__ pstack, const T* __restrict__ h0,
                 const T* __restrict__ skip0, const T* __restrict__ proj_w,
                 const T* __restrict__ skip_w, const T* __restrict__ a_all,
                 const int* __restrict__ pool_gl, const T* __restrict__ pred_hd,
                 const unsigned char* __restrict__ tiles, float* __restrict__ out, Dims dm,
                 Caps cp, Smem lay) {
  using S = T;  // h and feat in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const int W = dm.window, HD = dm.hd, H = dm.heads, H2 = 2 * H;
  const int DH = HD / H, HD2 = 2 * HD, tid = threadIdx.x;
  S* h_s = reinterpret_cast<S*>(smem + lay.h);                // [kRows][HD] h (rounded)
  float* sk_s = reinterpret_cast<float*>(smem + lay.skip);    // [kRows][HD] skip term
  S* m_s = reinterpret_cast<S*>(smem + lay.m);                // feat, or the final msg + skip:
                                                              // f32 [kRows][HD], bf16 [K'/8][kRows][8]
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc);      // [kRows][2H] s_src | s_tgt
  float* a_s = reinterpret_cast<float*>(smem + lay.a);        // [HD][2H] this layer's score map
  float* w_s = reinterpret_cast<float*>(smem + lay.w);        // f32: [HD][2HD] proj | skip
  float* p_s = reinterpret_cast<float*>(smem + lay.p);        // [kRows][T] head; cursor
  float* part_s = p_s + kRows * dm.tout;                      // [gmax][T] readout partials
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  const lw::Geom lg = lw::geom(HD, kGlueN);
  const lw::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                      dm.stages, (dm.layers - 1) * lg.chunks, lg.chunk_bytes};
  const bool do_glue = !(dm.knockout & kNoProduct), do_msg = !(dm.knockout & kNoMessages);
  // feat's element (r, c): row-major, or the wgmma A layout.
  auto m_at = [&](int r, int c) { return kWg ? lw::a_index(r, c) : r * HD + c; };

  const long wrow0 = long(win) * W;               // the window's first row
  const long row0 = wrow0 + long(rank) * kRows;   // this block's first row
  if constexpr (kWg) {
    if (tid == 0 && do_glue) ring.init();
    // feat's pad columns stay zero; the messages write columns < H*D.
    const int pad = lg.kp - HD;
    for (int i = tid; i < kRows * pad; i += kThreads) m_s[m_at(i / pad, HD + i % pad)] = store<S>(0.f);
  }
  if (!do_msg)  // timing only: the glue and the head read a defined feat
    for (int i = tid; i < kRows * HD; i += kThreads) m_s[m_at(i / HD, i % HD)] = store<S>(0.f);
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const bool real = row0 + r < dm.n;
    const long at = (row0 + r) * HD + (i - r * HD);
    h_s[i] = store<S>(real ? ld(h0 + at) : 0.f);
    sk_s[i] = real ? ld(skip0 + at) : 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) gl_s[r] = pool_gl[row0 + r];
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0 && do_glue) ring.prefetch();  // the first S weight chunks, while the layers set up
  }
  if (tid == 0) {
    // Group the block's rows by graph (ascending row order within a graph):
    // the readout then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(p_s);
    for (int g = 0; g <= dm.gmax; ++g) gstart_s[g] = 0;
    for (int r = 0; r < kRows; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) ++gstart_s[gl_s[r] + 1];
    for (int g = 0; g < dm.gmax; ++g) {
      gstart_s[g + 1] += gstart_s[g];
      cursor[g] = gstart_s[g];
    }
    for (int r = 0; r < kRows; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) rows_s[cursor[gl_s[r]]++] = r;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int* pstack_w = pstack + long(win) * dm.lanes;
  for (int l = 0; l < dm.layers; ++l) {
    const bool last = l == dm.layers - 1;
    __syncthreads();  // h is complete; a_s and w_s are consumed
    for (int i = tid; i < HD * H2; i += kThreads) a_s[i] = ld(a_all + long(l) * HD * H2 + i);
    if constexpr (!kWg) {
      if (!last && do_glue) {
        const long wl = long(l) * HD * HD;
        for (int i = tid; i < HD * HD2; i += kThreads) {
          const int k = i / HD2, c = i - k * HD2;
          w_s[i] = c < HD ? ld(proj_w + wl + k * HD + c) : ld(skip_w + wl + k * HD + c - HD);
        }
      }
    }
    __syncthreads();

    // Scores of the block's rows from the rounded h.
    for (int i = tid; i < kRows * H2; i += kThreads) {
      const int r = i / H2, c = i - r * H2;
      float s = 0.f;
      for (int j = 0; j < HD; ++j) s = fmaf(val(h_s[r * HD + j]), a_s[j * H2 + c], s);
      sc_s[i] = s;
    }
    // Every block's h and scores are in place before any block gathers.
    cluster.sync();

    // Messages, one warp per destination row, lanes over H*D; then the ELU
    // (between layers) or the final sum, into feat.
    for (int r = warp; do_msg && r < kRows; r += kWarps) {
      float num[kLaneHD], den[kLaneHD];
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) { num[j] = 0.f; den[j] = 0.f; }
      const int row = rank * kRows + r;  // the window row
      for (int k = 0; k < dm.slots; ++k) {
        if (row >= cp.caps[k]) continue;
        const int src = __ldg(pstack_w + cp.offs[k] + row);
        if (unsigned(src) >= unsigned(W)) continue;  // empty lane
        const int owner = src / kRows, su = src - owner * kRows;
        const S* hu = (owner == rank ? h_s : cluster.map_shared_rank(h_s, owner)) + su * HD;
        const float* st = (owner == rank ? sc_s : cluster.map_shared_rank(sc_s, owner)) + su * H2 + H;
#pragma unroll
        for (int j = 0; j < kLaneHD; ++j) {
          const int c = lane + 32 * j;
          if (c >= HD) break;
          const int head = c / DH;
          const float raw = __fadd_rn(sc_s[r * H2 + head], st[head]);
          const float score = expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
          num[j] = __fadd_rn(num[j], __fmul_rn(score, val(hu[c])));
          den[j] = __fadd_rn(den[j], score);
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) {
        const int c = lane + 32 * j;
        if (c >= HD) break;
        const float msg = rnd<T>(num[j] / (den[j] == 0.f ? 1.f : den[j]));
        const float x = __fadd_rn(msg, sk_s[r * HD + c]);
        m_s[m_at(r, c)] = store<S>(last ? rnd<T>(x) : rnd<T>(x <= 0.f ? __fsub_rn(expf(x), 1.f) : x));
      }
    }
    if (last) break;
    if constexpr (kWg) fence_proxy_async();  // feat, written here, is read by wgmma
    // No block reads this block's h or scores any more; feat is complete.
    cluster.sync();
    if (!do_glue) continue;

    // Glue: [h | skip] = feat . [proj_{l+1} | skip_{l+1}], h rounded.
    if constexpr (kWg) {
      float acc[kGlueN / 2];
      lw::run<kGlueN>(acc, reinterpret_cast<const __nv_bfloat16*>(m_s), ring, l * lg.chunks,
                      lg.chunks, tid);
      lw::for_each<kGlueN>(acc, kGlueN, tid, [&](int r, int c, float v) {
        if (c < HD) h_s[r * HD + c] = store<S>(v);
        else if (c >= kMaxHD && c - kMaxHD < HD) sk_s[r * HD + c - kMaxHD] = v;
      });
    } else {
      const int tr = tid / kTC, tc = tid % kTC;
      float acc[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
      for (int k = 0; k < HD; ++k) {
        float av[kRowsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) av[i] = val(m_s[(tr + kTR * i) * HD + k]);
        const float* wrow = w_s + k * HD2;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          const float wv = c < HD2 ? wrow[c] : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(av[i], wv, acc[i][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = tr + kTR * i;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          if (c < HD) h_s[r * HD + c] = store<S>(rnd<T>(acc[i][m]));
          else if (c < HD2) sk_s[r * HD + c - HD] = acc[i][m];
        }
      }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = rnd(msg + skip) . pred_hd, this block's
  // per-graph sums of p, then the cluster's sums, each block writing a share
  // of the outputs.
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int c = 0; c < HD; ++c) s = fmaf(val(m_s[m_at(r, c)]), ld(pred_hd + c * dm.tout + t), s);
    p_s[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < dm.gmax * dm.tout; i += kThreads) {
    const int g = i / dm.tout, t = i - g * dm.tout;
    float s = 0.f;
    for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) s += p_s[rows_s[j] * dm.tout + t];
    part_s[i] = s;
  }
  cluster.sync();
  float* out_w = out + long(win) * dm.gmax * dm.tout;
  for (int i = rank * kThreads + tid; i < dm.gmax * dm.tout; i += csize * kThreads) {
    float s = 0.f;
    for (int k = 0; k < csize; ++k) s += cluster.map_shared_rank(part_s, k)[i];
    out_w[i] = s;
  }
  cluster.sync();  // keep this block's shared memory until the cluster has read it
}

// Each form's kernel, by dtype code (0 = float32, 1 = bfloat16).
template <typename F>
cudaError_t with_kernel(int dtype, F&& f) {
  if (dtype == 0) return f(gat_slots_kernel<float, false>, float{});
  if (dtype == 1) return f(gat_slots_kernel<__nv_bfloat16, true>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

bool bad_geometry(int dtype, int window, int hd, int heads, int layers, int stages) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || hd < 1 ||
         hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads || layers < 1 ||
         (dtype == 1 && layers > 1 && stages < lw::min_stages(lw::geom(hd, kGlueN).chunks));
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
  const lw::Geom g = lw::geom(hd, kGlueN);
  dims[0] = g.kp;
  dims[1] = kGlueN;
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
  return (long long)smem_layout(dtype == 1, hd, heads, gmax, tout, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
int gat_slots_occupancy(int dtype, int window, int hd, int heads, int gmax, int tout,
                        int stages, int device, int* out) {
  if (bad_geometry(dtype, window, hd, heads, 2, stages)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = smem_layout(dtype == 1, hd, heads, gmax, tout, stages).total;
  return int(with_kernel(dtype, [&](auto kernel, auto) {
    hopper::ClusterLaunch ln;
    const cudaError_t e =
        hopper::cluster_launch(kernel, ln, 1, window / kRows, kThreads, bytes, nullptr);
    return e != cudaSuccess ? e : hopper::cluster_occupancy(kernel, ln, kThreads, bytes, out);
  }));
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
  if (slots < 1 || slots > kMaxSlots || num_windows < 1 ||
      bad_geometry(dtype, window, hd, heads, layers, stages) ||
      (dtype == 1 && layers > 1 && tiles == nullptr))
    return int(cudaErrorInvalidValue);
  Caps cp{};
  int lanes = 0;
  for (int k = 0; k < slots; ++k) {
    if (caps[k] < 0 || caps[k] > window) return int(cudaErrorInvalidValue);
    cp.caps[k] = caps[k];
    cp.offs[k] = lanes;
    lanes += caps[k];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, hd, heads, layers, gmax, tout, slots, lanes, stages, knockout};
  const Smem lay = smem_layout(dtype == 1, hd, heads, gmax, tout, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_kernel(dtype, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    hopper::ClusterLaunch ln;
    cudaError_t e =
        hopper::cluster_launch(kernel, ln, num_windows, window / kRows, kThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, static_cast<const int*>(pstack),
                           static_cast<const T*>(h0), static_cast<const T*>(skip0),
                           static_cast<const T*>(proj_w), static_cast<const T*>(skip_w),
                           static_cast<const T*>(a_all), static_cast<const int*>(pool_gl),
                           static_cast<const T*>(pred_hd), static_cast<const unsigned char*>(tiles),
                           static_cast<float*>(out), dm, cp, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

const char* gat_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
