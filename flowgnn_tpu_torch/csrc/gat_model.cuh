// The GAT whole-model slot megakernel for Hopper (sm_90a), templated on a
// form: kernel table row 5 (gat_local_model_slots.cu) and the four forms of
// the GAT megakernel ablation, rows 27-30 (gat_mega_ablate.cu).
//
// Row 5 replaces the TPU kernels flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_model_pairs (the default), gat_local_model_slots and
// gat_local_model_dense (with their helper _pool_epilogue). The three compute
// the same function, the whole GAT model per node window; they differ in how
// they fill the TPU's 128-lane tiles (two windows per tile, a fused glue
// matmul, a dense [W, W] mask) and, in bf16 only, in where the scores round.
// Row 5 follows the numerics of the default, gat_local_model_pairs. Rows
// 27-30 replace the TPU kernels of flowgnn_tpu/bench/ablate_gat_mega.py:
// _variant_model (v1, :50, pallas_call :198), _variant_model_v3 (:224 /
// :406), _variant_model_v4 (:428 / :536) and _variant_model_v5 (:558 /
// :688), each the same model with its own operands and rounding points, and
// with one stage knocked out by a runtime flag. Output: [NW*GMAX, T] float32
// per-window pool sums of the head-averaged prediction, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; the slot stack holds, for slot k and row r <
// caps[k], the source of row r's k-th in-edge at lane offs[k] + r, sentinel
// W for an empty lane (v1: the full stack, caps[k] = W; v4: one one-hot row
// of W a lane instead of an index). GAT's self edges come first, so slot 0
// is full. pool_gl holds each row's window-local graph id, GMAX for padding
// rows.
//
// Per layer, for window row v, its valid lanes u -> v and each score column:
//   score = exp(leaky(s_src[v] + s_tgt[u], 0.2))  (no max subtraction)
//   msg   = rnd(sum score * h_u / sum score)       (zero sum -> 1)
// then, between layers, feat = rnd(ELU(msg + skip)) and the glue product,
// and on the last layer the head pools rnd(msg + skip) . pred_hd, the head
// average composed with the prediction head (_pool_epilogue). The exp is
// expf, the reference's raw exp: a valid edge whose score overflows gives
// inf / inf as the reference does. An empty lane is skipped, not multiplied
// by a zero mask, so a non-edge's score never enters a sum. The forms
// differ in these places only (Row5, V1, V3, V4, V5 below):
//   row 5  prefix caps, gathered by index, H score columns; glue feat .
//          [proj_{l+1} | skip_{l+1}] (proj's outputs at columns c, skip's at
//          64 + c), N = 128; scores s = h . a_l by FMA over the rounded h,
//          kept float32; skip0 given;
//   v1     the full S*W stack; glue feat . [proj_l | skip_{l+1}], N = 128
//          (v1's prev is the last feat, so both products share A); scores
//          rnd(h . a_next[l-1]) by FMA; layer 0's skip prev0 . skip_w[0] in
//          the kernel before layer 0 (N = 64);
//   v3     prefix caps; glue feat . glue_w over its used columns [h | s_tgt
//          | skip | s_src], N = 136 (the zero pad of glue_w dropped when
//          packing); h and the scores rounded, skip not; skip0 given;
//   v4     v3 with the gather the product onehot . [h | s_tgt | 1] of an
//          operand tile [sum(c), W], N = 72: the function is defined for
//          any tile, so the kernel multiplies every K chunk and does not
//          search for the one; the ones column gives each lane's row sum,
//          its valid, which scales the score;
//   v5     v3 with each head's score repeated over its D columns: HD score
//          columns, glue_wx [h | s_tgt_exp | skip | s_src_exp], N = 256.
// The knockouts (Flag) are the plain version's
// (flowgnn_tpu_torch/bench/ablate_gat_mega.py: gat_mega_ablate_ref):
// branches uniform over the block, which row 5's instantiation compiles out.
//
// What bounds it on this card: per 128 rows and layer the messages are
// sum(c) lanes x H*D multiply-adds plus sum(c) x H*D exps, the glue 128 x H*D
// x N multiply-adds (v4's gather 128 x W x 72 a slot); h0 and skip0 are read
// once and GMAX*T floats written per window, so the kernel is bound on chip
// (latency of the dependent layer chain and shared-memory traffic). A window
// of W = 128..1024 rows runs on a thread-block cluster of W/128 blocks (1 to
// 8), each owning 128 rows of h, skip and the scores for all L layers (the
// TPU kernel's VMEM residency). A remote source's h_u and s_tgt[u] are read
// from its block's shared memory (cluster.map_shared_rank), the slot lanes
// from device memory through L1, once per row. The messages run one warp per
// destination row with the lanes over H*D (each lane's score sum computed
// beside its numerator, in the same order), in slot order, with no atomics.
// h, skip and the scores are updated in place, so the cluster synchronises
// twice a layer: after they are in place everywhere (before any block
// gathers from them) and after the messages (before any block overwrites
// them). The readout pool of a graph that spans blocks is a per-block
// partial reduced across the cluster in rank order: deterministic, summed in
// another order than the plain version (the f32 comparisons allow 1e-4 of
// the output's scale).
//
// The two dtypes run the products differently:
// - bfloat16 on the tensor cores through linear_wgmma.cuh: h stays bf16 (it
//   is rounded every layer), the messages write feat straight into wgmma's A
//   layout [K'/8][128][8] (K' = H*D padded to whole chunks of 32), and one
//   product feat . B (the form's N columns, one m64nNk16 a K step) runs over
//   all 128 rows a layer, its weights packed once on the host
//   (ops.local_layer.gat_glue_tiles; the ablation's
//   bench/ablate_gat_mega.py:glue_tiles) into chunks of 32 input channels and
//   streamed through a ring of bulk copies, every layer one sequence; the
//   epilogue writes h rounded and skip f32 from the accumulators. Row 5's and
//   v1's score maps h . a stay FMA over the rounded h: riding as extra
//   columns of the glue they would be feat . (proj . a), computed before h is
//   rounded, and the rounding point would move (v3-v5 compose them so, as the
//   TPU tool does). At H*D = 64: h 16 KB, skip 32 KB, feat 16 KB, the ring 2
//   x 8 KB, ~8 KB of the rest: 88 KB, two blocks an SM (row 5, v1, v3). v5's
//   HD score columns take 64 KB and its N = 256 accumulators 128 registers a
//   thread: one block an SM. v4's gather is a wgmma product per slot, A (the
//   block's 128 lanes' one-hot rows) from device memory straight into
//   registers, B the window's payload [h | s_tgt | 1] in the B layout: each
//   block writes its own 128-row chunk once a layer, and a remote chunk is
//   copied into a ring of two local buffers through distributed shared
//   memory while the tensor cores run on the chunk before it (wgmma reads
//   only the block's own shared memory). Copying per slot keeps the
//   footprint at any W (holding the whole window's payload would take 144
//   KB at W = 1024); the products' f32 sums [128][72] (36 KB) go through
//   shared memory to the warp-per-row messages, whose sums stay there across
//   the slots (34 KB; 16 rows a warp in registers spilled): one block an SM.
// - float32 keeps register-tiled FMA (TF32 would break the f32 gate of
//   1e-4), each thread holding 8 rows x 8 columns of a 128-column pass, the
//   pass's weights staged in f32 (row 5: 136 KB, one block an SM); v4's
//   gather is the same tile over K = W, B read from the owning block.
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the glue's product (and the weight ring), bit 1 skips the messages; the
// phase split of chip_smoke.py times row 5 with each.
//
// Numerics: activations and weights are float or bfloat16 (T); every
// product and sum is float32; msg, feat, h and the final msg + skip round
// to T where the TPU kernel casts to its compute dtype; row 5's scores and
// the skip term of layers >= 1 stay float32, as in gat_local_model_pairs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "linear_wgmma.cuh"

namespace gat_model {

namespace cg = cooperative_groups;
using namespace hopper;
namespace lw = linear_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 tile
constexpr int kTC = 16;                // thread columns of the f32 tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 8;             // output columns per thread
constexpr int kPass = kTC * kColsPT;   // columns of one f32 pass (128)
constexpr int kMaxHD = 64;             // widest H*D
constexpr int kPitch = 64;             // row 5 / v1 glue: skip's outputs at 64 + c
constexpr int kLaneHD = (kMaxHD + 31) / 32;  // H*D columns per lane in the messages
constexpr int kMaxHeads = 8;
constexpr int kMaxSlots = 8;
constexpr int kGatherN = 72;           // v4's gather width: [h | s_tgt | 1] padded
constexpr int kGatherCPT = 5;          // f32 gather columns per thread (80 >= H*D + H + 1)
constexpr int kNoProduct = 1, kNoMessages = 2;  // Dims::knockout bits

// The ablation's knockouts (bench/ablate_gat_mega.py: FLAGS).
enum Flag : int {
  kNoExp = 1, kNoGather = 2, kNoExpand = 4, kNoGlue = 8, kNoPool = 16,
  kNoDivide = 32, kNoCast = 64, kStaticCat = 128, kAddCat = 256, kNoElu = 512,
};

static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");

// The form policies: the code (the ablation's form number, row 5 0), the
// glue product's width N, whether the ablation flags are read, whether the
// scores round to T, and the blocks an SM the bf16 form is built for.
struct Row5 {
  static constexpr int kForm = 0, kGlueN = 128, kBlocksWg = 2;
  static constexpr bool kAblate = false;
};
struct V1 {
  static constexpr int kForm = 1, kGlueN = 128, kBlocksWg = 2;
  static constexpr bool kAblate = true;
};
struct V3 {
  static constexpr int kForm = 3, kGlueN = 136, kBlocksWg = 2;
  static constexpr bool kAblate = true;
};
struct V4 {
  static constexpr int kForm = 4, kGlueN = 136, kBlocksWg = 1;
  static constexpr bool kAblate = true;
};
struct V5 {
  static constexpr int kForm = 5, kGlueN = 256, kBlocksWg = 1;
  static constexpr bool kAblate = true;
};

__host__ __device__ inline int glue_n(int form) {
  return form == 5 ? V5::kGlueN : (form == 3 || form == 4) ? V3::kGlueN : Row5::kGlueN;
}
// Score columns a row: H, or H*D for v5.
__host__ __device__ inline int score_cols(int form, int hd, int heads) {
  return form == 5 ? hd : heads;
}
// v1 keeps layer 0's payload [h | s_tgt] for staticcat / addcat.
__host__ __device__ inline bool keeps_layer0(int form, int flags) {
  return form == 1 && (flags & (kStaticCat | kAddCat));
}
// v4 gathers by its product unless nogather.
__host__ __device__ inline bool gathers_by_product(int form, int flags) {
  return form == 4 && !(flags & kNoGather);
}

struct Dims {
  int n, window, hd, heads, layers, gmax, tout, slots, lanes, stages, knockout, flags, ldw;
};

// The prefix layout: slot k's lanes at offs[k]..offs[k]+caps[k].
struct Caps {
  int caps[kMaxSlots];
  int offs[kMaxSlots];
};

// The kernel's operands. w: row 5's skip_w (layers 1..L-1), v1's skip_w (all
// layers), v3 / v4's glue_w, v5's glue_wx, row stride Dims::ldw; a: row 5's
// a_all (every layer), v1's a_next (layers 1..L-1); x0: skip0, v1's prev0;
// s0: the ablation's layer-0 scores [s_src | s_tgt]; onehot: v4's tiles;
// tiles: the bf16 glue chunks.
template <typename T>
struct Operands {
  const int* pstack;
  const T* onehot;
  const T* h0;
  const T* x0;
  const T* s0;
  const T* w;
  const T* proj_w;
  const T* a;
  const int* pool_gl;
  const T* pred_hd;
  const unsigned char* tiles;
  float* out;
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and feat are bf16 and which holds the weight ring (ring,
// bars); the f32 form stages a pass's weights in w. h0 / st0: v1's layer-0
// payload; pb / stage / g / num / den: v4's payload chunk in the B layout,
// the copies of remote chunks, the gathered rows, the messages' sums.
struct Smem {
  size_t h, skip, m, sc, a, w, p, gl, rows, gstart, ring, bars, h0, st0, pb, stage, g, num, den,
      total;
};

inline Smem smem_layout(int form, bool wg, int window, int hd, int heads, int gmax, int tout,
                        int stages, int flags) {
  const size_t HD = hd, SW = score_cols(form, hd, heads);
  const lw::Geom lg = lw::geom(hd, glue_n(form));
  size_t p = (size_t(kRows) + gmax) * tout * 4;  // head outputs and partials
  if (size_t(gmax) * 4 > p) p = size_t(gmax) * 4;  // CSR cursor
  const bool cat = keeps_layer0(form, flags), v4 = gathers_by_product(form, flags);
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
  s.sc = take(kRows * 2 * SW * 4);
  s.a = take(form <= 1 ? HD * 2 * heads * 4 : 0);
  s.w = take(wg ? 0 : HD * kPass * 4);
  s.p = take(p);
  s.gl = take(kRows * 4);
  s.rows = take(kRows * 4);
  s.gstart = take((gmax + 1) * 4);
  s.ring = take(wg ? size_t(stages) * lg.chunk_bytes : 0);
  s.bars = take(wg ? size_t(stages) * 8 : 0);
  s.h0 = take(cat ? kRows * HD * (wg ? 2 : 4) : 0);
  s.st0 = take(cat ? kRows * SW * 4 : 0);
  s.pb = take(v4 && wg ? size_t(kRows) * kGatherN * 2 : 0);
  s.stage = take(v4 && wg && window > kRows ? 2 * size_t(kRows) * kGatherN * 2 : 0);
  s.g = take(v4 ? size_t(kRows) * kGatherN * 4 : 0);
  s.num = take(v4 ? kRows * HD * 4 : 0);
  s.den = take(v4 ? kRows * SW * 4 : 0);
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

// Two adjacent T of a one-hot row as one 32-bit register (bf16 only).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// The f32 glue weight of logical column c (the bf16 product's column) of
// layer l's product, input channel k; layer0: v1's skip_w[0] (N = 64).
template <class F, typename T>
__device__ __forceinline__ float glue_weight(const Operands<T>& op, const Dims& dm, int l, int k,
                                             int c, bool layer0) {
  const int HD = dm.hd, H = dm.heads;
  if constexpr (F::kForm == 0 || F::kForm == 1) {
    const long rows = long(HD) * HD;
    if (layer0) return c < HD ? ld(op.w + long(k) * HD + c) : 0.f;
    if (c < HD) return ld(op.proj_w + l * rows + long(k) * HD + c);
    if (c >= kPitch && c - kPitch < HD)  // row 5: skip_{l+1} is skip_w's block l; v1's block l+1
      return ld(op.w + (l + (F::kForm == 1)) * rows + long(k) * HD + c - kPitch);
    return 0.f;
  } else {
    const T* row = op.w + (long(l) * HD + k) * dm.ldw;
    if constexpr (F::kForm == 5) return c < 4 * HD ? ld(row + c) : 0.f;
    const int pay = dm.ldw - HD - H;  // glue_w's skip columns start at pay
    if (c < HD + H) return ld(row + c);
    return c < 2 * (HD + H) ? ld(row + pay + c - HD - H) : 0.f;
  }
}

// One 128-column f32 pass of A . B over K: each thread 8 rows x 8 columns
// (rows tr + 16i, columns tc + 16m), fmaf in k order; a(r, k), b(k, c), then
// f(r, c, value) for every output.
template <int kCPT, typename A, typename B, typename F>
__device__ __forceinline__ void fma_tile(int K, int tid, A&& a, B&& b, F&& f) {
  const int tr = tid / kTC, tc = tid % kTC;
  float acc[kRowsPT][kCPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kCPT; ++m) acc[i][m] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[kRowsPT], bv[kCPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) av[i] = a(tr + kTR * i, k);
#pragma unroll
    for (int m = 0; m < kCPT; ++m) bv[m] = b(k, tc + kTC * m);
#pragma unroll
    for (int m = 0; m < kCPT; ++m)
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(av[i], bv[m], acc[i][m]);
  }
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kCPT; ++m) f(tr + kTR * i, tc + kTC * m, acc[i][m]);
}

// kWg: the bf16 form with the wgmma products; op.tiles its packed weight
// chunks (linear_wgmma.cuh), v1's layer-0 skip first, then the glue of
// layers 0..L-2 in order. lay: the shared-memory carve-up, computed once on
// the host (smem_layout).
template <typename T, bool kWg, class F>
__global__ void __launch_bounds__(kThreads, kWg ? F::kBlocksWg : 1)
gat_model_kernel(const Operands<T> op, const Dims dm, const Caps cp, const Smem lay) {
  using S = T;  // h and feat in shared memory
  constexpr int kForm = F::kForm;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const int W = dm.window, HD = dm.hd, H = dm.heads, H2 = 2 * H;
  const int SW = kForm == 5 ? HD : H, S2 = 2 * SW;  // score columns; [s_src | s_tgt] a row
  const int DH = HD / H, tid = threadIdx.x;
  const int flags = F::kAblate ? dm.flags : 0;
  auto on = [flags](int f) { return F::kAblate && (flags & f) != 0; };
  S* h_s = reinterpret_cast<S*>(smem + lay.h);                // [kRows][HD] h (rounded)
  float* sk_s = reinterpret_cast<float*>(smem + lay.skip);    // [kRows][HD] skip term
  S* m_s = reinterpret_cast<S*>(smem + lay.m);                // feat, or the final msg + skip:
                                                              // f32 [kRows][HD], bf16 [K'/8][kRows][8]
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc);      // [kRows][2SW] s_src | s_tgt
  float* a_s = reinterpret_cast<float*>(smem + lay.a);        // [HD][2H] this layer's score map
  float* w_s = reinterpret_cast<float*>(smem + lay.w);        // f32: [HD][kPass] a glue pass
  float* p_s = reinterpret_cast<float*>(smem + lay.p);        // [kRows][T] head; cursor
  float* part_s = p_s + kRows * dm.tout;                      // [gmax][T] readout partials
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  S* h0_s = reinterpret_cast<S*>(smem + lay.h0);              // v1: [kRows][HD] layer 0's h
  float* st0_s = reinterpret_cast<float*>(smem + lay.st0);    // v1: [kRows][SW] layer 0's s_tgt
  __nv_bfloat16* pb_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.pb);  // v4: [16][72][8]
  __nv_bfloat16* stage_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.stage);  // v4: 2 of them
  float* g_s = reinterpret_cast<float*>(smem + lay.g);        // v4: [kRows][72] gathered
  float* num_s = reinterpret_cast<float*>(smem + lay.num);    // v4: [kRows][HD] sums
  float* den_s = reinterpret_cast<float*>(smem + lay.den);    // v4: [kRows][SW] one a score column
  const lw::Geom lg = lw::geom(HD, F::kGlueN);
  // v1 streams layer 0's skip chunks before the glue's.
  const int first_glue = kForm == 1 ? lg.chunks : 0;
  const lw::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), op.tiles,
                      dm.stages, (kForm == 1 ? dm.layers : dm.layers - 1) * lg.chunks,
                      lg.chunk_bytes};
  const bool no_glue = on(kNoGlue);
  const bool do_glue = !(dm.knockout & kNoProduct) && !no_glue;
  const bool do_msg = !(dm.knockout & kNoMessages);
  const bool cat0 = keeps_layer0(kForm, flags);
  const bool by_product = gathers_by_product(kForm, flags);
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
    h_s[i] = store<S>(real ? ld(op.h0 + at) : 0.f);
    const float x = real ? ld(op.x0 + at) : 0.f;
    if constexpr (kForm == 1) {  // x0 is prev0, the A of layer 0's skip product
      sk_s[i] = 0.f;
      m_s[m_at(r, i - r * HD)] = store<S>(x);
      if (cat0) h0_s[i] = h_s[i];
    } else {
      sk_s[i] = x;
    }
  }
  if constexpr (kForm != 0) {  // layer 0's scores are given
    for (int i = tid; i < kRows * SW; i += kThreads) {
      const int r = i / SW, c = i - r * SW;
      const bool real = row0 + r < dm.n;
      const long at = (row0 + r) * S2 + c;
      sc_s[r * S2 + c] = real ? ld(op.s0 + at) : 0.f;
      const float st = real ? ld(op.s0 + at + SW) : 0.f;
      sc_s[r * S2 + SW + c] = st;
      if (cat0) st0_s[i] = st;
    }
  }
  for (int r = tid; r < kRows; r += kThreads) gl_s[r] = op.pool_gl[row0 + r];
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

  // The glue epilogue: logical column c of the product (see the top).
  auto glue_store = [&](int r, int c, float v) {
    if constexpr (kForm == 0 || kForm == 1) {
      if (c < HD) h_s[r * HD + c] = store<S>(rnd<T>(v));
      else if (c >= kPitch && c - kPitch < HD) sk_s[r * HD + c - kPitch] = v;
    } else {
      const int c2 = c - HD - SW;  // skip's and s_src's columns follow [h | s_tgt]
      if (c < HD) h_s[r * HD + c] = store<S>(rnd<T>(v));
      else if (c < HD + SW) sc_s[r * S2 + SW + c - HD] = rnd<T>(v);
      else if (c2 < HD) sk_s[r * HD + c2] = v;
      else if (c2 < HD + SW) sc_s[r * S2 + c2 - HD] = rnd<T>(v);
    }
  };
  // The f32 glue's weights: logical columns cb..cb+kPass-1 of layer l's.
  auto stage_w = [&](int l, int cb, bool layer0) {
    for (int i = tid; i < HD * kPass; i += kThreads) {
      const int k = i / kPass;
      w_s[i] = glue_weight<F>(op, dm, l, k, cb + i - k * kPass, layer0);
    }
  };
  // The f32 glue pass over feat (or prev0) and the staged weights.
  auto f32_pass = [&](int cb, int ncols, auto&& out) {
    fma_tile<kColsPT>(
        HD, tid, [&](int r, int k) { return val(m_s[r * HD + k]); },
        [&](int k, int c) { return w_s[k * kPass + c]; },
        [&](int r, int c, float v) {
          if (cb + c < ncols) out(r, cb + c, v);
        });
  };

  if constexpr (kForm == 1) {
    // Layer 0's skip = prev0 . skip_w[0] (feat holds prev0).
    if (do_glue) {
      if constexpr (kWg) {
        fence_proxy_async();
        __syncthreads();
        float acc[32];
        lw::run<64>(acc, reinterpret_cast<const __nv_bfloat16*>(m_s), ring, 0, lg.chunks, tid);
        lw::for_each<64>(acc, HD, tid, [&](int r, int c, float v) { sk_s[r * HD + c] = v; });
      } else {
        stage_w(0, 0, true);
        __syncthreads();
        f32_pass(0, HD, [&](int r, int c, float v) { sk_s[r * HD + c] = v; });
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int* pstack_w = op.pstack + long(win) * dm.lanes;
  const T* onehot_w = op.onehot + long(win) * dm.lanes * W;
  float* out_w = op.out + long(win) * dm.gmax * dm.tout;

  // Column c's score column, and row r's score in it against a source's
  // s_tgt s2 (v4: times the lane's valid vf).
  auto score_col = [&](int c) { return kForm == 5 ? c : (on(kNoExpand) ? 0 : c / DH); };
  auto score_of = [&](int r, int sc, float s2, float vf) {
    const float raw = __fadd_rn(sc_s[r * S2 + sc], s2);
    const float score = on(kNoExp) ? raw : expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
    return kForm == 4 ? __fmul_rn(score, vf) : score;
  };
  // Row r's msg from its sums; then feat (between layers), or the final
  // msg + skip (the head's input, or nopool's output).
  auto finish_row = [&](const float (&num)[kLaneHD], const float (&den)[kLaneHD], int r,
                        bool last) {
    const int row = rank * kRows + r;
#pragma unroll
    for (int j = 0; j < kLaneHD; ++j) {
      const int c = lane + 32 * j;
      if (c >= HD) break;
      float msg = on(kNoDivide) ? num[j] : num[j] / (den[j] == 0.f ? 1.f : den[j]);
      if (!on(kNoCast)) msg = rnd<T>(msg);
      if (kForm == 1 && no_glue && !last) {  // h = prev = rnd(msg)
        m_s[m_at(r, c)] = store<S>(rnd<T>(msg));
        continue;
      }
      const float x = __fadd_rn(msg, sk_s[r * HD + c]);
      if (!last) {
        m_s[m_at(r, c)] = store<S>(rnd<T>(x <= 0.f && !on(kNoElu) ? __fsub_rn(expf(x), 1.f) : x));
      } else if (on(kNoPool)) {
        if (row < dm.gmax && c < dm.tout) out_w[row * dm.tout + c] = x;
      } else {
        m_s[m_at(r, c)] = store<S>(rnd<T>(x));
      }
    }
  };

  for (int l = 0; l < dm.layers; ++l) {
    const bool last = l == dm.layers - 1;
    // Row 5 maps every layer's scores from h; v1 layer l >= 1's, rounded.
    const bool score_map = kForm == 0 || (kForm == 1 && l > 0 && !no_glue);
    __syncthreads();  // h is complete; a_s and w_s are consumed
    if (score_map) {
      const T* a_l = op.a + long(kForm == 0 ? l : l - 1) * HD * H2;
      for (int i = tid; i < HD * H2; i += kThreads) a_s[i] = ld(a_l + i);
    }
    if constexpr (!kWg && (kForm == 0 || kForm == 1)) {
      if (!last && do_glue) stage_w(l, 0, false);  // one pass: staged beside the score map
    }
    __syncthreads();

    if (score_map) {  // scores of the block's rows from the rounded h
      for (int i = tid; i < kRows * H2; i += kThreads) {
        const int r = i / H2, c = i - r * H2;
        float s = 0.f;
        for (int j = 0; j < HD; ++j) s = fmaf(val(h_s[r * HD + j]), a_s[j * H2 + c], s);
        sc_s[i] = kForm == 0 ? s : rnd<T>(s);
      }
    }
    if constexpr (kWg && kForm == 4) {
      if (by_product) {
        // This block's chunk of the payload [h | s_tgt | 1], in the B layout
        // [rows/8][72][8] (K-major: K the source row).
        for (int i = tid; i < kRows * kGatherN; i += kThreads) {
          const int u = i / kGatherN, c = i - u * kGatherN;
          const float v = c < HD ? val(h_s[u * HD + c])
                          : c < HD + H ? sc_s[u * S2 + H + c - HD] : c == HD + H ? 1.f : 0.f;
          pb_s[((u >> 3) * kGatherN + c) * 8 + (u & 7)] = __float2bfloat16_rn(v);
        }
      }
    }
    // Every block's h and scores are in place before any block gathers.
    cluster.sync();

    const float add = kForm == 1 && on(kAddCat) ? rnd<T>(float(double(l) * 1e-7)) : 0.f;
    if constexpr (kForm == 4) {
      if (by_product && do_msg) {
        // v4: per slot, the gather G = onehot . [payload | 1] over the
        // window's W/128 chunks into g_s, then each warp's rows take their
        // lane; the sums stay in shared memory across the slots (a score
        // column's sum once: its columns add the same scores in the same
        // order).
        for (int i = tid; i < kRows * HD; i += kThreads) num_s[i] = 0.f;
        for (int i = tid; i < kRows * SW; i += kThreads) den_s[i] = 0.f;
        for (int k = 0; k < dm.slots; ++k) {
          if (rank * kRows >= cp.caps[k]) continue;  // uniform: no row of this block has slot k
          const T* tile_k = onehot_w + long(cp.offs[k] + rank * kRows) * W;
          const int rows_k = cp.caps[k] - rank * kRows;  // this block's rows with a lane in slot k
          if constexpr (kWg) {
            const int nc = W / kRows, wgi = tid / 128, g8 = (tid % 32) / 4, q = tid % 4;
            const int r0 = 64 * wgi + 16 * ((tid % 128) / 32) + g8, r1 = r0 + 8;
            const __nv_bfloat16* a0 = tile_k + long(r0) * W + 2 * q;
            const __nv_bfloat16* a1 = tile_k + long(r1) * W + 2 * q;
            const bool v0 = r0 < rows_k, v1 = r1 < rows_k;
            auto copy_chunk = [&](int j) {  // block j's payload chunk into stage buffer j & 1
              const int4* src = reinterpret_cast<const int4*>(cluster.map_shared_rank(pb_s, j));
              int4* dst = reinterpret_cast<int4*>(stage_s + (j & 1) * kRows * kGatherN);
              for (int i = tid; i < kRows * kGatherN / 8; i += kThreads) dst[i] = src[i];
            };
            float acc[kGatherN / 2];
            if (rank != 0) copy_chunk(0);
            fence_proxy_async();
            __syncthreads();
            for (int j = 0; j < nc; ++j) {
              const __nv_bfloat16* b = j == rank ? pb_s : stage_s + (j & 1) * kRows * kGatherN;
              uint32_t fa[kRows / 16][4];
#pragma unroll
              for (int s = 0; s < kRows / 16; ++s) {
                const int col = j * kRows + 16 * s;
                fa[s][0] = v0 ? ld_pair(a0 + col) : 0u;
                fa[s][1] = v1 ? ld_pair(a1 + col) : 0u;
                fa[s][2] = v0 ? ld_pair(a0 + col + 8) : 0u;
                fa[s][3] = v1 ? ld_pair(a1 + col + 8) : 0u;
              }
              wgmma_fence();
#pragma unroll
              for (int s = 0; s < kRows / 16; ++s) {
                const uint64_t db = desc(b + size_t(2 * s) * kGatherN * 8, kGatherN * 16, 128);
                mma_bf16_rs<kGatherN>(acc, fa[s], db, j > 0 || s > 0);
              }
              wgmma_commit();
              if (j + 1 < nc && j + 1 != rank) copy_chunk(j + 1);  // beside chunk j's product
              wgmma_wait<0>();
              fence_regs(acc);
              fence_proxy_async();
              __syncthreads();
            }
            lw::for_each<kGatherN>(acc, HD + H + 1, tid,
                                   [&](int r, int c, float v) { g_s[r * kGatherN + c] = v; });
          } else {
            fma_tile<kGatherCPT>(
                W, tid,
                [&](int r, int q) { return r < rows_k ? ld(tile_k + long(r) * W + q) : 0.f; },
                [&](int q, int c) {
                  const int owner = q / kRows, qu = q - owner * kRows;
                  const S* hq = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
                  const float* sq = owner == rank ? sc_s : cluster.map_shared_rank(sc_s, owner);
                  return c < HD ? val(hq[qu * HD + c])
                         : c < HD + H ? sq[qu * S2 + H + c - HD] : c == HD + H ? 1.f : 0.f;
                },
                [&](int r, int c, float v) {
                  if (c < HD + H + 1) g_s[r * kGatherN + c] = v;
                });
          }
          __syncthreads();  // the gathered rows are complete
          for (int r = warp; r < rows_k && r < kRows; r += kWarps) {
            const float* gr = g_s + r * kGatherN;
            const float vf = gr[HD + H];
            if (vf == 0.f) continue;  // an empty lane
#pragma unroll
            for (int j = 0; j < kLaneHD; ++j) {
              const int c = lane + 32 * j;
              if (c >= HD) break;
              const int sc = score_col(c);
              const float score = score_of(r, sc, gr[HD + sc], vf);
              num_s[r * HD + c] = __fadd_rn(num_s[r * HD + c], __fmul_rn(score, gr[c]));
              if (c == 0 || score_col(c - 1) != sc)  // the score column's first column
                den_s[r * SW + sc] = __fadd_rn(den_s[r * SW + sc], score);
            }
          }
          __syncthreads();  // g_s is read before the next slot's gather
        }
        for (int r = warp; r < kRows; r += kWarps) {
          float num[kLaneHD], den[kLaneHD];
#pragma unroll
          for (int j = 0; j < kLaneHD; ++j) {
            const int c = lane + 32 * j;
            num[j] = c < HD ? num_s[r * HD + c] : 0.f;
            den[j] = c < HD ? den_s[r * SW + score_col(c)] : 0.f;
          }
          finish_row(num, den, r, last);
        }
      }
    }
    // Messages by index, one warp per destination row, lanes over H*D; then
    // the ELU (between layers) or the final sum, into feat.
    for (int r = warp; do_msg && !by_product && r < kRows; r += kWarps) {
      float num[kLaneHD], den[kLaneHD];
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) { num[j] = 0.f; den[j] = 0.f; }
      const int row = rank * kRows + r;  // the window row
      for (int k = 0; k < dm.slots; ++k) {
        if (row >= cp.caps[k]) continue;
        const int li = cp.offs[k] + row;  // the lane in the window's stack
        float vf = 1.f;
        int src;
        bool zero = false;
        if constexpr (kForm == 4) {  // nogather: valid is the tile row's sum
          const T* tr = onehot_w + long(li) * W;
          float s = 0.f;
          for (int q = lane; q < W; q += 32) s = __fadd_rn(s, ld(tr + q));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
          vf = s;
          if (vf == 0.f) continue;  // an empty lane
          src = li % W;
        } else {
          const int u = __ldg(pstack_w + li);
          if constexpr (F::kAblate) {
            if (u >= W) continue;  // empty lane
            src = on(kNoGather) ? li % W : u;
            zero = !on(kNoGather) && u < 0;  // valid, with a zero payload
            if (zero) src = 0;
          } else {
            if (unsigned(u) >= unsigned(W)) continue;  // empty lane
            src = u;
          }
        }
        const int owner = src / kRows, su = src - owner * kRows;
        const S* hb = cat0 ? h0_s : h_s;
        const float* sb = cat0 ? st0_s : sc_s + SW;
        const S* hu = (owner == rank ? hb : cluster.map_shared_rank(hb, owner)) + su * HD;
        const float* st = (owner == rank ? sb : cluster.map_shared_rank(sb, owner)) +
                          su * (cat0 ? SW : S2);
        // addcat: layer 0's payload + l·1e-7, rounded
        auto payload = [&](float v) {
          v = zero ? 0.f : v;
          return kForm == 1 && on(kAddCat) ? rnd<T>(__fadd_rn(v, add)) : v;
        };
#pragma unroll
        for (int j = 0; j < kLaneHD; ++j) {
          const int c = lane + 32 * j;
          if (c >= HD) break;
          const int sc = score_col(c);
          const float score = score_of(r, sc, payload(st[sc]), vf);
          num[j] = __fadd_rn(num[j], __fmul_rn(score, payload(val(hu[c]))));
          den[j] = __fadd_rn(den[j], score);
        }
      }
      finish_row(num, den, r, last);
    }
    if (last) break;
    if constexpr (kWg) fence_proxy_async();  // feat, written here, is read by wgmma
    // No block reads this block's h or scores any more; feat is complete.
    cluster.sync();
    if (no_glue) {
      // v1: h = prev = rnd(msg), the scores those of the layer before; v3: h
      // = skip = feat, s_tgt 0.
      for (int i = tid; i < kRows * HD; i += kThreads) {
        const int r = i / HD, c = i - r * HD;
        const S f = m_s[m_at(r, c)];
        h_s[i] = f;
        if (kForm == 3) sk_s[i] = val(f);
      }
      if (kForm == 3)
        for (int i = tid; i < kRows * H; i += kThreads) sc_s[(i / H) * S2 + H + i % H] = 0.f;
      continue;
    }
    if (!do_glue) continue;

    // Glue: the form's product feat . B, its epilogue into h, skip and the
    // scores.
    if constexpr (kWg) {
      float acc[F::kGlueN / 2];
      lw::run<F::kGlueN>(acc, reinterpret_cast<const __nv_bfloat16*>(m_s), ring,
                         first_glue + l * lg.chunks, lg.chunks, tid);
      lw::for_each<F::kGlueN>(acc, F::kGlueN, tid, glue_store);
    } else if constexpr (kForm == 0 || kForm == 1) {
      f32_pass(0, F::kGlueN, glue_store);  // its weights staged beside the score map
    } else {
      for (int cb = 0; cb < F::kGlueN; cb += kPass) {
        if (cb > 0) __syncthreads();  // the last pass has read w_s
        stage_w(l, cb, false);
        __syncthreads();
        f32_pass(cb, F::kGlueN, glue_store);
      }
    }
  }
  __syncthreads();
  if (on(kNoPool)) {  // written by the last layer's messages
    cluster.sync();   // keep this block's shared memory until the cluster has read it
    return;
  }

  // Finalize: per-row head p = rnd(msg + skip) . pred_hd, this block's
  // per-graph sums of p, then the cluster's sums, each block writing a share
  // of the outputs.
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int c = 0; c < HD; ++c) s = fmaf(val(m_s[m_at(r, c)]), ld(op.pred_hd + c * dm.tout + t), s);
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
  for (int i = rank * kThreads + tid; i < dm.gmax * dm.tout; i += csize * kThreads) {
    float s = 0.f;
    for (int k = 0; k < csize; ++k) s += cluster.map_shared_rank(part_s, k)[i];
    out_w[i] = s;
  }
  cluster.sync();  // keep this block's shared memory until the cluster has read it
}

// The checks every launch and every query of a form makes: W whole blocks of
// kRows, at most kMaxCluster; H*D and the heads; v3 / v4's glue and v4's
// gather columns within their widths; the bf16 ring deep enough.
inline bool bad_geometry(int form, int dtype, int window, int hd, int heads, int layers,
                         int stages) {
  const int chunks = (form == 1 ? layers : layers - 1) * lw::geom(hd, glue_n(form)).chunks;
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || hd < 1 ||
         hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads || layers < 1 ||
         ((form == 3 || form == 4) && 2 * (hd + heads) > V3::kGlueN) ||
         (dtype == 1 && chunks > 0 && stages < lw::min_stages(lw::geom(hd, glue_n(form)).chunks));
}

// The kernel of `Form` in dtype code `dtype` (0 = float32, 1 = bfloat16),
// handed to f with a tag of its element type.
template <class Form, typename Fn>
cudaError_t with_kernel(int dtype, Fn&& f) {
  if (dtype == 0) return f(gat_model_kernel<float, false, Form>, float{});
  if (dtype == 1) return f(gat_model_kernel<__nv_bfloat16, true, Form>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// What the occupancy calculator says of a launch at this carve-up: out[0]
// the blocks that fit one SM, out[1] the clusters of W/128 blocks that run
// at once (cudaOccupancyMaxActiveClusters).
template <class Form>
cudaError_t occupancy(int dtype, int window, size_t bytes, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return with_kernel<Form>(dtype, [&](auto kernel, auto) {
    hopper::ClusterLaunch ln;
    const cudaError_t e =
        hopper::cluster_launch(kernel, ln, 1, window / kRows, kThreads, bytes, nullptr);
    return e != cudaSuccess ? e : hopper::cluster_occupancy(kernel, ln, kThreads, bytes, out);
  });
}

// One launch of `Form` over num_windows clusters; pointers as Operands.
template <class Form>
cudaError_t launch(int dtype, const Operands<void>& p, int num_windows, const Dims& dm,
                   const Caps& cp, const Smem& lay, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return with_kernel<Form>(dtype, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    const Operands<T> op{p.pstack,
                         static_cast<const T*>(p.onehot),
                         static_cast<const T*>(p.h0),
                         static_cast<const T*>(p.x0),
                         static_cast<const T*>(p.s0),
                         static_cast<const T*>(p.w),
                         static_cast<const T*>(p.proj_w),
                         static_cast<const T*>(p.a),
                         p.pool_gl,
                         static_cast<const T*>(p.pred_hd),
                         p.tiles,
                         p.out};
    hopper::ClusterLaunch ln;
    cudaError_t e = hopper::cluster_launch(kernel, ln, num_windows, dm.window / kRows, kThreads,
                                           lay.total, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, op, dm, cp, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

// The prefix layout of `slots` caps, each at most the window; false if not.
inline bool prefix_caps(const int* caps, int slots, int window, Caps* cp, int* lanes) {
  if (slots < 1 || slots > kMaxSlots) return false;
  *cp = Caps{};
  int o = 0;
  for (int k = 0; k < slots; ++k) {
    if (caps[k] < 0 || caps[k] > window) return false;
    cp->caps[k] = caps[k];
    cp->offs[k] = o;
    o += caps[k];
  }
  *lanes = o;
  return true;
}

}  // namespace gat_model
