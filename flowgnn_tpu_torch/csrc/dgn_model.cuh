// The DGN kernel for Hopper (sm_90a), templated on its output and on its
// lane walk: row 4 (dgn_local_model.cu, all L layers and the pool head in
// one launch over the slot layout), row 22 (dgn_local_layer_slots.cu, one
// layer over the slot layout that writes the next h to device memory, with
// the spill tail's pre-reduced channels) and row 18 (dgn_local_layer_ell.cu,
// the one-layer form over the ELL layout, no spill tail) are its three
// instantiations.
//
// Layouts (built by flowgnn_tpu_torch/models/base.py:as_batch). Slots
// (SlotWalk): node windows of W rows sorted by in-degree; slot_src [NW*W, S]
// holds each row's in-window sources, sentinel W for an empty slot, and
// slot k counts only for rows below caps[k] (the one-layer form takes every
// slot, caps[k] = W). ELL (EllWalk, lanes.cuh's Ell): `block` lanes a window
// of meta [NW*block, 5] = (u, v, three bond rows), sorted by v, so a row's
// lanes are one run; any k edge blocks a window (block = k*B). pool_gl
// holds each row's window-local graph id, GMAX for padding rows (whole-model
// form only). eig, invd, ews and inva are per-row node terms: the
// eigenvector entry, 1/max(out_deg, 1), the sum of eig_u - eig_v over
// in-edges and 1/sum |eig_u - eig_v| (EIG_EPS-guarded), in h's type.
//
// Per layer, for window row v and its sources u (its valid slots in slot
// order, or its lanes in lane order; a lane whose u lies outside [0, W) or
// on a padding row adds nothing):
//   m1 = sum h_u,  m2 = sum e_u * h_u - e_v * m1   (the TPU kernel's factoring)
// where the ELL walk rounds each lane's e_u * h_u to T before the f32 sum,
// as the ELL TPU kernel does (its lanes' [h_u | e_u * h_u] are cast to the
// compute dtype), and the slot walk does not;
//   m1 += m_spill[v, :D],  m2 += m_spill[v, D:]    (one-layer form, given a
//                                                    spill tail; already weighted)
//   a1 = m1 * invd_v,  a2 = |m2 - ews_v * h_v| * inva_v
//   y  = [rnd(a1) | rnd(a2)] . w_l + b_l          [2D] -> [D]
//   h  = rnd(h + relu(y))
// and after the last layer the whole-model form pools h . mlp1_w
// (_pool_epilogue); the one-layer form writes h' [n, D] in h's type. A row
// with spill channels and no slot source gets its channels all the same.
// The m2 and a2 chains are written with __fmul_rn / __fadd_rn / __fsub_rn:
// m2 - ews * h cancels (exactly, when every e_u equals e_v) and inva may be
// 1/EIG_EPS = 8192, so a contracted FMA would leave a residual the plain
// version does not have, amplified 8192-fold.
//
// What bounds it on this card: per 128 rows and layer the posttrans is
// 128*2D*D multiply-adds (2.6 M at D=100) against 2*S*128*D for the two
// channels; h is read once and GMAX*T floats (or h') written per window, so
// the kernel is bound on chip. A window of W = 128..1024 rows runs on a
// thread-block cluster of W/128 blocks (1 to 8), each owning 128 rows of h
// for all L layers (the TPU kernel's VMEM residency). A source in another
// block's rows is read from that block's shared memory, its eigenvector
// entry too (cluster.map_shared_rank). The channels run one warp per
// destination row with the lanes over D, in slot or lane order, with no
// atomics; a row's first 32 sources (its slots, or its run's first lanes,
// one a warp lane) are loaded from device memory one row ahead of their
// use and walked by shuffle, four sources' h_u rows in flight before their
// sums. The ELL walk finds each row's run once, before the layers
// (lanes::ell_runs: one pass over the lanes). The whole-model form updates h in
// place, so the cluster synchronises twice a layer: after h is in place
// everywhere (before any block gathers from it) and after the channels
// (before any block overwrites its h). Its readout pool of a graph that
// spans blocks is a per-block partial reduced across the cluster in rank
// order: deterministic, summed in another order than the plain version (the
// f32 comparisons allow 1e-4 of the output's scale). The one-layer form
// keeps h as it is: it stages h' in the channels' buffer once the product
// has read them and writes it out as the block's contiguous run of rows, so
// its two cluster barriers are the layer's first (h is in place before any
// gather) and one before a block exits (no block's shared memory may end
// while another still reads its h); the product does not wait for the other
// blocks' channels.
//
// The two forms run the posttrans differently:
// - bfloat16 on the tensor cores through linear_wgmma.cuh: h stays bf16 (it
//   is rounded every layer), the channels write rnd(a1) | rnd(a2) straight
//   into wgmma's A layout [K'/8][128][8] (K' = 2D padded to whole chunks of
//   32: 224 at D = 100), and one product [128, 2D] . [2D, N] per layer (N =
//   104 or 112, one m64nNk16 a K step) runs over all 128 rows, its weights
//   packed once on the host (ops.local_layer.dgn_posttrans_tiles) into
//   chunks of 32 input channels and streamed through a ring of bulk copies,
//   every layer one sequence. Bias, relu and the residual run on the
//   accumulators in registers. At D = 100, T = 50: h 25.6 KB, the channels
//   57.3 KB (which also hold the head's outputs and partials after the
//   layers, or h'), the ring S x 6.7 KB, ~3.4 KB of the rest: 113 KB at
//   S = 4, two blocks an SM (__launch_bounds__ keeps the registers at 128);
// - float32 keeps register-tiled FMA (TF32 would break the f32 gate of
//   1e-4), each thread holding 8 rows x 7 columns, the weights staged in f32
//   chunks of 32 input channels: h 51 KB, channels 103 KB, a chunk 12.8 KB,
//   ~170 KB in all, one block an SM.
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the posttrans product (and the weight ring), bit 1 skips the channels; the
// phase split of chip_smoke.py times the kernel with each.
//
// Numerics follow the TPU kernels: activations, node terms and weights are
// float or bfloat16 (T); every product and sum is float32; the two channels
// and the new h are rounded to T where the TPU kernels cast to their
// compute dtype. Against the plain version the f32 form differs in
// summation order only, the bf16 form also in the tensor cores' summation
// of the product's bf16 terms: not bit-equal.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "linear_wgmma.cuh"

namespace dgn_model {

namespace cg = cooperative_groups;
using namespace hopper;
namespace lw = linear_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 posttrans tile
constexpr int kTC = 16;                // thread columns of the f32 posttrans tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D either form's tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the channels
constexpr int kKC = 32;                // f32 posttrans input channels per weight chunk
constexpr int kMaxSlots = 8;
constexpr int kBatch = 4;              // a row's sources whose h_u rows are in flight at once
constexpr int kNoProduct = 1, kNoChannels = 2;  // Dims::knockout bits

static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");
static_assert(kRows == lanes::kRows && kThreads == lanes::kThreads, "the lane runs' block shape");

struct Dims {
  int n, window, d, layers, gmax, tout, stages, knockout;
};

// A row's first sources, loaded one row ahead of their use: u one a warp
// lane (-1: none: an empty slot, or a lane whose u lies outside [0, W) or
// on a padding row), and the row's run [e0, e1) of lanes (the ELL walk).
struct Fetched {
  int u, e0, e1;
};

// The slot walk of rows 4 and 22: window row wr's slot k is slot_src[(win
// * W + wr) * slots + k], sentinel W for an empty slot, counted for rows
// below caps[k]; the sources in slot order, e_u * h_u summed unrounded.
struct SlotWalk {
  const int* slot_src;
  int slots;
  int caps[kMaxSlots];
  static constexpr bool kRuns = false;       // no lane runs in shared memory
  static constexpr bool kRoundLane = false;  // e_u * h_u not rounded before the sum

  __device__ __forceinline__ void prepare(int, int, int, int*) const {}

  // Block row r's slots, lane k holding slot k's source.
  __device__ __forceinline__ Fetched fetch(int win, int rank, int r, const int*, int lane,
                                           int window, int) const {
    Fetched f{-1, 0, slots};
    const int wr = rank * kRows + r;
    int cap = 0;  // caps[lane] at constant indices: a runtime index copies caps to the stack
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k)
      if (k == lane) cap = caps[k];
    if (r < kRows && lane < slots && wr < cap) {
      const int src = __ldg(slot_src + (long(win) * window + wr) * slots + lane);
      if (unsigned(src) < unsigned(window)) f.u = src;
    }
    return f;
  }

  // g(u) for the row's sources, kBatch at a time in slot order (u[b] = -1:
  // none): only the slots that hold one, found by one ballot; the whole
  // warp calls it.
  template <typename G>
  __device__ __forceinline__ void visit(const Fetched& first, int, int, int, G&& g) const {
    unsigned live = __ballot_sync(0xffffffffu, first.u >= 0);
    while (live) {
      int u[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        u[b] = -1;
        if (live) {  // the same for the whole warp
          u[b] = __shfl_sync(0xffffffffu, first.u, __ffs(live) - 1);
          live &= live - 1;
        }
      }
      g(u);
    }
  }
};

// The ELL walk of row 18: lanes.cuh's Ell over meta [NW*block, 5], any k
// edge blocks a window (block = k*B lanes, one run sorted by v); each row's
// run found once (prepare), its lanes in lane order, each lane's e_u * h_u
// rounded to T before the sum (the ELL TPU kernel's rounding point).
struct EllWalk {
  lanes::Ell ell;
  static constexpr bool kRuns = true;       // lo_s: kRows + 1 ints
  static constexpr bool kRoundLane = true;

  __device__ __forceinline__ void prepare(int win, int rank, int tid, int* lo_s) const {
    ell.prepare(win, rank, tid, lo_s);
  }

  // Lane e's source if e < e1 and its u is a real row of the window, else -1.
  __device__ __forceinline__ int source(int win, int e, int e1, int window, int n) const {
    const int u = e < e1 ? __ldg(ell.meta + (long(win) * ell.block + e) * lanes::kEllMeta) : -1;
    return unsigned(u) < unsigned(window) && long(win) * window + u < n ? u : -1;
  }

  // Block row r's run and its first 32 lanes' sources, one a warp lane.
  __device__ __forceinline__ Fetched fetch(int win, int, int r, const int* lo_s, int lane,
                                           int window, int n) const {
    if (r >= kRows) return Fetched{-1, 0, 0};
    int e1 = lo_s[r + 1], e0 = lo_s[r];
    e1 = e1 < 0 ? 0 : e1 > ell.block ? ell.block : e1;
    e0 = e0 < 0 ? 0 : e0 > e1 ? e1 : e0;
    return Fetched{source(win, e0 + lane, e1, window, n), e0, e1};
  }

  // g(u) for the row's lanes, kBatch at a time in lane order (u[b] = -1: a
  // lane that adds nothing); the whole warp calls it.
  template <typename G>
  __device__ __forceinline__ void visit(const Fetched& first, int win, int window, int n,
                                        G&& g) const {
    const int lane = threadIdx.x % 32;
    for (int base = first.e0; base < first.e1; base += 32) {
      const int cnt = first.e1 - base < 32 ? first.e1 - base : 32;
      const int my_u = base == first.e0 ? first.u : source(win, base + lane, first.e1, window, n);
      for (int i0 = 0; i0 < cnt; i0 += kBatch) {
        int u[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          u[b] = __shfl_sync(0xffffffffu, my_u, (i0 + b) & 31);
          if (i0 + b >= cnt) u[b] = -1;
        }
        g(u);
      }
    }
  }
};

// The slot walk over slot_src with `slots` caps; false when a count or a
// cap is out of range (a cap above the window, or more than kMaxSlots).
inline bool make_slot_walk(SlotWalk& w, const void* slot_src, const int* caps, int slots,
                           int window) {
  if (slots < 1 || slots > kMaxSlots) return false;
  w = SlotWalk{};
  w.slot_src = static_cast<const int*>(slot_src);
  w.slots = slots;
  for (int k = 0; k < slots; ++k) {
    if (caps[k] < 0 || caps[k] > window) return false;
    w.caps[k] = caps[k];
  }
  return true;
}

// The bf16 form's product width at width d.
__host__ __device__ inline int post_n(int d) { return d <= 104 ? 104 : 112; }

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and channels are bf16 and which holds the weight ring
// (ring, bars); the f32 form stages its weight chunks in wc. head: the
// whole-model form's pool head (gl, rows, gstart, and the head's outputs,
// partials and CSR cursor in a); the one-layer form has none. runs: the ELL
// walk's lane runs (lo).
struct Smem {
  size_t h, a, wc, aux, gl, rows, gstart, lo, ring, bars, total;
};

inline Smem smem_layout(bool wg, bool head, bool runs, int d, int gmax, int tout, int stages) {
  const size_t D = d;
  const lw::Geom lg = lw::geom(2 * d, post_n(d));
  // The channels (bf16 A layout, or f32 rows of 2D + 1); after the layers
  // the head's outputs [kRows][T] and partials [gmax][T] and the CSR cursor,
  // or h' [kRows][D].
  size_t a = wg ? size_t(kRows) * lg.kp * 2 : size_t(kRows) * (2 * D + 1) * 4;
  if (head && (size_t(kRows) + gmax) * tout * 4 > a) a = (size_t(kRows) + gmax) * tout * 4;
  if (head && size_t(gmax) * 4 > a) a = size_t(gmax) * 4;
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(kRows * D * (wg ? 2 : 4));
  s.a = take(a);
  s.wc = take(wg ? 0 : size_t(kKC) * D * 4);
  s.aux = take(4 * kRows * 4);
  s.gl = take(head ? kRows * 4 : 0);
  s.rows = take(head ? kRows * 4 : 0);
  s.gstart = take(head ? (gmax + 1) * 4 : 0);
  s.lo = take(runs ? (kRows + 1) * 4 : 0);
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

// h and the channels in shared memory: float, or bf16 for the wgmma form.
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename S> __device__ __forceinline__ S store(float x);
template <> __device__ __forceinline__ float store<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rnd(h + relu(y + b)), in the plain version's order.
template <typename T>
__device__ __forceinline__ float dgn_update(float h, float y, float b) {
  return rnd<T>(__fadd_rn(h, fmaxf(__fadd_rn(y, b), 0.f)));
}

// N = 0: the float32 form (FMA posttrans); N = 104 or 112: the bf16 form
// with the wgmma posttrans of that width. tiles: the bf16 form's packed
// weight chunks (linear_wgmma.cuh), all layers in order. kLayer: the
// one-layer form, which adds m_spill (null: no spill tail) to the channels
// and writes h' to h_out (pool_gl, mlp1_w and out unused); otherwise the
// whole model with its pool head into out. Walk: SlotWalk or EllWalk, the
// sources of each row. lay: the shared-memory carve-up, computed once on
// the host (smem_layout).
template <typename T, int N, bool kLayer, typename Walk>
__global__ void __launch_bounds__(kThreads, N > 0 ? 2 : 1)
dgn_model_kernel(Walk walk, const T* __restrict__ h0,
                 const T* __restrict__ eig, const T* __restrict__ invd,
                 const T* __restrict__ ews, const T* __restrict__ inva,
                 const T* __restrict__ w_all, const T* __restrict__ b_all,
                 const int* __restrict__ pool_gl, const T* __restrict__ mlp1_w,
                 const T* __restrict__ m_spill, const unsigned char* __restrict__ tiles,
                 float* __restrict__ out, T* __restrict__ h_out, Dims dm, Smem lay) {
  constexpr bool kWg = N > 0;
  using S = T;  // h in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const int W = dm.window, D = dm.d, tid = threadIdx.x;
  const int K2 = 2 * D, AP = K2 + 1;  // f32 channel rows: 2D + 1 floats
  S* h_s = reinterpret_cast<S*>(smem + lay.h);     // [kRows][D] this block's rows of h
  unsigned char* a_raw = smem + lay.a;             // channels: bf16 [K'/8][kRows][8], f32
                                                   // [kRows][2D+1]; head; CSR cursor; h'
  float* wc_s = reinterpret_cast<float*>(smem + lay.wc);      // f32: [kKC][D] a weight chunk
  float* eig_s = reinterpret_cast<float*>(smem + lay.aux);    // [kRows] eig, then invd,
  float* invd_s = eig_s + kRows;                              // ews and inva
  float* ews_s = invd_s + kRows;
  float* inva_s = ews_s + kRows;
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] the ELL walk's runs
  // The layer's output: h in place, or h' staged over the channels.
  S* hn_s = kLayer ? reinterpret_cast<S*>(a_raw) : h_s;       // [kRows][D]
  const lw::Geom lg = lw::geom(K2, kWg ? N : 8);
  const lw::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                      dm.stages, dm.layers * lg.chunks, lg.chunk_bytes};
  const bool do_post = !(dm.knockout & kNoProduct), do_chan = !(dm.knockout & kNoChannels);

  const long wrow0 = long(win) * W;               // the window's first row
  const long row0 = wrow0 + long(rank) * kRows;   // this block's first row
  if constexpr (kWg) {
    if (tid == 0 && do_post) ring.init();
    // The channels' pad columns stay zero; the channels write columns < 2D.
    __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(a_raw);
    const int pad = lg.kp - K2;
    for (int i = tid; i < kRows * pad; i += kThreads)
      a[lw::a_index(i / pad, K2 + i % pad)] = __float2bfloat16_rn(0.f);
  }
  if (!do_chan) {  // timing only: the posttrans reads defined channels
    const int words = int((kWg ? size_t(kRows) * lg.kp * 2 : size_t(kRows) * AP * 4) / 4);
    for (int i = tid; i < words; i += kThreads) reinterpret_cast<float*>(a_raw)[i] = 0.f;
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = store<S>(row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const bool real = row0 + r < dm.n;
    eig_s[r] = real ? ld(eig + row0 + r) : 0.f;
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    ews_s[r] = real ? ld(ews + row0 + r) : 0.f;
    inva_s[r] = real ? ld(inva + row0 + r) : 0.f;
    if constexpr (!kLayer) gl_s[r] = pool_gl[row0 + r];
  }
  if (do_chan) walk.prepare(win, rank, tid, lo_s);
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0 && do_post) ring.prefetch();  // the first S weight chunks, while the layers set up
  }
  if constexpr (!kLayer) {
    if (tid == 0) {
      // Group the block's rows by graph (ascending row order within a graph):
      // the readout then sums each graph's rows in a fixed order.
      int* cursor = reinterpret_cast<int*>(a_raw);
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
  }

  // The two channels of the block's row r (its sources `first`, as
  // walk.fetch gives them), rounded to T, handed to put(col, value) for col =
  // part·D + c: one warp per row, lane j holding columns j, j + 32, ... of h.
  const int warp = tid / 32, lane = tid % 32;
  auto channels_row = [&](int r, const Fetched& first, auto&& put) {
    float m1[kLaneD], m2[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) { m1[j] = 0.f; m2[j] = 0.f; }
    walk.visit(first, win, W, dm.n, [&](const int (&u)[kBatch]) {
      // kBatch sources' rows of h (and e_u) in flight, then their sums in order.
      float x[kBatch][kLaneD], eu[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        eu[b] = 0.f;
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) x[b][j] = 0.f;
        if (u[b] < 0) continue;
        const int owner = u[b] / kRows, ur = u[b] - owner * kRows;
        const S* hb = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
        const float* eb = owner == rank ? eig_s : cluster.map_shared_rank(eig_s, owner);
        eu[b] = eb[ur];
#pragma unroll
        for (int j = 0; j < kLaneD; ++j)
          if (lane + 32 * j < D) x[b][j] = val(hb[ur * D + lane + 32 * j]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (u[b] < 0) continue;
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) {
          if (lane + 32 * j >= D) break;
          const float e = __fmul_rn(eu[b], x[b][j]);
          m1[j] = __fadd_rn(m1[j], x[b][j]);
          m2[j] = __fadd_rn(m2[j], Walk::kRoundLane ? rnd<T>(e) : e);
        }
      }
    });
    const float ev = eig_s[r], iv = invd_s[r], ew = ews_s[r], ia = inva_s[r];
    // The spill tail's channels of a real row (one-layer form only).
    const T* sp = kLayer && m_spill != nullptr && row0 + r < dm.n ? m_spill + (row0 + r) * K2
                                                                    : nullptr;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int d = lane + 32 * j;
      if (d >= D) break;
      float m1v = m1[j];
      float m2v = __fsub_rn(m2[j], __fmul_rn(ev, m1v));
      if (sp != nullptr) {
        m1v = __fadd_rn(m1v, ld(sp + d));
        m2v = __fadd_rn(m2v, ld(sp + D + d));
      }
      const float dir = __fsub_rn(m2v, __fmul_rn(ew, val(h_s[r * D + d])));
      put(d, rnd<T>(__fmul_rn(m1v, iv)));
      put(D + d, rnd<T>(__fmul_rn(fabsf(dir), ia)));
    }
  };
  // The channels of every row of the block, a warp's rows in turn, each
  // row's first sources fetched while the row before it is summed.
  auto channels = [&](auto&& put_row) {
    Fetched next = walk.fetch(win, rank, warp, lo_s, lane, W, dm.n);
    for (int r = warp; r < kRows; r += kWarps) {
      const Fetched first = next;
      next = walk.fetch(win, rank, r + kWarps, lo_s, lane, W, dm.n);
      channels_row(r, first, [&](int col, float v) { put_row(r, col, v); });
    }
  };

  for (int l = 0; l < dm.layers; ++l) {
    // Every block's h is in place before any block gathers from it.
    cluster.sync();
    if constexpr (kWg) {
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(a_raw);
      if (do_chan)
        channels([&](int r, int col, float v) { a[lw::a_index(r, col)] = __float2bfloat16_rn(v); });
      fence_proxy_async();  // the channels, written here, are read by wgmma
    } else {
      float* a = reinterpret_cast<float*>(a_raw);
      if (do_chan) channels([&](int r, int col, float v) { a[r * AP + col] = v; });
    }
    if constexpr (kLayer) {
      __syncthreads();  // the channels are complete; h stays as it is
    } else {
      // No block reads this block's h any more; the channels are complete.
      cluster.sync();
    }

    const T* b_l = b_all + long(l) * D;
    if constexpr (kWg) {
      // Posttrans, bias, relu and residual: y = channels · w_l on the tensor
      // cores, the rest on the accumulators in registers.
      float y[N / 2];
      if (do_post) {
        lw::run<N>(y, reinterpret_cast<const __nv_bfloat16*>(a_raw), ring, l * lg.chunks,
                   lg.chunks, tid);
      } else {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) y[i] = 0.f;
      }
      if constexpr (kLayer) __syncthreads();  // both warpgroups' products have read the channels
      lw::for_each<N>(y, D, tid, [&](int r, int c, float v) {
        hn_s[r * D + c] = store<S>(dgn_update<T>(val(h_s[r * D + c]), v, ld(b_l + c)));
      });
    } else {
      // y[r][c] = sum_k a[r][k] . w_l[k][c], the weight streamed in chunks of
      // kKC input channels; then h = rnd(h + relu(y + b)) (in place, each
      // thread writing only the entries of h it reads; or into h').
      const T* w_l = w_all + long(l) * K2 * D;
      const float* a = reinterpret_cast<const float*>(a_raw);
      const int tr = tid / kTC, tc = tid % kTC;
      float acc[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
      for (int kc = 0; do_post && kc < K2; kc += kKC) {
        const int kn = K2 - kc < kKC ? K2 - kc : kKC;
        __syncthreads();  // the last chunk is consumed
        for (int i = tid; i < kn * D; i += kThreads) wc_s[i] = ld(w_l + long(kc) * D + i);
        __syncthreads();
        for (int kk = 0; kk < kn; ++kk) {
          float av[kRowsPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) av[i] = a[(tr + kTR * i) * AP + kc + kk];
          const float* wrow = wc_s + kk * D;
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            const float wv = c < D ? wrow[c] : 0.f;
#pragma unroll
            for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(av[i], wv, acc[i][m]);
          }
        }
      }
      if constexpr (kLayer) __syncthreads();  // every thread has read the channels
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = tr + kTR * i;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          if (c < D) hn_s[r * D + c] = store<S>(dgn_update<T>(val(h_s[r * D + c]), acc[i][m],
                                                              ld(b_l + c)));
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kLayer) {
    // h' out: the block's real rows, one contiguous run of h_out.
    const long rows = dm.n - row0 < kRows ? dm.n - row0 : kRows;
    for (long i = tid; i < rows * D; i += kThreads) h_out[row0 * D + i] = hn_s[i];
    cluster.sync();  // keep this block's h until no block of the cluster reads it
    return;
  }

  // Finalize: per-row head p = h . mlp1_w, this block's per-graph sums of p,
  // then the cluster's sums, each block writing a share of the outputs.
  float* p_s = reinterpret_cast<float*>(a_raw);  // [kRows][T]
  float* part_s = p_s + kRows * dm.tout;         // [gmax][T]
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(val(h_s[r * D + d]), ld(mlp1_w + d * dm.tout + t), s);
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

// Each form's kernel, by dtype code (0 = float32, 1 = bfloat16) and width.
template <bool kLayer, typename Walk, typename F>
cudaError_t with_kernel(int dtype, int d, F&& f) {
  if (dtype == 0) return f(dgn_model_kernel<float, 0, kLayer, Walk>, float{});
  if (dtype == 1 && post_n(d) == 104)
    return f(dgn_model_kernel<__nv_bfloat16, 104, kLayer, Walk>, __nv_bfloat16{});
  if (dtype == 1) return f(dgn_model_kernel<__nv_bfloat16, 112, kLayer, Walk>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

inline bool bad_geometry(int dtype, int window, int d, int layers, int stages) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || d < 1 ||
         d > kMaxD || layers < 1 ||
         (dtype == 1 && stages < lw::min_stages(lw::geom(2 * d, post_n(d)).chunks));
}

// The bf16 form's weight chunks at width d: K' (2d padded to whole chunks
// of 32), N (the product's width), the bytes of a chunk.
inline void posttrans_dims(int d, int* dims) {
  const lw::Geom g = lw::geom(2 * d, post_n(d));
  dims[0] = g.kp;
  dims[1] = post_n(d);
  dims[2] = g.chunk_bytes;
}

// Dynamic shared memory (bytes) of one block of the form.
template <bool kLayer, typename Walk>
size_t smem_bytes(int dtype, int d, int gmax, int tout, int stages) {
  return smem_layout(dtype == 1, !kLayer, Walk::kRuns, d, gmax, tout, stages).total;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
template <bool kLayer, typename Walk>
int occupancy(int dtype, int window, int d, int gmax, int tout, int stages, int device, int* out) {
  if (bad_geometry(dtype, window, d, 1, stages)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = smem_bytes<kLayer, Walk>(dtype, d, gmax, tout, stages);
  return int(with_kernel<kLayer, Walk>(dtype, d, [&](auto kernel, auto) {
    ClusterLaunch ln;
    const cudaError_t e = cluster_launch(kernel, ln, 1, window / kRows, kThreads, bytes, nullptr);
    return e != cudaSuccess ? e : cluster_occupancy(kernel, ln, kThreads, bytes, out);
  }));
}

// Checks the geometry and launches the form `dtype` names (0 = float32 with
// the FMA posttrans, 1 = bfloat16 with the wgmma posttrans, which needs
// `tiles`, the layers' posttrans chunks as posttrans_dims gives them, and a
// ring of at least two chunk buffers) over the rows' sources `walk`; the
// whole model writes `out`, the one-layer form `h_out` (m_spill: null, or
// its spill channels). Returns a cudaError_t.
template <bool kLayer, typename Walk>
int launch(int dtype, const Walk& walk, const void* h0, const void* eig, const void* invd,
           const void* ews, const void* inva, const void* w_all, const void* b_all,
           const void* pool_gl, const void* mlp1_w, const void* m_spill, const void* tiles,
           void* out, void* h_out, int num_windows, const Dims& dm, int device, void* stream) {
  if (num_windows < 1 || bad_geometry(dtype, dm.window, dm.d, dm.layers, dm.stages) ||
      (dtype == 1 && tiles == nullptr) || (kLayer && dm.layers != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Smem lay =
      smem_layout(dtype == 1, !kLayer, Walk::kRuns, dm.d, dm.gmax, dm.tout, dm.stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_kernel<kLayer, Walk>(dtype, dm.d, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    ClusterLaunch ln;
    cudaError_t e =
        cluster_launch(kernel, ln, num_windows, dm.window / kRows, kThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, walk, static_cast<const T*>(h0),
                           static_cast<const T*>(eig), static_cast<const T*>(invd),
                           static_cast<const T*>(ews), static_cast<const T*>(inva),
                           static_cast<const T*>(w_all), static_cast<const T*>(b_all),
                           static_cast<const int*>(pool_gl), static_cast<const T*>(mlp1_w),
                           static_cast<const T*>(m_spill),
                           static_cast<const unsigned char*>(tiles), static_cast<float*>(out),
                           static_cast<T*>(h_out), dm, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

}  // namespace dgn_model
