// The PNA slot kernel for Hopper (sm_90a), templated on its output: row 3
// (pna_local_model.cu, all L layers and the pool head in one launch) and
// row 20 (pna_local_layer_slots.cu, one layer that writes the next h to
// device memory) are its two instantiations; row 19
// (pna_local_stats_slots.cu) is its stats-only form, a kernel of its own
// (pna_stats_kernel, at the end of this file) on the same per-slot update
// (add_stats): the raw [s | q | mn | mx] in h's type, any D from 1 to 128.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; slot_src [NW*W, S] holds each row's
// in-window sources, sentinel W for an empty slot, and slot k counts only
// for rows below caps[k] (the TPU kernel's prefix-sliced gathers; the
// one-layer form takes every slot, caps[k] = W). pool_gl holds each row's
// window-local graph id, GMAX for padding rows (whole-model form only).
//
// Per layer, for window row v and its valid slot sources u:
//   s, q, mn, mx = sum, sum of squares, min and max of h_u, in slot order,
//                  mn seeded at min_init and mx at max_init (the ap_fixed
//                  extremes, so a row with no source keeps the seeds)
//   mean = s * invd_v, std = sqrt(max(q * invd_v - mean^2, 0))
//   y    = [rnd(mean) | rnd(mn) | rnd(mx) | rnd(std)] . w_l      [4D] -> [3D]
//   acc  = y[:D] + t_v * y[D:2D] + scale_v * y[2D:] + b_l
//   h    = rnd(h + relu(acc))
// and after the last layer the whole-model form pools h . mlp1_w
// (_pool_epilogue); the one-layer form writes h' [n, D] in h's type. The
// node terms arrive in h's type (the TPU kernels round them to it). q *
// invd - mean^2 is computed with __fmul_rn / __fsub_rn: a contracted FMA
// would leave a residual of ~1e-8 * x^2 where the plain version has exactly
// 0 (one in-edge), which the sqrt turns into ~1e-4 * |x|.
//
// What bounds it on this card: per 128 rows and layer the tower is
// 128*4D*3D multiply-adds (9.8 M at D=80), the largest dense product of any
// model, against S*128*D gathered values for the four aggregates; h is read
// once and GMAX*T floats (or h') written per window, so the kernel is bound
// on chip. A window of W = 128..1024 rows runs on a thread-block cluster of
// W/128 blocks (1 to 8), each owning 128 rows of h and of the next h (the
// TPU kernel's VMEM residency). A slot source in another block's rows is
// read from that block's shared memory (cluster.map_shared_rank); the slot
// lanes are read from device memory through L1, once per row. The stats run
// one warp per destination row with the lanes over D, in slot order, with no
// atomics. Each layer reads h and writes the next h, the two buffers
// swapping, so one cluster barrier per layer (after the next h is in place
// everywhere, before any block gathers from it or overwrites the buffer the
// others read) keeps the blocks in step. The whole-model form's readout pool
// of a graph that spans blocks is a per-block partial reduced across the
// cluster in rank order: deterministic, summed in another order than the
// plain version (the f32 comparisons allow 1e-4 of the output's scale). The
// one-layer form keeps two cluster barriers: the layer's (h is in place in
// every block before any block gathers from it) and one before a block
// exits (no block's shared memory may end while another still reads its h);
// the next h goes through shared memory and leaves as one contiguous run of
// the block's rows.
//
// The two forms run the tower differently:
// - bfloat16 on the tensor cores through linear_wgmma.cuh: h stays bf16 (it
//   is rounded every layer), the stats stage writes rnd(mean) | rnd(min) |
//   rnd(max) | rnd(std) straight into wgmma's A layout [4D'/8][128][8], and
//   one product [128, 4D] . [4D, 240] per layer (one m64n240k16 a K step,
//   scaler p's outputs at columns 80p + c) runs over all 128 rows, its
//   weights packed once on the host into chunks of 32 input channels and
//   streamed through a ring of bulk copies, every layer one sequence: read
//   from L2 once per layer and block, with no conversion and no block-wide
//   barrier per chunk. The scalers, bias and residual run on the
//   accumulators in registers. At D = 80: h and next h 41 KB, stats 82 KB,
//   partials 10 KB (whole model only), the ring S x 15.4 KB (the wrapper
//   takes the deepest that fits), one block an SM: the stats alone take
//   more than half of what two blocks could share;
// - float32 keeps register-tiled FMA (TF32 would break the f32 gate of
//   1e-4) over two row blocks of 64 rows, the weights staged in f32 chunks
//   of 32 input channels: ~207 KB at D = 80 (~194 KB in one layer).
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the tower's product (and the weight ring), bit 1 skips the stats; the
// phase split of chip_smoke.py times the kernel with each.
//
// Numerics follow the TPU kernels: activations, scalers and weights are
// float or bfloat16 (T); every product and sum is float32; the stats and the
// new h are rounded to T where the TPU kernels cast to their compute dtype.
// Against the plain version the f32 form differs in summation order only,
// the bf16 form also in the tensor cores' summation of the product's bf16
// terms: not bit-equal.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "linear_wgmma.cuh"

namespace pna_model {

namespace cg = cooperative_groups;
using namespace hopper;
namespace lw = linear_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kMaxD = 80;              // widest D either form's tile covers
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the stats
constexpr int kPitch = kMaxD;          // bf16 tower: scaler p's outputs at 80p + c
constexpr int kTowerN = 3 * kPitch;    // the bf16 tower's width (240)
constexpr int kTR = 16;                // thread rows of the f32 tower tile
constexpr int kTC = 16;                // thread columns of the f32 tower tile
constexpr int kRowsPT = 4;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per f32 stats / tower block (64)
constexpr int kColsPT = 5;             // output columns per thread and scaler
constexpr int kKC = 32;                // f32 tower input channels per weight chunk
constexpr int kMaxSlots = 8;
constexpr int kNoProduct = 1, kNoStats = 2;  // Dims::knockout bits

static_assert(kTC * kColsPT == kMaxD && kPitch % 8 == 0 && kTowerN <= 256, "tower tiles");
static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");

struct Dims {
  int n, window, d, layers, gmax, tout, slots, stages, knockout;
  float min_init, max_init;
};

struct Caps {
  int caps[kMaxSlots];
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and stats are bf16 and which holds the weight ring (ring,
// bars); the f32 form stages its weight chunks in wc. head: the
// whole-model form's pool head (gl, rows, gstart, part, and the head's
// outputs and CSR cursor in st); the one-layer form has none.
struct Smem {
  size_t h, hn, st, wc, aux, gl, rows, gstart, part, ring, bars, total;
};

inline Smem smem_layout(bool wg, bool head, int d, int gmax, int tout, int stages) {
  const size_t D = d;
  const lw::Geom lg = lw::geom(4 * d, kTowerN);
  size_t st = wg ? size_t(kRows) * lg.kp * 2 : size_t(kRB) * (4 * D + 1) * 4;  // stats
  if (head && size_t(kRows) * tout * 4 > st) st = size_t(kRows) * tout * 4;     // head outputs
  if (head && size_t(gmax) * 4 > st) st = size_t(gmax) * 4;                     // CSR cursor
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(kRows * D * (wg ? 2 : 4));
  s.hn = take(kRows * D * (wg ? 2 : 4));
  s.st = take(st);
  s.wc = take(wg ? 0 : size_t(kKC) * 3 * D * 4);
  s.aux = take(3 * kRows * 4);
  s.gl = take(head ? kRows * 4 : 0);
  s.rows = take(head ? kRows * 4 : 0);
  s.gstart = take(head ? (gmax + 1) * 4 : 0);
  s.part = take(head ? size_t(gmax) * tout * 4 : 0);
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

// h and the stats in shared memory: float, or bf16 for the wgmma form.
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename S> __device__ __forceinline__ S store(float x);
template <> __device__ __forceinline__ float store<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One source's value x of a column into the row's running stats, in the
// plain version's order: s += x, q += x·x, mn = min(mn, x), mx = max(mx, x).
// Rows 3, 20 and 19 share it.
__device__ __forceinline__ void add_stats(float& s, float& q, float& mn, float& mx, float x) {
  s = __fadd_rn(s, x);
  q = __fadd_rn(q, __fmul_rn(x, x));
  mn = fminf(mn, x);
  mx = fmaxf(mx, x);
}

// a = y0 + t·y1 + scale·y2 + b, then rnd(h + relu(a)), in the plain
// version's order.
template <typename T>
__device__ __forceinline__ float pna_update(float h, float y0, float y1, float y2, float t, float sc,
                                            float b) {
  float a = __fadd_rn(y0, __fmul_rn(t, y1));
  a = __fadd_rn(a, __fmul_rn(sc, y2));
  a = __fadd_rn(a, b);
  return rnd<T>(__fadd_rn(h, fmaxf(a, 0.f)));
}

// kWg: the bf16 form with the wgmma tower; tiles its packed weight chunks
// (linear_wgmma.cuh), all layers in order. kLayer: the one-layer form,
// which writes h' to h_out (pool_gl, mlp1_w and out unused); otherwise the
// whole model with its pool head into out (h_out unused). lay: the
// shared-memory carve-up, computed once on the host (smem_layout).
template <typename T, bool kWg, bool kLayer>
__global__ void __launch_bounds__(kThreads)
pna_model_kernel(const int* __restrict__ slot_src, const T* __restrict__ h0,
                 const T* __restrict__ invd, const T* __restrict__ tdeg,
                 const T* __restrict__ scale, const T* __restrict__ w_all,
                 const T* __restrict__ b_all, const int* __restrict__ pool_gl,
                 const T* __restrict__ mlp1_w, const unsigned char* __restrict__ tiles,
                 float* __restrict__ out, T* __restrict__ h_out, Dims dm, Caps cp, Smem lay) {
  using S = T;  // h in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const int W = dm.window, D = dm.d, NS = dm.slots, tid = threadIdx.x;
  const int K4 = 4 * D, N3 = 3 * D, SP = K4 + 1;
  S* h_s = reinterpret_cast<S*>(smem + lay.h);     // [kRows][D] this block's rows of h
  S* hn_s = reinterpret_cast<S*>(smem + lay.hn);   // [kRows][D] the next h
  unsigned char* st_raw = smem + lay.st;           // stats: bf16 [4D'/8][kRows][8], f32
                                                   // [kRB][4D+1]; head outputs; CSR cursor
  float* wc_s = reinterpret_cast<float*>(smem + lay.wc);      // f32: [kKC][3D] a weight chunk
  float* invd_s = reinterpret_cast<float*>(smem + lay.aux);   // [kRows] 1/max(in_deg, 1),
  float* t_s = invd_s + kRows;                                // then t and scale
  float* sc_s = t_s + kRows;
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // [gmax][T] readout partials
  const lw::Geom lg = lw::geom(K4, kTowerN);
  const lw::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                      dm.stages, dm.layers * lg.chunks, lg.chunk_bytes};
  const bool do_tower = !(dm.knockout & kNoProduct), do_stats = !(dm.knockout & kNoStats);

  const long wrow0 = long(win) * W;               // the window's first row
  const long row0 = wrow0 + long(rank) * kRows;   // this block's first row
  if constexpr (kWg) {
    if (tid == 0 && do_tower) ring.init();
    // The stats' pad columns stay zero; the stats stage writes columns < 4D.
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(st_raw);
    const int pad = lg.kp - K4;
    for (int i = tid; i < kRows * pad; i += kThreads)
      st[lw::a_index(i / pad, K4 + i % pad)] = __float2bfloat16_rn(0.f);
  }
  if (!do_stats) {  // timing only: the tower reads defined stats
    const int words = int((kWg ? size_t(kRows) * lg.kp * 2 : size_t(kRB) * SP * 4) / 4);
    for (int i = tid; i < words; i += kThreads) reinterpret_cast<float*>(st_raw)[i] = 0.f;
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = store<S>(row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const bool real = row0 + r < dm.n;
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    t_s[r] = real ? ld(tdeg + row0 + r) : 0.f;
    sc_s[r] = real ? ld(scale + row0 + r) : 0.f;
    if constexpr (!kLayer) gl_s[r] = pool_gl[row0 + r];
  }
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0 && do_tower) ring.prefetch();  // the first S weight chunks, while the layers set up
  }
  if constexpr (!kLayer) {
    if (tid == 0) {
      // Group the block's rows by graph (ascending row order within a graph):
      // the readout then sums each graph's rows in a fixed order.
      int* cursor = reinterpret_cast<int*>(st_raw);
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

  // The four aggregates of the block's row r (mean, min, max, std), rounded
  // to T, handed to put(col, value) for col = part·D + c: one warp per row,
  // lane j holding columns j, j + 32, ... of h.
  const int warp = tid / 32, lane = tid % 32;
  auto stats_row = [&](int r, auto&& put) {
    float s[kLaneD], q[kLaneD], mn[kLaneD], mx[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      s[j] = 0.f; q[j] = 0.f; mn[j] = dm.min_init; mx[j] = dm.max_init;
    }
    const int wr = rank * kRows + r;  // the window row
    for (int k = 0; k < NS; ++k) {
      if (wr >= cp.caps[k]) continue;  // a slot beyond its prefix cap counts for nothing
      const int src = __ldg(slot_src + (wrow0 + wr) * NS + k);
      if (unsigned(src) >= unsigned(W)) continue;  // empty slot
      const int owner = src / kRows;
      const S* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
      const S* hu = base + (src - owner * kRows) * D;
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int d = lane + 32 * j;
        if (d >= D) break;
        add_stats(s[j], q[j], mn[j], mx[j], val(hu[d]));
      }
    }
    const float inv = invd_s[r];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int d = lane + 32 * j;
      if (d >= D) break;
      const float mean = __fmul_rn(s[j], inv);
      const float var = __fsub_rn(__fmul_rn(q[j], inv), __fmul_rn(mean, mean));
      put(d, rnd<T>(mean));
      put(D + d, rnd<T>(mn[j]));
      put(2 * D + d, rnd<T>(mx[j]));
      put(3 * D + d, rnd<T>(sqrtf(fmaxf(var, 0.f))));
    }
  };

  for (int l = 0; l < dm.layers; ++l) {
    // Every block's h is in place, and no block still reads the buffer this
    // layer's next h overwrites.
    cluster.sync();
    const T* b_l = b_all + long(l) * D;
    if constexpr (kWg) {
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(st_raw);
      for (int r = warp; do_stats && r < kRows; r += kWarps)
        stats_row(r, [&](int col, float v) { st[lw::a_index(r, col)] = __float2bfloat16_rn(v); });
      fence_proxy_async();  // the stats, written here, are read by wgmma
      __syncthreads();
      // Tower, scalers, bias and residual: y = stats · w_l on the tensor
      // cores, the rest on the accumulators in registers.
      float y[kTowerN / 2];
      if (do_tower) {
        lw::run<kTowerN>(y, st, ring, l * lg.chunks, lg.chunks, tid);
      } else {
#pragma unroll
        for (int i = 0; i < kTowerN / 2; ++i) y[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPitch / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = lw::acc_row(tid, e), c = lw::acc_col(tid, j, e);
          if (c >= D) continue;
          constexpr int kNext = kPitch / 2;  // accumulators between scalers' columns
          hn_s[r * D + c] = store<S>(pna_update<T>(val(h_s[r * D + c]), y[4 * j + e],
                                                   y[4 * j + e + kNext], y[4 * j + e + 2 * kNext],
                                                   t_s[r], sc_s[r], ld(b_l + c)));
        }
    } else {
      const T* w_l = w_all + long(l) * K4 * N3;
      float* st = reinterpret_cast<float*>(st_raw);
      const int tr = tid / kTC, tc = tid % kTC;
      for (int rb = 0; rb < kRows; rb += kRB) {
        __syncthreads();  // st and wc are free
        for (int rl = warp; do_stats && rl < kRB; rl += kWarps)
          stats_row(rb + rl, [&](int col, float v) { st[rl * SP + col] = v; });

        // Tower: y[r][p*D + c] = sum_k st[r][k] . w_l[k][p*D + c], the weight
        // streamed in chunks of kKC input channels.
        float acc[kRowsPT][3][kColsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int m = 0; m < kColsPT; ++m) acc[i][p][m] = 0.f;
        for (int kc = 0; do_tower && kc < K4; kc += kKC) {
          const int kn = K4 - kc < kKC ? K4 - kc : kKC;
          __syncthreads();  // the stats are written; the last chunk is consumed
          for (int i = tid; i < kn * N3; i += kThreads) wc_s[i] = ld(w_l + long(kc) * N3 + i);
          __syncthreads();
          for (int kk = 0; kk < kn; ++kk) {
            float a[kRowsPT];
#pragma unroll
            for (int i = 0; i < kRowsPT; ++i) a[i] = st[(tr + kTR * i) * SP + kc + kk];
            const float* wrow = wc_s + kk * N3;
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int m = 0; m < kColsPT; ++m) {
                const int c = tc + kTC * m;
                const float wv = c < D ? wrow[p * D + c] : 0.f;
#pragma unroll
                for (int i = 0; i < kRowsPT; ++i) acc[i][p][m] = fmaf(a[i], wv, acc[i][p][m]);
              }
          }
        }

        // Scalers, bias and residual into the next h.
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const int r = rb + tr + kTR * i;
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            if (c >= D) continue;
            hn_s[r * D + c] = store<S>(pna_update<T>(val(h_s[r * D + c]), acc[i][0][m],
                                                     acc[i][1][m], acc[i][2][m], t_s[r], sc_s[r],
                                                     ld(b_l + c)));
          }
        }
      }
    }
    S* tmp = h_s;
    h_s = hn_s;
    hn_s = tmp;
  }
  __syncthreads();

  if constexpr (kLayer) {
    // h' out: the block's real rows, one contiguous run of h_out.
    const long rows = dm.n - row0 < kRows ? dm.n - row0 : kRows;
    for (long i = tid; i < rows * D; i += kThreads) h_out[row0 * D + i] = h_s[i];
    cluster.sync();  // keep this block's h until no block of the cluster reads it
    return;
  }

  // Finalize: per-row head p = h . mlp1_w, this block's per-graph sums of p,
  // then the cluster's sums, each block writing a share of the outputs.
  float* p_s = reinterpret_cast<float*>(st_raw);  // [kRows][T]
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

// Each form's kernel, by dtype code (0 = float32, 1 = bfloat16).
template <bool kLayer, typename F>
cudaError_t with_kernel(int dtype, F&& f) {
  if (dtype == 0) return f(pna_model_kernel<float, false, kLayer>, float{});
  if (dtype == 1) return f(pna_model_kernel<__nv_bfloat16, true, kLayer>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

inline bool bad_geometry(int dtype, int window, int d, int layers, int stages) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || d < 1 ||
         d > kMaxD || layers < 1 ||
         (dtype == 1 && stages < lw::min_stages(lw::geom(4 * d, kTowerN).chunks));
}

// The bf16 form's weight chunks at width d: K' (4d padded to whole chunks
// of 32), N (the tower's width, three scalers at a pitch of 80), the bytes of
// a chunk.
inline void tower_dims(int d, int* dims) {
  const lw::Geom g = lw::geom(4 * d, kTowerN);
  dims[0] = g.kp;
  dims[1] = kTowerN;
  dims[2] = g.chunk_bytes;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
template <bool kLayer>
int occupancy(int dtype, int window, int d, int gmax, int tout, int stages, int device, int* out) {
  if (bad_geometry(dtype, window, d, 1, stages)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = smem_layout(dtype == 1, !kLayer, d, gmax, tout, stages).total;
  return int(with_kernel<kLayer>(dtype, [&](auto kernel, auto) {
    ClusterLaunch ln;
    const cudaError_t e = cluster_launch(kernel, ln, 1, window / kRows, kThreads, bytes, nullptr);
    return e != cudaSuccess ? e : cluster_occupancy(kernel, ln, kThreads, bytes, out);
  }));
}

// Checks the geometry and launches the form `dtype` names (0 = float32 with
// the FMA tower, 1 = bfloat16 with the wgmma tower, which needs `tiles`, the
// layers' tower chunks as tower_dims gives them, and a ring of at least two
// chunk buffers); the whole model writes `out`, the one-layer form `h_out`.
// Every cap must be at most the window. Returns a cudaError_t.
template <bool kLayer>
int launch(int dtype, const void* slot_src, const void* h0, const void* invd, const void* tdeg,
           const void* scale, const void* w_all, const void* b_all, const void* pool_gl,
           const void* mlp1_w, const void* tiles, void* out, void* h_out, int num_windows,
           const Dims& dm, const int* caps, int device, void* stream) {
  if (dm.slots < 1 || dm.slots > kMaxSlots || num_windows < 1 ||
      bad_geometry(dtype, dm.window, dm.d, dm.layers, dm.stages) ||
      (dtype == 1 && tiles == nullptr) || (kLayer && dm.layers != 1))
    return int(cudaErrorInvalidValue);
  Caps cp{};
  for (int k = 0; k < dm.slots; ++k) {
    if (caps[k] < 0 || caps[k] > dm.window) return int(cudaErrorInvalidValue);
    cp.caps[k] = caps[k];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Smem lay = smem_layout(dtype == 1, !kLayer, dm.d, dm.gmax, dm.tout, dm.stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_kernel<kLayer>(dtype, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    ClusterLaunch ln;
    cudaError_t e =
        cluster_launch(kernel, ln, num_windows, dm.window / kRows, kThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, static_cast<const int*>(slot_src),
                           static_cast<const T*>(h0), static_cast<const T*>(invd),
                           static_cast<const T*>(tdeg), static_cast<const T*>(scale),
                           static_cast<const T*>(w_all), static_cast<const T*>(b_all),
                           static_cast<const int*>(pool_gl), static_cast<const T*>(mlp1_w),
                           static_cast<const unsigned char*>(tiles), static_cast<float*>(out),
                           static_cast<T*>(h_out), dm, cp, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

// ---------------------------------------------------------------------------
// The stats-only form (row 19, pna_local_stats_slots.cu): the stats stage of
// row 20's layer with the raw running stats written out in place of the mean
// / std epilogue and the tower, for the caller to merge a spill tail. Per
// window row v, over its valid slots (every slot counted, caps = W) in slot
// order,
//   s, q, mn, mx = sum, sum of squares, min and max of h_u   (f32, add_stats)
// mn seeded at min_init and mx at max_init; out [n, 4D] = [s | q | mn | mx]
// in h's type. An empty slot (sentinel W) changes nothing, so a row with no
// source keeps the seeds; a source on a padding row reads zeros. A window of
// W = 128..1024 rows runs on a cluster of W/128 blocks of kStatsThreads
// threads; each block stages its 128 rows of h (in h's type, as one
// contiguous run of 16-byte cp.async copies) and of slot_src in shared
// memory, and a source in another block's rows is read through
// cluster.map_shared_rank. It has no product, so it takes any D from 1 to
// 128: h is kept at an even row stride (an odd D pads one zero column), so
// every column pair is one aligned load. A half-warp takes a row (two rows a
// warp at once), each thread kStatsPairs column pairs; a row's <= 8 slots
// are loaded at once, one a thread, packed by one ballot and handed round by
// shuffles. At D = 80 in bf16 a block holds h 20.5 KB and its slot table
// 4 KB (S = 8). The carve-up (stats_smem_layout) is computed on the host and
// passed in.
//
// What bounds it: the writes. At D = 80 in bf16 a row reads 160 B of h and
// 32 B of slot table once and writes 640 B of stats; the arithmetic is 5
// operations a valid slot and column. The stats leave as column pairs
// straight from the registers: staging 32 rows at a time in shared memory to
// write them as one run of 16-byte stores took 16-18% longer on an H100 80GB
// HBM3 at 700 W (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 512;  // threads a block of the stats-only form
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStatsGroup = 16;     // threads a row
constexpr int kStatsPairs = 4;      // column pairs a thread
constexpr int kStatsMaxD = 2 * kStatsGroup * kStatsPairs;  // widest D (128)

struct StatsDims {
  int n, window, d, slots, knockout;
  float min_init, max_init;
};

// The stats-only form's shared-memory carve-up, byte offsets, and the row
// stride (elements) of h.
struct StatsSmem {
  size_t h, src, total;
  int stride;
};

inline StatsSmem stats_smem_layout(bool bf16, int d, int slots) {
  StatsSmem s;
  s.stride = d + (d & 1);
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(size_t(kRows) * s.stride * (bf16 ? 2 : 4));
  s.src = take(size_t(kRows) * slots * 4);
  s.total = o;
  return s;
}

// out [n, 4D]: the stats for every real row. StatsDims::knockout bit 1
// (kNoStats) skips the stats and writes zeros (timing only).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads, 2)
pna_stats_kernel(const int* __restrict__ slot_src, const T* __restrict__ h, T* __restrict__ out,
                 StatsDims dm, StatsSmem lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / int(cluster.num_blocks());
  const int W = dm.window, D = dm.d, S = dm.slots, P = lay.stride, tid = threadIdx.x;
  T* h_s = reinterpret_cast<T*>(smem + lay.h);          // [kRows][P] this block's rows
  int* src_s = reinterpret_cast<int*>(smem + lay.src);  // [kRows][S] their slots
  const long wrow0 = long(win) * W;
  const long row0 = wrow0 + long(rank) * kRows;
  const int rows = dm.n - row0 < kRows ? int(dm.n - row0) : kRows;  // real rows (may be <= 0)
  const bool do_stats = !(dm.knockout & kNoStats);

  stage_rows<kStatsThreads>(h_s, h + row0 * D, rows, kRows, D, P, tid);
  stage_rows<kStatsThreads>(src_s, slot_src + row0 * S, kRows, kRows, S, S, tid);
  cp_async_wait_all();
  // Every block's h is in place before any block gathers from it.
  cluster.sync();

  // A half-warp a row: rows r and r + 1 of a step go to the warp's two halves.
  const int lane = tid % 32, hl = lane % kStatsGroup, half = lane / kStatsGroup;
  const int base = half * kStatsGroup;
  const float mn0 = do_stats ? dm.min_init : 0.f, mx0 = do_stats ? dm.max_init : 0.f;
  for (int rb = 2 * (tid / 32); rb < rows; rb += 2 * kStatsWarps) {
    const int r = rb + half;
    const bool live = r < rows;
    float2 st[4][kStatsPairs];  // s, q, mn, mx
#pragma unroll
    for (int j = 0; j < kStatsPairs; ++j) {
      st[0][j] = make_float2(0.f, 0.f);
      st[1][j] = make_float2(0.f, 0.f);
      st[2][j] = make_float2(mn0, mn0);
      st[3][j] = make_float2(mx0, mx0);
    }
    // The row's slots, one a thread of the first S; one ballot over the warp
    // finds each half's valid ones, and thread t keeps the t-th of them.
    int u = W;
    if (live && do_stats && hl < S) u = src_s[r * S + hl];
    const unsigned valid =
        (__ballot_sync(0xffffffffu, unsigned(u) < unsigned(W)) >> base) & 0xffffu;
    unsigned m = valid;  // drop the hl lowest: the hl-th valid slot is the lowest left
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i)
      if (i < hl) m &= m - 1;
    const int mine = __shfl_sync(0xffffffffu, u, base + (m ? __ffs(m) - 1 : 0));
    const int count = __popc(valid);
    // The two halves walk max(count) slots together (shuffles need the whole warp).
    const int most = max(count, __shfl_xor_sync(0xffffffffu, count, kStatsGroup));
    for (int k = 0; k < most; ++k) {
      const int v = __shfl_sync(0xffffffffu, mine, base + k);
      if (k >= count) continue;
      const int owner = v / kRows, vr = v - owner * kRows;
      const T* hb = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
      const T* hv = hb + vr * P;
#pragma unroll
      for (int j = 0; j < kStatsPairs; ++j) {
        const int c = 2 * (hl + kStatsGroup * j);
        if (c >= D) break;
        const float2 x = ld2(hv + c);
        add_stats(st[0][j].x, st[1][j].x, st[2][j].x, st[3][j].x, x.x);
        add_stats(st[0][j].y, st[1][j].y, st[2][j].y, st[3][j].y, x.y);
      }
    }
    if (!live) continue;
    T* o = out + (row0 + r) * 4 * D;  // the row's four parts as column pairs
#pragma unroll
    for (int j = 0; j < kStatsPairs; ++j) {
      const int c = 2 * (hl + kStatsGroup * j);
      if (c >= D) break;
#pragma unroll
      for (int part = 0; part < 4; ++part)
        st_pair(o + part * D, c, D, st[part][j].x, st[part][j].y);
    }
  }
  cluster.sync();  // keep this block's h until no block of the cluster reads it
}

inline bool bad_stats_geometry(int window, int d, int slots) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || d < 1 ||
         d > kStatsMaxD || slots < 1 || slots > kMaxSlots;
}

// The stats-only form's kernel by dtype code (0 = float32, 1 = bfloat16).
template <typename F>
cudaError_t with_stats_kernel(int dtype, F&& f) {
  if (dtype == 0) return f(pna_stats_kernel<float>, float{});
  if (dtype == 1) return f(pna_stats_kernel<__nv_bfloat16>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// What the occupancy calculator says of the stats-only form: out[0] the
// blocks that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
inline int stats_occupancy(int dtype, int window, int d, int slots, int device, int* out) {
  if (bad_stats_geometry(window, d, slots)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = stats_smem_layout(dtype == 1, d, slots).total;
  return int(with_stats_kernel(dtype, [&](auto kernel, auto) {
    ClusterLaunch ln;
    const cudaError_t e =
        cluster_launch(kernel, ln, 1, window / kRows, kStatsThreads, bytes, nullptr);
    return e != cudaSuccess ? e : cluster_occupancy(kernel, ln, kStatsThreads, bytes, out);
  }));
}

// Checks the geometry and launches the stats-only form. Returns a
// cudaError_t.
inline int launch_stats(int dtype, const void* slot_src, const void* h, void* out,
                        int num_windows, const StatsDims& dm, int device, void* stream) {
  if (bad_stats_geometry(dm.window, dm.d, dm.slots) || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const StatsSmem lay = stats_smem_layout(dtype == 1, dm.d, dm.slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_stats_kernel(dtype, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    ClusterLaunch ln;
    cudaError_t e =
        cluster_launch(kernel, ln, num_windows, dm.window / kRows, kStatsThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, static_cast<const int*>(slot_src),
                           static_cast<const T*>(h), static_cast<T*>(out), dm, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

}  // namespace pna_model
