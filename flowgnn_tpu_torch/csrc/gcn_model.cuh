// The GCN kernel for Hopper (sm_90a), templated on its output and on its
// message stage: row 9 (gcn_local_model.cu, the k = 1 ELL layout) and row 2
// (gcn_local_model_slots.cu, the degree-sorted slot layout) are its
// whole-model instantiations, with output [NW*GMAX, T] float32 per-window
// pool sums of the prediction head, for all L GCN layers after the conv-0
// matmul plus the finalize, in one launch; row 15 (gcn_local_layer_ell.cu,
// the ELL layout with any k edge blocks a window, no spill tail) is its
// one-layer form, with output h' [n, D] in h's type: the next conv's output
// rnd(rnd(relu(x)) . w_next + b_next), or on the last layer (no w_next)
// rnd(x); row 14 (gcn_local_message_ell.cu, the ELL layout, any k) is its
// messages-only form, a kernel of its own (gcn_messages_kernel, at the end of
// this file) on the same message arithmetic (add_message): m = rnd(acc *
// dis_v) in h's type, any D from 1 to 128.
//
// Per layer l, for window row v and its lanes u -> v:
//   msg = rnd(dis_u * relu(h_u + ee_l))        ee_l: three bond-table rows
//   acc = sum of msg over v's lanes, in lane order
//   a   = acc * dis_v + relu(h_v + root_l) * dis_v^2
//   x   = alpha_l * a + beta_l                 (BatchNorm folded on the host)
// then h = rnd(rnd(relu(x)) . wn_l + bn_l) between layers, and after the last
// layer the head pools rnd(x) . pred_w (no relu; _pool_epilogue). The
// one-layer form runs layer l = 0 of its operands and writes h' out.
//
// The message stage (the template parameter Msg, one of lanes.cuh's walks)
// calls f(u, a1, a2, a3) for each lane of a block row in the layout's order;
// a lane whose u lies outside the window has dis_u = 0 (no message), and the
// slot walk skips an empty lane.
//
// What bounds it on this card: per 128 rows and layer the next conv is
// 128*D*D multiply-adds (1.28 M at D=100) against ~1.5 lanes per row of
// D-wide gathers; device-memory traffic is small, so the kernel is bound on
// chip (arithmetic, shared-memory traffic, barriers). A window of W = 128..1024
// rows runs on a thread-block cluster of W/128 blocks, each owning 128 rows
// (h and the conv input x). A source in another block's rows is read from
// that block's shared memory (cluster.map_shared_rank); dis_u,
// layer-invariant, is read from device memory (L1 / L2). The messages run
// one warp per destination row and each lane a pair of adjacent columns,
// summed in the layout's lane order, with no atomics. The cluster
// synchronises per layer after the layer's h is in place and again after
// the messages, before any block overwrites its h. The readout pool of a
// graph that spans blocks is a per-block partial reduced across the cluster
// in rank order through distributed shared memory: deterministic, and
// summed in another order than the plain version, which the f32
// comparisons allow for at 1e-4 of the output's scale. The one-layer form
// keeps h as it is: it stages h' in the conv input's buffer once the conv
// has read it and writes it out as the block's contiguous run of rows (the
// last layer writes rnd(x) straight from the messages), so its two cluster
// barriers are the layer's first (h is in place before any gather) and one
// before a block exits (no block's shared memory may end while another
// still reads its h).
//
// The two forms run the next conv differently:
// - bfloat16 (N = 104 or 112, the product's width) on the tensor cores
//   through linear_wgmma.cuh: h and x stay bf16 in shared memory (both are
//   rounded to bf16 anyway), the messages write x straight into wgmma's A
//   layout, and the (L-1) D x D weight sets, packed once on the host into
//   chunks of 32 input channels, stream through a ring of bulk copies, all
//   layers one sequence: the first S chunks are prefetched before the first
//   layer and each buffer is refilled as soon as the product is done with
//   it, so layer l+1's weights land during layer l. At D = 100 a block holds
//   h 25.6 KB, x 32.8 KB, the bond table 5.2 KB, the ring S x 6.7 KB and
//   ~4 KB of the rest: 94 KB at S = 4, two blocks an SM (__launch_bounds__
//   keeps the registers at 128), so twice the clusters run at once;
// - float32 keeps register-tiled FMA (TF32 would break the f32 gate of
//   1e-4), wn_l staged per layer in f32: 151 KB, one block an SM.
// The one-layer form streams its one layer's chunks (the model's slice of
// every layer's, ops.local_layer.gcn_conv_tiles) through the same ring and
// has no pool head: 92 KB at D = 100 and S = 4 in bf16, two blocks an SM;
// in f32 it streams w_next through shared memory in chunks of kWC input
// channels, 113 KB at D = 100, two blocks an SM too (one at D = 112).
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter (computed in the kernel, it cost row 8's f32
// form 10-17%: PERF.md).
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the next conv (and the weight ring), bit 1 skips the messages; the phase
// split of chip_smoke.py times the kernel with each.
//
// Numerics follow the TPU kernels: activations, norms and weights are float
// or bfloat16 (T); every product and sum is float32; messages, the next
// conv's input, the new h and the head's input are rounded to T where the
// TPU kernels cast to their compute dtype.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "linear_wgmma.cuh"

namespace gcn_model {

namespace cg = cooperative_groups;
using namespace hopper;
namespace lw = linear_wgmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 conv tile
constexpr int kTC = 16;                // thread columns of the f32 conv tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneP = (kMaxD / 2 + 31) / 32;  // column pairs per lane in the messages
constexpr int kWC = 8;                 // f32 one-layer form: input channels per weight chunk
constexpr int kNoProduct = 1, kNoMessages = 2;  // Dims::knockout bits

static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");
static_assert(kRows == lanes::kRows && kThreads == lanes::kThreads, "the lane walk's block shape");

struct Dims {
  int n, window, d, layers, vocab, gmax, tout, stages, knockout;
};

// The bf16 form's product width at width d.
__host__ __device__ inline int conv_n(int d) { return d <= 104 ? 104 : 112; }

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and x are bf16 and which holds the weight ring (ring, bars);
// the f32 form stages wn_l in w.
// head: the whole-model form's pool head (part, gl, rows, gstart, and the
// head's outputs and CSR cursor in w); the one-layer form has none.
struct Smem {
  size_t h, x, w, part, tab, vec, dis, gl, rows, gstart, lo, ring, bars, total;
};

inline Smem smem_layout(bool wg, int d, int vocab, int gmax, int tout, int stages,
                        bool head = true) {
  const size_t D = d;
  const lw::Geom lg = lw::geom(d, conv_n(d));
  if (!head) gmax = tout = 0;
  size_t wbuf = wg ? 0 : (head ? D : size_t(kWC)) * D * 4;               // next-conv weights
  if (size_t(kRows) * tout * 4 > wbuf) wbuf = size_t(kRows) * tout * 4;  // head outputs
  if (size_t(gmax) * 4 > wbuf) wbuf = size_t(gmax) * 4;                  // CSR cursor
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(kRows * D * (wg ? 2 : 4));
  s.x = take(wg ? size_t(kRows) * lg.kp * 2 : kRows * D * 4);
  s.w = take(wbuf);
  s.part = take(size_t(gmax) * tout * 4);
  s.tab = take(size_t(vocab) * D * 4);
  s.vec = take(3 * D * 4);
  s.dis = take(kRows * 4);
  s.gl = take(head ? kRows * 4 : 0);
  s.rows = take(head ? kRows * 4 : 0);
  s.gstart = take(head ? (gmax + 1) * 4 : 0);
  s.lo = take((kRows + 1) * 4);
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

// h and x in shared memory: float, or bf16 for the wgmma form (columns c,
// c + 1 read and written as one pair by hopper.cuh's ld2 / st2).
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename S> __device__ __forceinline__ S store(float x);
template <> __device__ __forceinline__ float store<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The bond-table row `a` in shared memory, or null outside the vocabulary.
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab, int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

// One lane's message into a row's sums: thread j of the row's kGroup
// threads adds rnd(dis_u * relu(h_u + ee)) at its column pairs (2j, 2j + 1),
// (2j + 2 kGroup, 2j + 2 kGroup + 1), ... below d. hu and the bond rows
// e1..e3 (null: none) are read as column pairs, so their rows start at an
// even column; a pair that ends at column d reads one column past the row,
// which the caller pads.
template <typename T, int kGroup = 32, typename S, int kPairs>
__device__ __forceinline__ void add_message(float2 (&acc)[kPairs], const S* hu, float dis_u,
                                            const float* e1, const float* e2, const float* e3,
                                            int lane, int d) {
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int c = 2 * (lane + kGroup * j);
    if (c >= d) break;
    float2 ee = make_float2(0.f, 0.f);
    if (e1) { const float2 t = ld2(e1 + c); ee.x += t.x; ee.y += t.y; }
    if (e2) { const float2 t = ld2(e2 + c); ee.x += t.x; ee.y += t.y; }
    if (e3) { const float2 t = ld2(e3 + c); ee.x += t.x; ee.y += t.y; }
    const float2 hv = ld2(hu + c);
    acc[j].x += rnd<T>(__fmul_rn(dis_u, fmaxf(hv.x + ee.x, 0.f)));
    acc[j].y += rnd<T>(__fmul_rn(dis_u, fmaxf(hv.y + ee.y, 0.f)));
  }
}

// N = 0: the float32 form (FMA conv); N = 104 or 112: the bf16 form with the
// wgmma conv of that width. tiles: the bf16 form's packed weight chunks
// (linear_wgmma.cuh), layers 1..L-1 in order (the one-layer form: its next
// conv's). kLayer: the one-layer form (dm.layers = 1), which writes h' to
// h_out (pool_gl, predw and out unused; wn null: the last layer, no conv);
// otherwise the whole model with its pool head into out. lay: the
// shared-memory carve-up, computed once on the host (smem_layout).
template <typename T, int N, bool kLayer, typename Msg>
__global__ void __launch_bounds__(kThreads, N > 0 || kLayer ? 2 : 1)
gcn_model_kernel(Msg msg, const T* __restrict__ h0, const T* __restrict__ dis,
                 const int* __restrict__ pool_gl, const T* __restrict__ tab,
                 const T* __restrict__ roots, const T* __restrict__ alphas,
                 const T* __restrict__ betas, const T* __restrict__ wn,
                 const T* __restrict__ bn, const T* __restrict__ predw,
                 const unsigned char* __restrict__ tiles, float* __restrict__ out,
                 T* __restrict__ h_out, Dims dm, Smem lay) {
  constexpr bool kWg = N > 0;
  const bool final_layer = kLayer && wn == nullptr;  // the one-layer form's last layer
  using S = T;  // h and x in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const int D = dm.d, tid = threadIdx.x;
  S* h_s = reinterpret_cast<S*>(smem + lay.h);        // [kRows][D] this block's rows of h
  S* x_s = reinterpret_cast<S*>(smem + lay.x);        // the conv input: f32 [kRows][D],
                                                      // bf16 [K'/8][kRows][8]
  float* w_s = reinterpret_cast<float*>(smem + lay.w);        // f32 wn_l [in][out]; head; cursor
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // [gmax][T] readout partials
  float* tab_s = reinterpret_cast<float*>(smem + lay.tab);    // [vocab][D] this layer's bonds
  float* root_s = reinterpret_cast<float*>(smem + lay.vec);   // [D] root_l, alpha_l, beta_l
  float* alpha_s = root_s + D;
  float* beta_s = alpha_s + D;
  float* dis_s = reinterpret_cast<float*>(smem + lay.dis);    // [kRows]
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] the message stage's
  const lw::Geom lg = lw::geom(D, kWg ? N : 8);
  const lw::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                      dm.stages, (kLayer ? 1 : dm.layers - 1) * lg.chunks, lg.chunk_bytes};
  const bool do_conv = !(dm.knockout & kNoProduct) && !final_layer;
  const bool do_msg = !(dm.knockout & kNoMessages);
  // x's element (r, c): row-major, or the wgmma A layout.
  auto x_at = [&](int r, int c) { return kWg ? lw::a_index(r, c) : r * D + c; };

  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(rank) * kRows;

  if constexpr (kWg) {
    if (tid == 0 && do_conv) ring.init();
    // x's pad columns stay zero; the messages write columns < D only.
    const int pad = lg.kp - D;
    for (int i = tid; i < kRows * pad; i += kThreads) x_s[x_at(i / pad, D + i % pad)] = store<S>(0.f);
  }
  if (!do_msg)  // timing only: the conv reads a defined x
    for (int i = tid; i < kRows * D; i += kThreads) x_s[x_at(i / D, i % D)] = store<S>(0.f);
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = store<S>(row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    if constexpr (!kLayer) gl_s[r] = pool_gl[row0 + r];
    dis_s[r] = row0 + r < dm.n ? ld(dis + row0 + r) : 0.f;
  }
  msg.prepare(win, rank, tid, lo_s);
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0 && do_conv) ring.prefetch();  // the first S weight chunks, while the layers set up
  }
  if (!kLayer && tid == 0) {
    // Group the block's rows by graph (ascending row order within a graph):
    // the readout then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(w_s);
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
  for (int l = 0; l < dm.layers; ++l) {
    const bool last = kLayer ? final_layer : l == dm.layers - 1;
    // Every block's h is in place before any block gathers from it.
    cluster.sync();
    const T* tab_l = tab + long(l) * dm.vocab * D;
    for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab_l + i);
    for (int i = tid; i < D; i += kThreads) {
      root_s[i] = ld(roots + long(l) * D + i);
      alpha_s[i] = ld(alphas + long(l) * D + i);
      beta_s[i] = ld(betas + long(l) * D + i);
    }
    if constexpr (!kWg && !kLayer) {
      if (!last && do_conv) {
        const T* wn_l = wn + long(l) * D * D;
        for (int i = tid; i < D * D; i += kThreads) w_s[i] = ld(wn_l + i);
      }
    }
    __syncthreads();

    // Messages, one warp per destination row; lane j of the warp holds the
    // column pairs (2j, 2j + 1), (2j + 64, 2j + 65), ... of the row.
    for (int r = warp; do_msg && r < kRows; r += kWarps) {
      float2 acc[kLaneP];
#pragma unroll
      for (int j = 0; j < kLaneP; ++j) acc[j] = make_float2(0.f, 0.f);
      msg.visit(win, rank, r, lo_s, dm.window, [&](int u, int a1, int a2, int a3) {
        if (unsigned(u) >= unsigned(dm.window)) return;  // dis_u = 0: no message
        const float dis_u = wrow0 + u < dm.n ? ld(dis + wrow0 + u) : 0.f;
        const int owner = u / kRows;
        const S* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
        const S* hu = base + (u - owner * kRows) * D;
        add_message<T>(acc, hu, dis_u, bond_row(tab_s, a1, dm.vocab, D),
                       bond_row(tab_s, a2, dm.vocab, D), bond_row(tab_s, a3, dm.vocab, D), lane,
                       D);
      });
      const float dv = dis_s[r];
#pragma unroll
      for (int j = 0; j < kLaneP; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c >= D) break;
        const float2 hv = ld2(h_s + r * D + c);
        float xs[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float root = fmaxf((k ? hv.y : hv.x) + root_s[c + k], 0.f);
          const float a = __fadd_rn(__fmul_rn(k ? acc[j].y : acc[j].x, dv),
                                    __fmul_rn(root, __fmul_rn(dv, dv)));
          const float x = __fadd_rn(__fmul_rn(alpha_s[c + k], a), beta_s[c + k]);
          xs[k] = last ? rnd<T>(x) : rnd<T>(fmaxf(x, 0.f));
        }
        if (kLayer && last) {  // the one-layer form's last layer: rnd(x) out
          if (row0 + r < dm.n) st2(h_out + (row0 + r) * D + c, xs[0], xs[1]);
        } else {
          st2(x_s + x_at(r, c), xs[0], xs[1]);
        }
      }
    }
    if (kLayer && last && !do_msg) {  // timing only: a defined output
      const long rows = dm.n - row0 < kRows ? dm.n - row0 : kRows;
      for (long i = tid; i < rows * D; i += kThreads) h_out[row0 * D + i] = store<T>(0.f);
    }
    if (last) break;
    if constexpr (kWg) fence_proxy_async();  // x, written here, is read by wgmma
    if constexpr (kLayer) {
      __syncthreads();  // x is complete; h stays as it is
    } else {
      cluster.sync();  // no block reads this block's h any more
    }
    if (!do_conv) continue;

    // Next conv over the block's rows: h = rnd(x . wn_l + bn_l), in place, or
    // h' staged over x once every thread has read it (the one-layer form).
    const T* bn_l = bn + long(l) * D;
    S* hn_s = kLayer ? x_s : h_s;  // [kRows][D]
    if constexpr (kWg) {
      float o[N / 2];
      lw::run<N>(o, reinterpret_cast<const __nv_bfloat16*>(x_s), ring, l * lg.chunks, lg.chunks, tid);
      if constexpr (kLayer) __syncthreads();  // both warpgroups' products have read x
      lw::for_each<N>(o, D, tid, [&](int r, int c, float v) {
        hn_s[r * D + c] = store<S>(v + ld(bn_l + c));
      });
    } else {
      // Each thread owns kRowsPT x kColsPT outputs in registers.
      const int tr = tid / kTC, tc = tid % kTC;
      float o[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
      // o += x[:, k0 .. k0+kn) . w_c, w_c the weights' rows k0 .. k0+kn.
      auto fma_rows = [&](const float* w_c, int k0, int kn) {
        for (int kk = 0; kk < kn; ++kk) {
          float a[kRowsPT], wv[kColsPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) a[i] = val(x_s[(tr + kTR * i) * D + k0 + kk]);
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            wv[m] = c < D ? w_c[kk * D + c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
            for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(a[i], wv[m], o[i][m]);
        }
      };
      if constexpr (kLayer) {
        // w_next streamed in chunks of kWC input channels: h and x alone
        // take 102 KB at D = 100, and so two blocks fit an SM.
        for (int kc = 0; kc < D; kc += kWC) {
          const int kn = D - kc < kWC ? D - kc : kWC;
          __syncthreads();  // the last chunk is consumed
          for (int i = tid; i < kn * D; i += kThreads) w_s[i] = ld(wn + long(kc) * D + i);
          __syncthreads();
          fma_rows(w_s, kc, kn);
        }
      } else {
        fma_rows(w_s, 0, D);  // wn_l, staged whole with the layer's tables
      }
      if constexpr (kLayer) __syncthreads();  // every thread has read x
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int r = tr + kTR * i, c = tc + kTC * m;
          if (c < D) hn_s[r * D + c] = store<S>(rnd<T>(o[i][m] + ld(bn_l + c)));
        }
    }
  }
  __syncthreads();

  if constexpr (kLayer) {
    // h' out: the block's real rows, one contiguous run of h_out (the last
    // layer wrote its rows from the messages).
    if (!final_layer) {
      const long rows = dm.n - row0 < kRows ? dm.n - row0 : kRows;
      for (long i = tid; i < rows * D; i += kThreads) h_out[row0 * D + i] = x_s[i];
    }
    cluster.sync();  // keep this block's h until no block of the cluster reads it
    return;
  }

  // Finalize: per-row head p = rnd(x) . pred_w, this block's per-graph sums
  // of p, then the cluster's sums, each block writing a share of the outputs.
  float* p_s = w_s;  // [kRows][T]
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(val(x_s[x_at(r, d)]), ld(predw + d * dm.tout + t), s);
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
template <bool kLayer, typename Msg, typename F>
cudaError_t with_kernel(int dtype, int d, F&& f) {
  if (dtype == 0) return f(gcn_model_kernel<float, 0, kLayer, Msg>, float{});
  if (dtype == 1 && conv_n(d) == 104)
    return f(gcn_model_kernel<__nv_bfloat16, 104, kLayer, Msg>, __nv_bfloat16{});
  if (dtype == 1) return f(gcn_model_kernel<__nv_bfloat16, 112, kLayer, Msg>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

inline bool bad_geometry(int dtype, int window, int d, int layers, int stages) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || d < 1 ||
         d > kMaxD || d % 2 || layers < 1 ||
         (dtype == 1 && stages < lw::min_stages(lw::geom(d, conv_n(d)).chunks));
}

// The bf16 form's weight chunks at width d: K' (d padded to whole chunks of
// 32), N (the product's width), the bytes of a chunk.
inline void conv_dims(int d, int* dims) {
  const lw::Geom g = lw::geom(d, conv_n(d));
  dims[0] = g.kp;
  dims[1] = conv_n(d);
  dims[2] = g.chunk_bytes;
}

// What the occupancy calculator says of a launch: out[0] the blocks of the
// form that fit one SM, out[1] the clusters of W/128 blocks that run at
// once (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
template <bool kLayer, typename Msg>
int occupancy(int dtype, int window, int d, int vocab, int gmax, int tout, int stages,
              int device, int* out) {
  const int layers = 2;
  if (bad_geometry(dtype, window, d, layers, stages)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = smem_layout(dtype == 1, d, vocab, gmax, tout, stages, !kLayer).total;
  return int(with_kernel<kLayer, Msg>(dtype, d, [&](auto kernel, auto) {
    ClusterLaunch ln;
    const cudaError_t e = cluster_launch(kernel, ln, 1, window / kRows, kThreads, bytes, nullptr);
    return e != cudaSuccess ? e : cluster_occupancy(kernel, ln, kThreads, bytes, out);
  }));
}

// Checks the geometry and launches the form `dtype` names (0 = float32 with
// the FMA conv, 1 = bfloat16 with the wgmma conv, which needs `tiles`, the
// (L-1) layers' weight chunks as conv_dims gives them (the one-layer form:
// its next conv's, unless wn is null), and a ring of at least two chunk
// buffers); the whole model writes `out`, the one-layer form (kLayer,
// layers = 1) `h_out`. Returns a cudaError_t.
template <bool kLayer, typename Msg>
int launch(int dtype, const Msg& msg, const void* h0, const void* dis, const void* pool_gl,
           const void* tab, const void* roots, const void* alphas, const void* betas,
           const void* wn, const void* bn, const void* predw, const void* tiles, void* out,
           void* h_out, int num_windows, const Dims& dm, int device, void* stream) {
  const bool conv = kLayer ? wn != nullptr : dm.layers > 1;
  if (bad_geometry(dtype, dm.window, dm.d, dm.layers, dm.stages) || num_windows < 1 ||
      (dtype == 1 && conv && tiles == nullptr) || (kLayer && (dm.layers != 1 || !h_out)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Smem lay = smem_layout(dtype == 1, dm.d, dm.vocab, dm.gmax, dm.tout, dm.stages, !kLayer);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_kernel<kLayer, Msg>(dtype, dm.d, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    ClusterLaunch ln;
    cudaError_t e =
        cluster_launch(kernel, ln, num_windows, dm.window / kRows, kThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, msg, static_cast<const T*>(h0),
                           static_cast<const T*>(dis), static_cast<const int*>(pool_gl),
                           static_cast<const T*>(tab), static_cast<const T*>(roots),
                           static_cast<const T*>(alphas), static_cast<const T*>(betas),
                           static_cast<const T*>(wn), static_cast<const T*>(bn),
                           static_cast<const T*>(predw), static_cast<const unsigned char*>(tiles),
                           static_cast<float*>(out), static_cast<T*>(h_out), dm, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

// ---------------------------------------------------------------------------
// The messages-only form (row 14, gcn_local_message_ell.cu): the message stage
// of the layer above with rnd(acc * dis_v) written out in place of the tail.
// Per window row v, over its lanes u -> v in lane order,
//   m[v] = rnd(dis_v * sum rnd(dis_u * relu(h_u + ee)))
// with the ELL lane runs of lanes::Ell (any k edge blocks a window). A window
// of W = 128..1024 rows runs on a cluster of W/128 blocks; each block stages
// its 128 rows of h (in h's type) and of dis, and the bond table, in shared
// memory (h as one contiguous run of 16-byte cp.async copies, in flight while
// the block loads the rest); a source in another block's rows (h_u and
// dis_u) is read through cluster.map_shared_rank. It has no tail, no conv, no weight ring and no
// pool head, so it takes any D from 1 to 128: h and the table are kept at an
// even row stride (an odd D pads one zero column), so every column pair is
// one aligned load. A half-warp takes a row (two rows a warp at once), each
// thread kMsgPairs column pairs; the row's lanes (u and the three table
// rows) are loaded 16 at a time, one lane a thread, and handed round by
// shuffles, so the lanes' loads from device memory are not a chain. Its
// blocks have 512 threads (the other forms 256): a window's 128 rows are all
// a block's work, and at the models' shapes a launch has about two blocks an
// SM, so the messages' arithmetic needs the warps of a block that size to
// keep an SM issuing. At D = 100 in bf16 a block holds h 25.6 KB, the table
// 5.2 KB and ~1 KB of the rest.
// ---------------------------------------------------------------------------

constexpr int kMsgMaxD = 2 * 32 * kLaneP;  // widest D of the messages-only form (128)
constexpr int kMsgThreads = 512;           // threads a block of the messages-only form
constexpr int kMsgWarps = kMsgThreads / 32;
constexpr int kMsgGroup = 16;              // threads a row
constexpr int kMsgPairs = kMsgMaxD / (2 * kMsgGroup);  // column pairs a thread (4)
constexpr int kStageAhead = 8;             // table loads a thread keeps in flight

struct MsgDims {
  int n, window, d, vocab, knockout;
};

// The messages-only form's shared-memory carve-up, byte offsets, and the
// row stride (elements) of h and of the table.
struct MsgSmem {
  size_t h, dis, tab, lo, total;
  int stride;
};

inline MsgSmem msg_smem_layout(bool bf16, int d, int vocab) {
  MsgSmem s;
  s.stride = d + (d & 1);
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(size_t(kRows) * s.stride * (bf16 ? 2 : 4));
  s.dis = take(kRows * 4);
  s.tab = take(size_t(vocab) * s.stride * 4);
  s.lo = take((kRows + 1) * 4);
  s.total = o;
  return s;
}

// out [n, D]: m for every real row. Dims::knockout bit 1 (kNoMessages) skips
// the messages and writes zeros (timing only).
template <typename T>
__global__ void __launch_bounds__(kMsgThreads, 2)
gcn_messages_kernel(lanes::Ell msg, const T* __restrict__ h, const T* __restrict__ dis,
                    const T* __restrict__ tab, T* __restrict__ out, MsgDims dm, MsgSmem lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / int(cluster.num_blocks());
  const int D = dm.d, P = lay.stride, tid = threadIdx.x;
  T* h_s = reinterpret_cast<T*>(smem + lay.h);                  // [kRows][P] this block's rows
  float* dis_s = reinterpret_cast<float*>(smem + lay.dis);      // [kRows]
  float* tab_s = reinterpret_cast<float*>(smem + lay.tab);      // [vocab][P]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);            // [kRows+1] the rows' lane runs
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(rank) * kRows;
  const int rows = dm.n - row0 < kRows ? int(dm.n - row0) : kRows;  // real rows (may be <= 0)
  const bool do_msg = !(dm.knockout & kNoMessages);

  // h: the block's real rows, one contiguous run of device memory, and zeros
  // past them (stage_rows: 16-byte copies in flight at an even D).
  stage_rows<kMsgThreads>(h_s, h + row0 * D, rows, kRows, D, P, tid);
  for (int r = tid; r < kRows; r += kMsgThreads) dis_s[r] = r < rows ? ld(dis + row0 + r) : 0.f;
  for (int i0 = 0; i0 < dm.vocab * P; i0 += kMsgThreads * kStageAhead) {
    float x[kStageAhead];
#pragma unroll
    for (int u = 0; u < kStageAhead; ++u) {
      const int i = i0 + u * kMsgThreads + tid, a = i / P, c = i - a * P;
      x[u] = i < dm.vocab * P && c < D ? ld(tab + a * D + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageAhead; ++u) {
      const int i = i0 + u * kMsgThreads + tid;
      if (i < dm.vocab * P) tab_s[i] = x[u];
    }
  }
  lanes::ell_runs<kRows>(msg.meta + long(win) * msg.block * lanes::kEllMeta, msg.block,
                         rank * kRows, lo_s, tid, kMsgThreads);
  cp_async_wait_all();
  // Every block's h and dis are in place before any block gathers from them.
  cluster.sync();

  // A half-warp a row: rows r and r + 1 of a step go to the warp's two halves.
  const int lane = tid % 32, hl = lane % kMsgGroup, half = lane / kMsgGroup;
  const int* meta_w = msg.meta + long(win) * msg.block * lanes::kEllMeta;
  for (int rb = 2 * (tid / 32); rb < rows; rb += 2 * kMsgWarps) {
    const int r = rb + half;
    const bool live = r < rows;
    float2 acc[kMsgPairs];
#pragma unroll
    for (int j = 0; j < kMsgPairs; ++j) acc[j] = make_float2(0.f, 0.f);
    const int lo = live ? lo_s[r] : 0, n = live && do_msg ? lo_s[r + 1] - lo : 0;
    // The two halves walk max(n) lanes together (shuffles need the whole warp).
    const int most = max(n, __shfl_xor_sync(0xffffffffu, n, kMsgGroup));
    for (int e0 = 0; e0 < most; e0 += kMsgGroup) {
      // This half's next kMsgGroup lanes: one a thread.
      int mu = dm.window, m1 = -1, m2 = -1, m3 = -1;
      if (e0 + hl < n) {
        const int* m = meta_w + (lo + e0 + hl) * lanes::kEllMeta;
        mu = __ldg(m);
        m1 = __ldg(m + 2);
        m2 = __ldg(m + 3);
        m3 = __ldg(m + 4);
      }
      const int steps = min(kMsgGroup, most - e0);
      for (int k = 0; k < steps; ++k) {
        const int src = half * kMsgGroup + k;
        const int u = __shfl_sync(0xffffffffu, mu, src);
        const int a1 = __shfl_sync(0xffffffffu, m1, src);
        const int a2 = __shfl_sync(0xffffffffu, m2, src);
        const int a3 = __shfl_sync(0xffffffffu, m3, src);
        // Past the row, outside the window or a padding row: no message.
        if (e0 + k >= n || unsigned(u) >= unsigned(dm.window) || wrow0 + u >= dm.n) continue;
        const int owner = u / kRows, ur = u - owner * kRows;
        const T* hb = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
        const float* db = owner == rank ? dis_s : cluster.map_shared_rank(dis_s, owner);
        add_message<T, kMsgGroup>(acc, hb + ur * P, db[ur], bond_row(tab_s, a1, dm.vocab, P),
                                  bond_row(tab_s, a2, dm.vocab, P),
                                  bond_row(tab_s, a3, dm.vocab, P), hl, D);
      }
    }
    if (!live) continue;
    const float dv = dis_s[r];
    T* o = out + (row0 + r) * D;
#pragma unroll
    for (int j = 0; j < kMsgPairs; ++j) {
      const int c = 2 * (hl + kMsgGroup * j);
      if (c >= D) break;
      const float x = __fmul_rn(acc[j].x, dv), y = __fmul_rn(acc[j].y, dv);
      st_pair(o, c, D, x, y);
    }
  }
  cluster.sync();  // keep this block's h until no block of the cluster reads it
}

inline bool bad_msg_geometry(int window, int d, int vocab) {
  return window % kRows || window / kRows < 1 || window / kRows > kMaxCluster || d < 1 ||
         d > kMsgMaxD || vocab < 0;
}

// The messages-only form's kernel by dtype code (0 = float32, 1 = bfloat16).
template <typename F>
cudaError_t with_msg_kernel(int dtype, F&& f) {
  if (dtype == 0) return f(gcn_messages_kernel<float>, float{});
  if (dtype == 1) return f(gcn_messages_kernel<__nv_bfloat16>, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// What the occupancy calculator says of the messages-only form: out[0] the
// blocks that fit one SM, out[1] the clusters of W/128 blocks that run at
// once. Returns a cudaError_t.
inline int msg_occupancy(int dtype, int window, int d, int vocab, int device, int* out) {
  if (bad_msg_geometry(window, d, vocab)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = msg_smem_layout(dtype == 1, d, vocab).total;
  return int(with_msg_kernel(dtype, [&](auto kernel, auto) {
    ClusterLaunch ln;
    const cudaError_t e =
        cluster_launch(kernel, ln, 1, window / kRows, kMsgThreads, bytes, nullptr);
    return e != cudaSuccess ? e : cluster_occupancy(kernel, ln, kMsgThreads, bytes, out);
  }));
}

// Checks the geometry and launches the messages-only form over `lanes`
// lanes a window of meta. Returns a cudaError_t.
inline int launch_messages(int dtype, const void* meta, int lanes, const void* h, const void* dis,
                           const void* tab, void* out, int num_windows, const MsgDims& dm,
                           int device, void* stream) {
  if (bad_msg_geometry(dm.window, dm.d, dm.vocab) || num_windows < 1 || lanes < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const MsgSmem lay = msg_smem_layout(dtype == 1, dm.d, dm.vocab);
  const lanes::Ell walk{static_cast<const int*>(meta), lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(with_msg_kernel(dtype, [&](auto kernel, auto tag) {
    using T = decltype(tag);
    ClusterLaunch ln;
    cudaError_t e =
        cluster_launch(kernel, ln, num_windows, dm.window / kRows, kMsgThreads, lay.total, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&ln.cfg, kernel, walk, static_cast<const T*>(h),
                           static_cast<const T*>(dis), static_cast<const T*>(tab),
                           static_cast<T*>(out), dm, lay);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }));
}

}  // namespace gcn_model
