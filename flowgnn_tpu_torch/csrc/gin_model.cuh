// The GIN / GIN-VN whole-model kernel for Hopper (sm_90a), templated on its
// message stage: row 8 (gin_local_model.cu, the k = 1 ELL layout) and row 1
// (gin_local_model_slots.cu, the degree-sorted slot layout) are its two
// instantiations. Output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GIN layers plus the finalize, in one launch.
//
// A window of W = 128..1024 rows runs on a thread-block cluster of W/128
// blocks (1 to 8, the portable cluster size), each owning 128 rows: their h,
// act, the MLP's working set and the VN partials. A source row in another
// block's rows is read from that block's shared memory (distributed shared
// memory, cluster.map_shared_rank). Each destination row's messages are
// summed one warp per row, the lanes over D, in the layout's lane order, in
// f32, with no atomics. Per layer the cluster synchronises after the layer's
// h is in place (before any block gathers from it) and after the messages
// (before any block overwrites its h); GIN-VN adds one barrier after its
// per-graph partials. A graph may span blocks, so the analytic-VN pool and
// the readout pool are per-block partials over the block's rows, reduced
// across the cluster in rank order through distributed shared memory:
// deterministic, and summed in another order than the plain versions (one
// running sum over the window's rows), which the f32 comparisons allow for
// at 1e-4 of the output's scale.
//
// The message stage (the template parameter Msg, one of lanes.cuh's walks)
// says which lanes a block row has and in what order: Msg::prepare(win,
// rank, tid, lo_s) runs once before the layers (lo_s: kRows + 1 ints of
// shared scratch), and Msg::visit(win, rank, r, lo_s, window, f) calls f(u,
// a1, a2, a3) for each lane of the block's row r in order: u the source's
// window row (outside [0, W): a zero source, whose message is relu(ee)
// alone), a1..a3 the lane's bond-table rows (outside the vocabulary: none).
// A lane the layout drops is not visited.
//
// Numerics are the TPU kernels': activations and weights are float or
// bfloat16 (T); every product and sum is float32; messages, act, the hidden
// layer and the new h are rounded to T where the TPU kernels cast to their
// compute dtype; the VN pool stays float32.
//
// The update MLP, h = relu(act·W1ᵀ + b1)·W2ᵀ + b2 (relu but on the last
// layer), is 4·n·D·H operations a layer, almost all of the kernel's (at D =
// 100, H = 200, 93 GFLOP per 2048-graph hep10k stream and 45 GFLOP per
// molhiv stream: 1.39 / 0.67 ms at the CUDA cores' 67 TFLOP/s f32 peak,
// 0.094 / 0.046 ms at the tensor cores' 989 bf16). So the two forms run it
// differently:
// - float32 keeps the register-tiled FMA MLP over 32-unit chunks of the
//   hidden layer (TF32 would break the f32 gate of 1e-4), W1 and W2 staged
//   through shared memory chunk by chunk;
// - bfloat16 runs it on the tensor cores (gin_mlp.cuh). Its windows stay
//   bf16 in shared memory (h and act are rounded to bf16 anyway), which also
//   halves the gathers' distributed-shared-memory traffic, and the messages
//   write act straight into wgmma's A layout. The weight chunks stream
//   through a ring of S buffers, all L·C chunks of the model one sequence:
//   the first S are prefetched before the first layer, overlapped with the
//   set-up and the messages, and each buffer is refilled as soon as the MLP
//   is done with it. The wrapper takes the largest S ≤ C (the chunks of a
//   layer) that fits the card's shared memory. Shared memory at D = 100,
//   H = 200, S = C = 7: h 25.6 KB, act 28.7, VN partials 51.2, ring 96.8,
//   bond table 5.2, the rest 2.6: 210 KB of the 227 a block may use, one
//   block an SM (float32: 161 KB); at S = 2, 141 KB; H = 512 (16 chunks)
//   runs at S = 8.
//
// The shared-memory carve-up (smem_layout) is computed once on the host and
// passed as a kernel parameter. Computed in the kernel from the runtime
// widths, its offsets' arithmetic stayed live in the f32 form's FMA loops,
// next to ~170 registers of tiles, and cost that form 10-17% (PERF.md).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gin_mlp.cuh"
#include "hopper.cuh"

namespace gin_model {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 MLP tile
constexpr int kTC = 16;                // thread columns of the f32 MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk (both MLPs)
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
// Bond vocabulary rows of the (0, 0, 0) attr that every analytic VN star
// edge carries: the feature offsets {0, 5, 11}.
constexpr int kE0Row0 = 0, kE0Row1 = 5, kE0Row2 = 11;

static_assert(kMaxD == gin_mlp::kMaxD && kRows == gin_mlp::kRows && kThreads == gin_mlp::kThreads,
              "the bf16 MLP's block shape");

struct Dims {
  int n, window, d, hid, layers, vocab, gmax, tout, stages;
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and act are bf16 and which holds the weight ring (ring,
// bars); the f32 form keeps its MLP tiles in the scratch.
struct Smem {
  size_t h, act, scratch, part, tab, gl, vn, rows, gstart, lo, ring, bars, total;
};

inline Smem smem_layout(bool wg, int d, int hid, int vocab, int gmax, int tout,
                                            int stages) {
  const size_t D = d;
  const gin_mlp::Geom gm = gin_mlp::geom(d, hid);
  size_t scratch = wg ? 0 : (kRows * kHC + kHC * (D + 1) + D * (kHC + 1) + kHC) * 4;
  const size_t vn_part = size_t(gmax) * 2 * D * 4;
  if (vn_part > scratch) scratch = vn_part;
  if (size_t(kRows) * tout * 4 > scratch) scratch = size_t(kRows) * tout * 4;  // head outputs
  if (size_t(gmax) * 4 > scratch) scratch = size_t(gmax) * 4;                  // CSR cursor
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.h = take(kRows * D * (wg ? 2 : 4));
  s.act = take(kRows * (wg ? size_t(gm.dp) * 2 : D * 4));
  s.scratch = take(scratch);
  s.part = take(size_t(gmax) * tout * 4);
  s.tab = take(size_t(vocab) * D * 4);
  s.gl = take(kRows * 4);
  s.vn = take(kRows * 4);
  s.rows = take(kRows * 4);
  s.gstart = take((gmax + 1) * 4);
  s.lo = take((kRows + 1) * 4);
  s.ring = take(wg ? size_t(stages) * gm.chunk_bytes : 0);
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

// h and act in shared memory: float, or bf16 for the wgmma form.
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

// N2 = 0: the float32 form (FMA MLP); N2 = 104 or 112: the bf16 form with
// the wgmma MLP, N2 its second product's width. tiles: the bf16 form's
// packed weight chunks (gin_mlp.cuh), all layers in order. lay: the
// shared-memory carve-up, computed once on the host (smem_layout).
template <typename T, int N2, typename Msg>
__global__ void __launch_bounds__(kThreads)
gin_model_kernel(Msg msg, const T* __restrict__ h0, const int* __restrict__ pool_gl,
                 const T* __restrict__ tab, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ eps, const T* __restrict__ predw,
                 const T* __restrict__ vn_col, const unsigned char* __restrict__ tiles,
                 float* __restrict__ out, Dims dm, Smem lay) {
  constexpr bool kWg = N2 > 0;
  using S = T;  // h and act in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const gin_mlp::Geom gm = gin_mlp::geom(dm.d, dm.hid);
  S* h_s = reinterpret_cast<S*>(smem + lay.h);        // [kRows][D] this block's rows of h
  S* act_s = reinterpret_cast<S*>(smem + lay.act);    // (1+eps)·h + messages: f32 [kRows][D],
                                                      // bf16 [D'/8][kRows][8]
  float* scr = reinterpret_cast<float*>(smem + lay.scratch);  // VN partials, MLP or head
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // [gmax][T] readout partials
  float* tab_s = reinterpret_cast<float*>(smem + lay.tab);    // [vocab][D] this layer's bonds
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  float* vn_s = reinterpret_cast<float*>(smem + lay.vn);      // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] the message stage's
  const gin_mlp::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                           dm.stages, dm.layers * gm.chunks, gm.chunk_bytes};

  const int D = dm.d, tid = threadIdx.x;
  // act's element (r, c): row-major, or the wgmma A layout.
  auto act_at = [&](int r, int c) -> S& {
    return kWg ? act_s[gin_mlp::act_index(r, c)] : act_s[r * D + c];
  };
  const bool has_vn = vn_col != nullptr;
  const long row0 = long(win) * dm.window + long(rank) * kRows;

  if constexpr (kWg) {
    if (tid == 0) ring.init();
    // act's pad columns stay zero; the messages write columns < D only.
    const int pad = gm.dp - D;
    for (int i = tid; i < kRows * pad; i += kThreads) act_at(i / pad, D + i % pad) = store<S>(0.f);
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = store<S>(row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    vn_s[r] = has_vn && row0 + r < dm.n ? ld(vn_col + row0 + r) : 0.f;
  }
  msg.prepare(win, rank, tid, lo_s);
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0) ring.prefetch();  // the first S weight chunks, while the layers set up
  }
  if (tid == 0) {
    // Group the block's rows by graph (ascending row order within a graph):
    // the pools then sum each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(scr);
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
  const int tr = tid / kTC, tc = tid % kTC;
  for (int l = 0; l < dm.layers; ++l) {
    // Every block's h is in place, and no block still reads the previous
    // layer's VN partials.
    cluster.sync();
    const T* tab_l = tab + long(l) * dm.vocab * D;
    for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab_l + i);
    __syncthreads();

    // Analytic virtual node: this block's part of each graph's pooled star
    // messages into the VN (real rows' relu(h + e0)) and out of it (the VN
    // row's), e0 being the (0, 0, 0)-attr bond embedding.
    float* vnp = scr;  // [gmax][2D]: real-row sums ‖ VN-row sums
    if (has_vn) {
      for (int i = tid; i < dm.gmax * D; i += kThreads) {
        const int g = i / D, c = i - g * D;
        const float e0 = tab_s[kE0Row0 * D + c] + tab_s[kE0Row1 * D + c] + tab_s[kE0Row2 * D + c];
        float s_real = 0.f, s_vn = 0.f;
        for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) {
          const int r = rows_s[j];
          const float v = rnd<T>(fmaxf(val(h_s[r * D + c]) + e0, 0.f));
          if (vn_s[r] != 0.f) s_vn += v; else s_real += v;
        }
        vnp[g * 2 * D + c] = s_real;
        vnp[g * 2 * D + D + c] = s_vn;
      }
      cluster.sync();  // every block's partials are written
    }

    // Messages, one warp per destination row; lane j of the warp holds
    // columns j, j + 32, ... of the row.
    const float eps_l = eps[l];
    for (int r = warp; r < kRows; r += kWarps) {
      float acc[kLaneD];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
      msg.visit(win, rank, r, lo_s, dm.window, [&](int u, int a1, int a2, int a3) {
        const S* hu = nullptr;
        if (unsigned(u) < unsigned(dm.window)) {
          const int owner = u / kRows;
          const S* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
          hu = base + (u - owner * kRows) * D;
        }
        const float* e1 = bond_row(tab_s, a1, dm.vocab, D);
        const float* e2 = bond_row(tab_s, a2, dm.vocab, D);
        const float* e3 = bond_row(tab_s, a3, dm.vocab, D);
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) {
          const int c = lane + 32 * j;
          if (c >= D) break;
          float ee = 0.f;
          if (e1) ee += e1[c];
          if (e2) ee += e2[c];
          if (e3) ee += e3[c];
          acc[j] += rnd<T>(fmaxf((hu ? val(hu[c]) : 0.f) + ee, 0.f));
        }
      });
      const int g = gl_s[r];
      const bool vn_in = has_vn && unsigned(g) < unsigned(dm.gmax);
      const int vn_off = g * 2 * D + (vn_s[r] != 0.f ? 0 : D);
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        float a = acc[j];
        if (vn_in) {  // the VN row takes the real rows' pool, a real row the VN's
          float s = 0.f;
          for (int k = 0; k < csize; ++k) s += cluster.map_shared_rank(vnp, k)[vn_off + c];
          a += s;
        }
        act_at(r, c) = store<S>(rnd<T>(__fadd_rn(a, __fmul_rn(eps_l, val(h_s[r * D + c])))));
      }
    }
    if constexpr (kWg) fence_proxy_async();  // act, written here, is read by wgmma
    // No block reads this block's h or VN partials any more.
    cluster.sync();

    if constexpr (kWg) {
      // Update MLP on the tensor cores; h_s is not read during it, so its
      // rows can be replaced after it.
      float o[N2 / 2];
      gin_mlp::run<N2>(o, reinterpret_cast<const __nv_bfloat16*>(act_s), ring, l * gm.chunks, gm,
                       b1 + long(l) * dm.hid, b2 + long(l) * D, D, dm.hid, l != dm.layers - 1,
                       tid);
      gin_mlp::for_each_out<N2>(o, D, tid, [&](int r, int c, float v) {
        h_s[r * D + c] = store<S>(v);
      });
    } else {
      // Update MLP over the block's rows: h = act·w1ᵀ + b1 → relu → ·w2ᵀ + b2
      // (→ relu), in chunks of kHC hidden units. Each thread owns kRowsPT ×
      // kColsPT outputs in registers across all chunks.
      float* hid_s = scr;                    // [kRows][kHC]
      float* w1c = hid_s + kRows * kHC;      // [kHC][D+1]
      float* w2c = w1c + kHC * (D + 1);      // [D][kHC+1]
      float* b1c = w2c + D * (kHC + 1);      // [kHC]
      const T* w1_l = w1 + long(l) * dm.hid * D;
      const T* w2_l = w2 + long(l) * D * dm.hid;
      float o[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
      for (int j0 = 0; j0 < dm.hid; j0 += kHC) {
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < kHC * D; i += kThreads) {
          const int j = i / D, k = i - j * D;
          w1c[j * (D + 1) + k] = j0 + j < dm.hid ? ld(w1_l + long(j0 + j) * D + k) : 0.f;
        }
        for (int i = tid; i < D * kHC; i += kThreads) {
          const int c = i / kHC, j = i - c * kHC;
          w2c[c * (kHC + 1) + j] = j0 + j < dm.hid ? ld(w2_l + long(c) * dm.hid + j0 + j) : 0.f;
        }
        for (int j = tid; j < kHC; j += kThreads)
          b1c[j] = j0 + j < dm.hid ? ld(b1 + long(l) * dm.hid + j0 + j) : 0.f;
        __syncthreads();

        float z[kRowsPT][kHcPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) z[i][m] = 0.f;
        for (int k = 0; k < D; ++k) {
          float a[kRowsPT], wv[kHcPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) a[i] = val(act_s[(tr + kTR * i) * D + k]);
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) wv[m] = w1c[(tc + kTC * m) * (D + 1) + k];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
            for (int m = 0; m < kHcPT; ++m) z[i][m] = fmaf(a[i], wv[m], z[i][m]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) {
            const int j = tc + kTC * m;
            hid_s[(tr + kTR * i) * kHC + j] = rnd<T>(fmaxf(z[i][m] + b1c[j], 0.f));
          }
        __syncthreads();

        for (int j = 0; j < kHC; ++j) {
          float hv[kRowsPT], wv[kColsPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) hv[i] = hid_s[(tr + kTR * i) * kHC + j];
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            wv[m] = c < D ? w2c[c * (kHC + 1) + j] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
            for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(hv[i], wv[m], o[i][m]);
        }
      }
      // h_s is not read during the MLP, so its rows can be replaced here.
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int r = tr + kTR * i, c = tc + kTC * m;
          if (c < D) {
            float v = o[i][m] + ld(b2 + long(l) * D + c);
            if (l != dm.layers - 1) v = fmaxf(v, 0.f);
            h_s[r * D + c] = store<S>(rnd<T>(v));
          }
        }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = h·pred_w, this block's per-graph sums of p,
  // then the cluster's sums, each block writing a share of the outputs.
  float* p_s = scr;  // [kRows][T]
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(val(h_s[r * D + d]), ld(predw + d * dm.tout + t), s);
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

template <typename T, int N2, typename Msg>
cudaError_t launch_typed(const Msg& msg, const void* h0, const void* pool_gl, const void* tab,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* eps, const void* predw, const void* vn_col,
                         const void* tiles, void* out, int num_windows, const Dims& dm,
                         cudaStream_t stream) {
  const Smem lay = smem_layout(N2 > 0, dm.d, dm.hid, dm.vocab, dm.gmax, dm.tout, dm.stages);
  ClusterLaunch ln;
  cudaError_t err = cluster_launch(gin_model_kernel<T, N2, Msg>, ln, num_windows,
                                   dm.window / kRows, kThreads, lay.total, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &ln.cfg, gin_model_kernel<T, N2, Msg>, msg, static_cast<const T*>(h0),
      static_cast<const int*>(pool_gl), static_cast<const T*>(tab), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps), static_cast<const T*>(predw),
      static_cast<const T*>(vn_col), static_cast<const unsigned char*>(tiles),
      static_cast<float*>(out), dm, lay);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the geometry and launches the form `dtype` names (0 = float32 with
// the FMA MLP, 1 = bfloat16 with the wgmma MLP, which needs `tiles` and a
// ring of at least gin_mlp::min_stages buffers); returns a cudaError_t.
template <typename Msg>
int launch(int dtype, const Msg& msg, const void* h0, const void* pool_gl, const void* tab,
           const void* w1, const void* b1, const void* w2, const void* b2, const void* eps,
           const void* predw, const void* vn_col, const void* tiles, void* out, int num_windows,
           const Dims& dm, int device, void* stream) {
  if (dm.window % kRows || dm.window / kRows < 1 || dm.window / kRows > kMaxCluster ||
      dm.d < 1 || dm.d > kMaxD || dm.hid < 1 || num_windows < 1 ||
      (dtype == 1 && (tiles == nullptr || dm.stages < gin_mlp::min_stages(dm.d, dm.hid))))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_typed<float, 0>(msg, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw, vn_col,
                                 nullptr, out, num_windows, dm, s);
  else if (dtype == 1 && gin_mlp::geom(dm.d, dm.hid).n2 == 104)
    err = launch_typed<__nv_bfloat16, 104>(msg, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                                           vn_col, tiles, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16, 112>(msg, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                                           vn_col, tiles, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

}  // namespace gin_model
