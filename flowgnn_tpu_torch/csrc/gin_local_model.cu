// GIN / GIN-VN whole-model ELL kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_model (with its helpers _ell_meta and _pool_epilogue). Same
// function, same output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GIN layers plus the finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch with
// blocked="local_ell", k = 1): node windows of W rows in packed order, each
// owning `block` lanes of `meta` = (u, v, three bond-table rows) per lane,
// both endpoints window-local. Within a window the lanes are sorted by v
// (a stable sort by receiver), so each destination row's lanes are one
// contiguous run; pad lanes carry u = v = W and come last. pool_gl holds
// each row's window-local graph id, GMAX for padding rows.
//
// What bounds it on this card: per 128 rows and layer the update MLP costs
// 2*128*D*H multiply-adds (5.1 M at D=100, H=200) against ~1.5 lanes per
// row of D-wide gathers for the messages; h is read once and GMAX*T floats
// are written per window, so device-memory traffic is small and the kernel
// is bound on chip (arithmetic, shared-memory traffic, latency). What
// bounds the design is shared memory: a window of W = 512 rows holds 204.8
// KB of f32 h and as much again of f32 act, past the 227 KB a block may
// use. So a window runs on a thread-block cluster of W/128 blocks (1 to 8,
// the portable cluster size), each owning 128 rows: their h, act, the MLP's
// working tiles and the VN partials, ~161 KB at D=100, the footprint of the
// one-block W=128 slot kernel. A source row in another block's rows is
// read from that block's shared memory (distributed shared memory,
// cluster.map_shared_rank). Each block finds its rows' lane runs by binary
// search on v and sums each row's lanes in lane order, one warp per row and
// the lanes over D, with no atomics. Per layer the cluster synchronises
// after the layer's h is in place (before any block gathers from it) and
// after the messages (before any block overwrites its h); GIN-VN adds one
// barrier after its per-graph partials. A graph may span blocks (a 400-node
// graph covers four), so the analytic-VN pool and the readout pool are
// per-block partials over the block's rows, reduced across the cluster in
// rank order through distributed shared memory: deterministic, and summed
// in another order than the plain version (one running sum over the
// window's rows), which the f32 comparisons allow for at 1e-4 of the
// output's scale.
//
// The update MLP, h = relu(act·W1ᵀ + b1)·W2ᵀ + b2 (relu but on the last
// layer), is 4·n·D·H operations a layer, almost all of the kernel's: 93
// GFLOP per 2048-graph hep10k stream at D = 100, H = 200, at least 1.39 ms
// at the CUDA cores' 67 TFLOP/s f32 peak and 0.094 ms at the tensor cores'
// 989 bf16. So the two instantiations run it differently:
// - float32 keeps the register-tiled FMA MLP over 32-unit chunks of the
//   hidden layer (TF32 would break the f32 gate of 1e-4);
// - bfloat16 runs it on the tensor cores with wgmma (csrc/hopper.cuh). Its
//   windows stay bf16 in shared memory (h and act are rounded to bf16
//   anyway), which also halves the gathers' distributed-shared-memory
//   traffic. The messages write act straight into wgmma's K-major A layout
//   ([D'/8][128 rows][8], D' = D padded to 16 with zero columns). W1 and W2
//   come packed by the host into the same layout (ops/tiles.py: W1 as
//   [D'/8][H'][8], W2 as [H'/8][N2][8], H' = H padded to 32, N2 = D padded
//   to 104 or 112, pads zero), and one thread brings both to shared memory
//   at the top of each layer by bulk copy against an mbarrier, overlapped
//   with the VN stage and the messages. Each of the block's two
//   warpgroups owns 64 of its 128 rows. Per chunk of 32 hidden units: z =
//   act·W1ᵀ as wgmma m64n32k16 from shared memory (D'/16 steps); in
//   registers + b1, relu, rounded to bf16 and paired into the A fragment of
//   the next product; out += z·W2ᵀ as wgmma m64nN2k16 with A from registers
//   (two steps), so the hidden layer never goes to shared memory. After the
//   last chunk, + b2 in f32, relu, rounded into h. Registers: out is N2/2 =
//   52 (or 56) f32 a thread, z 16, the fragment 8. Chunking H in 32s, rather
//   than one m64n200 product, keeps the register plan independent of H and
//   the packing simple; its price is that act is read once per chunk (7
//   times at H = 200). A bf16 shape the plan cannot take (D > 112, or a
//   weight footprint past the card's shared memory) is refused before
//   launch by the wrapper's geometry check; it never falls back to FMA.
//   Shared memory at D = 100, H = 200: h 25.6 KB, act 28.7, VN partials
//   51.2, W1 50.2, W2 46.6 (N2 = 104), bond table 5.2, the rest 2.6: 210 KB
//   of the 227 a block may use, one block an SM as before (float32: 161 KB).
//
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the MLP tile
constexpr int kTC = 16;                // thread columns of the MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk (both MLPs)
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows
// Bond vocabulary rows of the (0, 0, 0) attr that every analytic VN star
// edge carries: the feature offsets {0, 5, 11}.
constexpr int kE0Row0 = 0, kE0Row1 = 5, kE0Row2 = 11;

struct Dims {
  int n, window, block, d, hid, layers, vocab, gmax, tout;
};

// The bf16 MLP's tile geometry: K of the first product (D padded to 16),
// hidden units padded to whole chunks, the second product's width.
struct Tiles {
  int dp, hp, n2;
};

__host__ __device__ inline Tiles tiles_of(int d, int hid) {
  return Tiles{(d + 15) / 16 * 16, (hid + kHC - 1) / kHC * kHC, d <= 104 ? 104 : 112};
}

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 (wgmma)
// form, whose h and act are bf16 and which holds W1 and W2 (w1, w2, bar);
// the f32 form keeps its MLP tiles in the scratch.
struct Smem {
  size_t h, act, scratch, part, tab, gl, vn, rows, gstart, lo, w1, w2, bar, total;
};

__host__ __device__ inline Smem smem_layout(bool wg, int d, int hid, int vocab, int gmax,
                                            int tout) {
  const size_t D = d;
  const Tiles tl = tiles_of(d, hid);
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
  s.act = take(kRows * (wg ? size_t(tl.dp) * 2 : D * 4));
  s.scratch = take(scratch);
  s.part = take(size_t(gmax) * tout * 4);
  s.tab = take(size_t(vocab) * D * 4);
  s.gl = take(kRows * 4);
  s.vn = take(kRows * 4);
  s.rows = take(kRows * 4);
  s.gstart = take((gmax + 1) * 4);
  s.lo = take((kRows + 1) * 4);
  s.w1 = take(wg ? size_t(tl.dp) * tl.hp * 2 : 0);
  s.w2 = take(wg ? size_t(tl.hp) * tl.n2 * 2 : 0);
  s.bar = take(wg ? 8 : 0);
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab,
                                                 int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

// N2 = 0: the float32 form (FMA MLP); N2 = 104 or 112: the bf16 form with
// the wgmma MLP, N2 its second product's width.
template <typename T, int N2>
__global__ void __launch_bounds__(kThreads)
gin_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h0,
               const int* __restrict__ pool_gl, const T* __restrict__ tab,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2,
               const float* __restrict__ eps, const T* __restrict__ predw,
               const T* __restrict__ vn_col, const unsigned char* __restrict__ w1t,
               const unsigned char* __restrict__ w2t, float* __restrict__ out, Dims dm) {
  constexpr bool kWg = N2 > 0;
  using S = T;  // h and act in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const Smem lay = smem_layout(kWg, dm.d, dm.hid, dm.vocab, dm.gmax, dm.tout);
  const Tiles tl = tiles_of(dm.d, dm.hid);
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
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] lane runs
  __nv_bfloat16* w1_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w1);  // [D'/8][H'][8]
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w2);  // [H'/8][N2][8]
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + lay.bar);  // W1 and W2 have landed

  const int D = dm.d, tid = threadIdx.x;
  // act's element (r, c): row-major, or the wgmma A layout.
  auto act_at = [&](int r, int c) -> S& {
    return kWg ? act_s[((c >> 3) * kRows + r) * 8 + (c & 7)] : act_s[r * D + c];
  };
  const bool has_vn = vn_col != nullptr;
  const long row0 = long(win) * dm.window + long(rank) * kRows;
  const int* meta_w = meta + long(win) * dm.block * kMeta;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = store<S>(row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f);
  }
  if constexpr (kWg) {
    // act's pad columns stay zero; the messages write columns < D only.
    const int pad = tl.dp - D;
    for (int i = tid; i < kRows * pad; i += kThreads) act_at(i / pad, D + i % pad) = store<S>(0.f);
    if (tid == 0) {
      mbar_init(wbar, 1);
      mbar_fence_init();
    }
  }
  for (int r = tid; r < kRows; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    vn_s[r] = has_vn && row0 + r < dm.n ? ld(vn_col + row0 + r) : 0.f;
  }
  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index, by binary search over v.
  for (int r = tid; r <= kRows; r += kThreads) {
    const int key = rank * kRows + r;
    int lo = 0, hi = dm.block;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(meta_w + mid * kMeta + 1) < key) lo = mid + 1; else hi = mid;
    }
    lo_s[r] = lo;
  }
  __syncthreads();
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
  const uint32_t w1_bytes = uint32_t(tl.dp) * tl.hp * 2, w2_bytes = uint32_t(tl.hp) * N2 * 2;
  for (int l = 0; l < dm.layers; ++l) {
    // Every block's h is in place, and no block still reads the previous
    // layer's VN partials (nor, in bf16, this block its W1 and W2).
    cluster.sync();
    if constexpr (kWg) {
      if (tid == 0) {  // this layer's W1 and W2, while the VN stage and the messages run
        mbar_arrive_expect_tx(wbar, w1_bytes + w2_bytes);
        bulk_g2s(w1_s, w1t + size_t(l) * w1_bytes, w1_bytes, wbar);
        bulk_g2s(w2_s, w2t + size_t(l) * w2_bytes, w2_bytes, wbar);
      }
    }
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
        const float e0 = tab_s[kE0Row0 * D + c] + tab_s[kE0Row1 * D + c] +
                         tab_s[kE0Row2 * D + c];
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
      for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
        const int* m = meta_w + e * kMeta;
        const int u = __ldg(m);
        const S* hu = nullptr;
        if (unsigned(u) < unsigned(dm.window)) {
          const int owner = u / kRows;
          const S* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
          hu = base + (u - owner * kRows) * D;
        }
        const float* e1 = bond_row(tab_s, __ldg(m + 2), dm.vocab, D);
        const float* e2 = bond_row(tab_s, __ldg(m + 3), dm.vocab, D);
        const float* e3 = bond_row(tab_s, __ldg(m + 4), dm.vocab, D);
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
      }
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
      // Update MLP on the tensor cores, warpgroup wg over rows 64wg..64wg+63.
      const int wg = tid / 128, w = (tid % 128) / 32, g = lane / 4, q = lane % 4;
      const T* b1_l = b1 + long(l) * dm.hid;
      const T* b2_l = b2 + long(l) * D;
      float o[N2 / 2], z[kHC / 2];
#pragma unroll
      for (int i = 0; i < N2 / 2; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kHC / 2; ++i) z[i] = 0.f;
      mbar_wait(wbar, l & 1);
      for (int c = 0; c < tl.hp / kHC; ++c) {
        wgmma_fence();
        for (int ks = 0; ks < tl.dp / 16; ++ks) {
          const uint64_t da = desc(act_s + (size_t(2 * ks) * kRows + 64 * wg) * 8, kRows * 16, 128);
          const uint64_t db = desc(w1_s + (size_t(2 * ks) * tl.hp + kHC * c) * 8, tl.hp * 16, 128);
          mma_bf16_ss<kHC>(z, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(z);
        // z + b1, relu, bf16: n8 tile j is half (j & 1) of K step j / 2's A.
        uint32_t fa[2][4];
#pragma unroll
        for (int j = 0; j < kHC / 8; ++j) {
          const int col = kHC * c + 8 * j + 2 * q;
          const float c0 = col < dm.hid ? ld(b1_l + col) : 0.f;
          const float c1 = col + 1 < dm.hid ? ld(b1_l + col + 1) : 0.f;
          fa[j / 2][(j & 1) * 2] =
              pack_bf16(fmaxf(z[4 * j] + c0, 0.f), fmaxf(z[4 * j + 1] + c1, 0.f));
          fa[j / 2][(j & 1) * 2 + 1] =
              pack_bf16(fmaxf(z[4 * j + 2] + c0, 0.f), fmaxf(z[4 * j + 3] + c1, 0.f));
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint64_t db = desc(w2_s + size_t(4 * c + 2 * s) * N2 * 8, N2 * 16, 128);
          mma_bf16_rs<N2>(o, fa[s], db, c > 0 || s > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(o);
      // h_s is not read during the MLP, so its rows can be replaced here.
      const int r = 64 * wg + 16 * w + g;
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1);
          if (col < D) {
            float v = o[4 * j + e] + ld(b2_l + col);
            if (l != dm.layers - 1) v = fmaxf(v, 0.f);
            h_s[(r + 8 * (e >> 1)) * D + col] = store<S>(v);
          }
        }
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
          for (int i = 0; i < kRowsPT; ++i) a[i] = act_s[(tr + kTR * i) * D + k];
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
            h_s[r * D + c] = rnd<T>(v);
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

template <typename T, int N2>
cudaError_t launch(const void* meta, const void* h0, const void* pool_gl,
                   const void* tab, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* eps,
                   const void* predw, const void* vn_col, const void* w1t,
                   const void* w2t, void* out, int num_windows, const Dims& dm,
                   cudaStream_t stream) {
  const int csize = dm.window / kRows;
  const size_t bytes = smem_layout(N2 > 0, dm.d, dm.hid, dm.vocab, dm.gmax, dm.tout).total;
  cudaError_t err = cudaFuncSetAttribute(
      gin_ell_kernel<T, N2>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_windows * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, gin_ell_kernel<T, N2>, static_cast<const int*>(meta), static_cast<const T*>(h0),
      static_cast<const int*>(pool_gl), static_cast<const T*>(tab),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps), static_cast<const T*>(predw),
      static_cast<const T*>(vn_col), static_cast<const unsigned char*>(w1t),
      static_cast<const unsigned char*>(w2t), static_cast<float*>(out), dm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gin_ell_max_d() { return kMaxD; }
int gin_ell_rows_per_block() { return kRows; }
int gin_ell_max_cluster() { return kMaxCluster; }

// The bf16 form's packed weight tiles (ops/tiles.py) for width d and hidden
// width hid: dims[0] = D' (K of W1's tile), dims[1] = H' (its rows, and K of
// W2's), dims[2] = N2 (W2's tile rows).
void gin_ell_tiles(int d, int hid, int* dims) {
  const Tiles tl = tiles_of(d, hid);
  dims[0] = tl.dp;
  dims[1] = tl.hp;
  dims[2] = tl.n2;
}

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block of the cluster needs; dtype as in
// gin_ell_launch.
long long gin_ell_smem_bytes(int dtype, int d, int hid, int vocab, int gmax, int tout) {
  return (long long)smem_layout(dtype == 1, d, hid, vocab, gmax, tout).total;
}

// dtype: 0 = float32, 1 = bfloat16 (h0, tables, weights, biases, pred_w,
// vn_col). meta [num_windows*block, 5], pool_gl: int32; eps: float32 [L];
// out: float32 [num_windows*gmax, tout]. vn_col may be null. bfloat16 also
// takes w1t / w2t, W1 and W2 per layer packed into wgmma tiles as
// gin_ell_tiles gives them (float32: null). window must be
// 1..kMaxCluster whole blocks of kRows rows. Returns a cudaError_t.
int gin_ell_launch(int dtype, const void* meta, const void* h0,
                   const void* pool_gl, const void* tab, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* eps, const void* predw, const void* vn_col,
                   const void* w1t, const void* w2t, void* out, int num_windows,
                   int n, int window, int block, int d, int hid, int layers,
                   int vocab, int gmax, int tout, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxCluster ||
      d < 1 || d > kMaxD || num_windows < 1 || block < 0 ||
      (dtype == 1 && (w1t == nullptr || w2t == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, block, d, hid, layers, vocab, gmax, tout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float, 0>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw, vn_col,
                           nullptr, nullptr, out, num_windows, dm, s);
  else if (dtype == 1 && tiles_of(d, hid).n2 == 104)
    err = launch<__nv_bfloat16, 104>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                                     vn_col, w1t, w2t, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, 112>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                                     vn_col, w1t, w2t, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gin_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
