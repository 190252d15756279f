// One whole non-final GAT layer over the ELL layout for Hopper (sm_90a):
// kernel table row 23.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_layer_ell. Same operands, same output: meta [NW*lanes, 5] = (u,
// v, three bond rows; the bond rows unused) per lane, h [n, H*D] head-major,
// s_src and s_tgt [n, H], prev [n, H*D] the previous layer's features,
// spill_both [n, H*D + H] the spill tail's pre-reduced sums (may be null),
// w_skip and w_proj [H*D, H*D] as [out, in], a_mat [H*D, 2H] the next layer's
// block-diagonal score map; out [n, 2*H*D + 2H] = (h_next | feat | s_src' |
// s_tgt') in h's type. Per window row v, head k and lane u -> v, in lane
// order, as csrc/gat_local_message_ell.cu:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))       (raw exp, no max)
//   acc[v][k*D:(k+1)*D] += rnd(score * h_u[...]),  acc[v][H*D+k] += rnd(score)
// then, all in f32 with no rounding in between (the TPU kernel's epilogue):
//   tot  = acc + spill_both;  den = tot[H*D + k], 0 -> 1
//   x    = tot[:H*D] / den + prev . w_skip^T
//   feat = x > 0 ? x : exp(min(x, 0)) - 1                   (ELU)
//   h_next = feat . w_proj^T;  scores = h_next . a_mat
// and the output is rounded once. s_tgt comes in h's type (the TPU kernel
// rounds it: it rides h's gather tile); each lane's [score * h_u | score] is
// rounded before the sum, as the TPU kernel casts it for its scatter matmul.
//
// A lane whose v lies outside the window (a sentinel lane) is skipped, not
// multiplied by a mask: the TPU kernel computes exp(raw) * valid on every
// lane, which is 0 * inf = NaN once raw passes f32 exp's overflow (88.7).
// Here a sentinel lane adds nothing, whatever its score.
//
// What bounds it on this card. Per lane it reads an H*D-wide source row
// (mostly from L2) and 20 B of meta; per row h, prev, spill_both and the
// scores once and 2*H*D + 2H values written. The products are 4*(H*D)^2
// operations a row (16 K at H*D = 64), a few microseconds a launch even on
// the CUDA cores. The message phase is a gather bound by latency (~54 µs a
// launch on the hep10k W=128 buckets, as row 17 alone), and the kernel's
// FMA products and epilogue took as long again (142 µs a launch in all on an
// H100 80GB HBM3 at 700 W, PERF.md): the two products issued 12 shared loads
// for every 32 FMAs, the score map ran as a dependent 64-step chain inside
// the loop over the 136 output columns, and staging both weights as padded
// f32 on every launch held the block to 103 KB. What the design does:
// - the messages: one block of 256 threads per 128 rows of a window (grid
//   NW*W/128, W up to 1024, no cluster: the sources' h sits in device
//   memory, so each block is independent), the walk row 17 runs too
//   (gat_messages.cuh: a half-warp a row where H <= 16, two rows' chains a
//   warp, else a warp a row; four or two consecutive columns a thread; a
//   row's lane sources loaded 16 or 32 at a time and walked by shuffle, four
//   lanes' h_u rows and scores in flight, a row's s_src, spill sums and
//   first sources one row ahead), its f32 sums into shared memory; prev
//   comes into shared memory by 16-byte cp.async issued before the
//   messages and waited for after them (its rows must start 16-byte
//   aligned);
// - bf16: both products on the tensor cores through linear_wgmma.cuh, N =
//   64: x_skip = prev . w_skip^T (A: prev [128, K'] bf16, K' = H*D padded to
//   32; its values and w_skip's are bf16, so the products are exact and
//   only the f32 summation order moves), then the projection from an
//   unrounded f32 feat, as the reference has it: feat is split into hi =
//   bf16(feat) and lo = bf16(feat - hi) and [hi | lo] . [w_proj^T; w_proj^T]
//   runs as one product of depth 2K' (its error about 2^-16 of |feat|, far
//   below the output's bf16 rounding); hi is feat's output column, and the
//   outputs leave as column pairs. The weights are packed once per weight
//   set on the host (ops.local_layer.gat_layer_tiles) into chunks of 32
//   input channels, skip first, and stream through gin_mlp.cuh's ring of
//   bulk copies, issued before the messages. The products run after the messages, so no
//   accumulator is live across the gather. Shared memory at H*D = 64, H =
//   4: the sums 34.8 KB (then h_next in f32), the A tiles 32 KB (prev's
//   tile, dead after the skip product, becomes hi), the ring 6 x 4 KB, a_mat
//   2 KB: ~93 KB, two blocks an SM;
// - f32: both products stay register-tiled FMA (8 rows x 4 columns a
//   thread; TF32 would break the f32 gate of 1e-4), the weights packed once
//   on the host as w^T [K][64] f32 and brought in by one bulk copy;
// - both: the score map scores = h_next . a_mat reads h_next in f32 from
//   shared memory in a pass of its own, one thread per (row, score column).
// The shared-memory carve-up is computed on the host and passed in.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// both products and the weights' copies (as if they were 0), bit 1 skips the
// messages (tot = spill_both); the phase split of chip_smoke.py times the
// kernel with each.

#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gat_messages.cuh"
#include "linear_wgmma.cuh"

namespace {

using namespace hopper;
namespace gm = gat_messages;
namespace lw = linear_wgmma;
using gm::cvt;
using gm::ld;

constexpr int kThreads = 256;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kN = 64;                 // the products' width: the widest H*D
constexpr int kMaxHD = kN;
constexpr int kMaxHeads = 32;          // one head's score per lane of a row's group
constexpr int kHalfHeads = 16;         // the half-warp walk: H <= 16
constexpr int kTR = 16;                // thread rows of the f32 product tile
constexpr int kTC = 16;                // thread columns of the f32 product tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = kN / kTC;      // columns per thread (4)
constexpr int kNoProduct = 1, kNoMessages = 2;  // Dims::knockout bits

static_assert(kRows == lw::kRows && kThreads == lw::kThreads, "the wgmma product's block shape");

struct Dims {
  int n, window, lanes, hd, heads, stages, knockout;
};

// K' of the skip product (H*D padded to whole chunks of 32), the chunks of
// each product and a chunk's bytes (the bf16 form).
struct Geom {
  int kp, skip_chunks, proj_chunks, chunk_bytes;
};

__host__ __device__ inline Geom geom(int hd) {
  const lw::Geom g = lw::geom(hd, kN);
  return Geom{g.kp, g.chunks, 2 * g.chunks, g.chunk_bytes};
}

// The f32 form's row stride of prev (then h_next) in shared memory: H*D
// padded to 4 floats and one 16-byte group more, so a row starts 16-byte
// aligned for cp.async and rows r..r+3 fall in distinct banks.
__host__ __device__ inline int f32_ld(int hd) { return (hd + 3) / 4 * 4 + 4; }

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 form
// (prev's tile and [hi | lo] in the A layout, the weight ring); else prev
// f32 and the packed f32 weights.
struct Smem {
  size_t tot, a, w, amat, lo, ring, bars, total;
};

inline Smem smem_layout(bool wg, int hd, int heads, int stages) {
  const size_t HD = hd, H = heads;
  const Geom g = geom(hd);
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  // The sums [128][HD+H] f32; after feat is formed, h_next [128][HD+1] f32
  // (H >= 1).
  s.tot = take(kRows * (HD + H) * 4);
  // bf16: [hi | lo] [2K'/8][128][8], whose first half is prev's tile until
  // the skip product has read it; f32: prev [128][f32_ld].
  s.a = take(wg ? size_t(kRows) * 2 * g.kp * 2 : kRows * size_t(f32_ld(hd)) * 4);
  s.w = take(wg ? 0 : 2 * HD * kN * 4);  // f32: w_skip^T then w_proj^T, [HD][64] each
  s.amat = take(HD * 2 * H * 4);
  s.lo = take((kRows + 1) * 4);
  s.ring = take(wg ? size_t(stages) * g.chunk_bytes : 0);
  s.bars = take(wg ? size_t(stages) * 8 : 8);  // f32: the weights' copy
  s.total = o;
  return s;
}

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : __fsub_rn(expf(fminf(x, 0.f)), 1.f);
}

// acc[i][m] = sum_k x_s[(tr + kTR*i) * ldx + k] * w_s[k * kN + tc + kTC*m]
__device__ __forceinline__ void tile_product(const float* x_s, int ldx, const float* w_s, int K,
                                             int tr, int tc, float (&acc)[kRowsPT][kColsPT]) {
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[kRowsPT], wv[kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) a[i] = x_s[(tr + kTR * i) * ldx + k];
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) wv[m] = w_s[k * kN + tc + kTC * m];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) acc[i][m] = fmaf(a[i], wv[m], acc[i][m]);
  }
}

// The score map over h_next f32 [128][ldh] in shared memory: one thread a
// (row, score column), written to out's last 2H columns.
template <typename T>
__device__ __forceinline__ void score_pass(const float* hn_s, int ldh, const float* amat_s,
                                           T* __restrict__ out, long row0, const Dims& dm,
                                           int tid) {
  const int HD = dm.hd, H2 = 2 * dm.heads, OW = 2 * HD + H2;
  for (int i = tid; i < kRows * H2; i += kThreads) {
    const int r = i / H2, j = i - r * H2;
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    float v = 0.f;
    for (int k = 0; k < HD; ++k) v = fmaf(hn_s[r * ldh + k], amat_s[k * H2 + j], v);
    out[row * OW + 2 * HD + j] = cvt<T>(v);
  }
}

// f(row, col, v0, v1) for every pair of accumulators at columns col, col +
// 1 (col even, col < ncols; v1 of a column past ncols is that column's, and
// f drops it), as hopper.cuh lays out the m64nN accumulator.
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[kN / 2], int ncols, int tid,
                                              F&& f) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int col = lw::acc_col(tid, j, e);
      if (col < ncols) f(lw::acc_row(tid, e), col, acc[4 * j + e], acc[4 * j + e + 1]);
    }
}

// Columns c and c + 1 of a bf16 row at p (p at column c): one 4-byte store
// where p is 4-byte aligned and both columns are the row's, else one or two
// 2-byte stores.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b, bool both) {
  if (both && !(reinterpret_cast<uintptr_t>(p) & 3)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[0] = __float2bfloat16_rn(a);
  if (both) p[1] = __float2bfloat16_rn(b);
}

// kWg: the bf16 form with both products on wgmma; else f32 with FMA. G:
// the message walk's threads a row (16 where H <= 16, else 32). tiles: the
// layer's packed weights (bf16: the skip then the projection chunks; f32:
// w_skip^T then w_proj^T as [HD][64]). lay: the shared-memory carve-up,
// computed once on the host (smem_layout).
template <typename T, bool kWg, int G>
__global__ void __launch_bounds__(kThreads, 2)
gat_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ s_src, const T* __restrict__ s_tgt,
                     const T* __restrict__ prev, const T* __restrict__ spill,
                     const T* __restrict__ a_mat, const unsigned char* __restrict__ tiles,
                     T* __restrict__ out, Dims dm, Smem lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const int HD = dm.hd, H = dm.heads, dh = dm.hd / dm.heads, tid = threadIdx.x;
  const int TW = HD + H, OW = 2 * HD + 2 * H;
  const bool product = !(dm.knockout & kNoProduct), gather = !(dm.knockout & kNoMessages);
  const Geom g = geom(HD);
  float* tot_s = reinterpret_cast<float*>(smem + lay.tot);    // [kRows][TW] sums, then feat (f32)
  float* hn_s = tot_s;                                        // [kRows][ldh] h_next, after feat
  int ldh = HD + 1;
  float* amat_s = reinterpret_cast<float*>(smem + lay.amat);  // [HD][2H]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] lane runs
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * gm::kMeta;
  const lw::Ring ring{smem + lay.ring, bars, tiles, dm.stages, g.skip_chunks + g.proj_chunks,
                      g.chunk_bytes};

  if (tid == 0 && product) {
    if constexpr (kWg) {
      ring.init();
    } else {
      mbar_init(bars, 1);
      mbar_fence_init();
    }
  }
  for (int i = tid; i < HD * 2 * H; i += kThreads) amat_s[i] = ld(a_mat + i);
  // prev into shared memory, behind the messages: 16-byte cp.async where
  // its rows are whole 16-byte groups (the host checks prev's alignment),
  // rows past n and pad columns zero-filled; else element by element.
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte group
  if constexpr (kWg) {
    // prev's tile [K'/8][128][8] bf16 (a group is a core-matrix row), its
    // pad columns zero, and the lo half's pad columns zero (the feat pass
    // writes columns < HD only).
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
    if (HD % kPer == 0) {
      const int groups = g.kp / kPer;
      for (int i = tid; i < kRows * groups; i += kThreads) {
        const int r = i / groups, c = (i - r * groups) * kPer;
        const long row = row0 + r;
        const bool live = row < dm.n && c < HD;
        cp_async16(a_s + lw::a_index(r, c), live ? prev + row * HD + c : prev, live ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kRows * g.kp; i += kThreads) {
        const int r = i / g.kp, c = i - r * g.kp;
        const long row = row0 + r;
        a_s[lw::a_index(r, c)] =
            row < dm.n && c < HD ? prev[row * HD + c] : __float2bfloat16_rn(0.f);
      }
    }
    const int pad = g.kp - HD;
    for (int i = tid; i < kRows * pad; i += kThreads)
      a_s[lw::a_index(i / pad, g.kp + HD + i % pad)] = __float2bfloat16_rn(0.f);
  } else {
    float* prev_s = reinterpret_cast<float*>(smem + lay.a);  // [kRows][f32_ld]
    const int ldp = f32_ld(HD);
    if (HD % kPer == 0) {
      const int groups = HD / kPer;
      for (int i = tid; i < kRows * groups; i += kThreads) {
        const int r = i / groups, c = (i - r * groups) * kPer;
        const long row = row0 + r;
        cp_async16(prev_s + r * ldp + c, row < dm.n ? prev + row * HD + c : prev,
                   row < dm.n ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kRows * HD; i += kThreads) {
        const int r = i / HD, c = i - r * HD;
        const long row = row0 + r;
        prev_s[r * ldp + c] = row < dm.n ? ld(prev + row * HD + c) : 0.f;
      }
    }
  }
  if (gather)
    lanes::ell_runs<kRows>(meta_w, dm.lanes, part * kRows, lo_s, tid, kThreads);
  __syncthreads();
  if (tid == 0 && product) {
    if constexpr (kWg) {
      ring.prefetch();  // the first S weight chunks, behind the messages
    } else {
      const uint32_t bytes = uint32_t(2 * HD * kN * 4);
      mbar_arrive_expect_tx(bars, bytes);
      bulk_g2s(smem + lay.w, tiles, bytes, bars);
    }
  }

  gm::messages<T, float, G, kMaxHD / G, kRows, false>(
      meta_w, h, s_src, s_tgt, spill, lo_s, tot_s, 0, wrow0, row0, dm.n, dm.window, dm.lanes, dm.hd,
      dm.heads, gather, tid, kThreads);

  if constexpr (kWg) {
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
    cp_async_wait_all();
    fence_proxy_async();  // prev's tile, written here, is read by wgmma
    __syncthreads();      // the sums are whole
    float acc[kN / 2];
    if (product) {
      lw::run<kN>(acc, a_s, ring, 0, g.skip_chunks, tid);
    } else {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    }
    __syncthreads();  // both warpgroups are done with prev's tile
    // feat = ELU(tot / den + x_skip) from the accumulators, columns c and
    // c + 1 at a time: hi over prev's tile, lo beside it, and hi, feat
    // rounded, to out.
    for_each_pair(acc, HD, tid, [&](int r, int c, float v0, float v1) {
      const bool both = c + 1 < HD;
      float feat[2], hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ce = both ? c + e : c;
        float den = tot_s[r * TW + HD + ce / dh];
        if (den == 0.f) den = 1.f;
        feat[e] = elu(__fadd_rn(__fdiv_rn(tot_s[r * TW + ce], den), e ? v1 : v0));
        hi[e] = __bfloat162float(__float2bfloat16_rn(feat[e]));
      }
      store_pair(a_s + lw::a_index(r, c), hi[0], hi[1], both);
      store_pair(a_s + lw::a_index(r, g.kp + c), __fsub_rn(feat[0], hi[0]),
                 __fsub_rn(feat[1], hi[1]), both);
      if (row0 + r < dm.n) store_pair(out + (row0 + r) * OW + HD + c, hi[0], hi[1], both);
    });
    fence_proxy_async();  // [hi | lo], written here, is read by wgmma
    __syncthreads();      // and the sums are dead
    if (product) {
      lw::run<kN>(acc, a_s, ring, g.skip_chunks, g.proj_chunks, tid);
    }
    for_each_pair(acc, HD, tid, [&](int r, int c, float v0, float v1) {
      const bool both = c + 1 < HD;
      hn_s[r * (HD + 1) + c] = v0;
      if (both) hn_s[r * (HD + 1) + c + 1] = v1;
      if (row0 + r < dm.n) store_pair(out + (row0 + r) * OW + c, v0, v1, both);
    });
  } else {
    float* prev_s = reinterpret_cast<float*>(smem + lay.a);  // prev, then h_next
    const float* w_s = reinterpret_cast<const float*>(smem + lay.w);
    const int ldp = f32_ld(HD);
    cp_async_wait_all();
    __syncthreads();  // the sums and prev are whole
    const int tr = tid / kTC, tc = tid % kTC;
    float acc[kRowsPT][kColsPT];
    if (product) {
      mbar_wait(bars, 0);
      tile_product(prev_s, ldp, w_s, HD, tr, tc, acc);
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
    }
    // feat = ELU(tot / den + x_skip), written over the sums in place: a
    // thread reads only its own outputs' sums and the den columns.
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const int r = tr + kTR * i;
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        if (c >= HD) continue;
        float den = tot_s[r * TW + HD + c / dh];
        if (den == 0.f) den = 1.f;
        tot_s[r * TW + c] = elu(__fadd_rn(__fdiv_rn(tot_s[r * TW + c], den), acc[i][m]));
      }
    }
    __syncthreads();  // feat is whole; prev's readers are done
    if (product) tile_product(tot_s, TW, w_s + HD * kN, HD, tr, tc, acc);
    // h_next over prev; then out = (h_next | feat), rounded once.
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        if (c < HD) prev_s[(tr + kTR * i) * ldp + c] = acc[i][m];
      }
    __syncthreads();
    for (int i = tid; i < kRows * 2 * HD; i += kThreads) {
      const int r = i / (2 * HD), c = i - r * 2 * HD;
      const long row = row0 + r;
      if (row >= dm.n) break;
      const float v = c < HD ? prev_s[r * ldp + c] : tot_s[r * TW + c - HD];
      out[row * OW + c] = cvt<T>(v);
    }
    hn_s = prev_s;
    ldh = ldp;
  }
  __syncthreads();  // h_next is whole
  score_pass<T>(hn_s, ldh, amat_s, out, row0, dm, tid);
}

// The form's kernel for `heads` heads: the half-warp walk where H <= 16.
template <typename T, bool kWg>
auto kernel_of(int heads) {
  return heads <= kHalfHeads ? gat_layer_ell_kernel<T, kWg, 16> : gat_layer_ell_kernel<T, kWg, 32>;
}

template <typename T, bool kWg>
cudaError_t launch_form(const void* meta, const void* h, const void* s_src, const void* s_tgt,
                        const void* prev, const void* spill, const void* a_mat,
                        const void* tiles, void* out, int num_windows, const Dims& dm,
                        const Smem& lay, cudaStream_t stream) {
  kernel_of<T, kWg>(dm.heads)<<<num_windows * (dm.window / kRows), kThreads, lay.total, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(s_src),
      static_cast<const T*>(s_tgt), static_cast<const T*>(prev), static_cast<const T*>(spill),
      static_cast<const T*>(a_mat), static_cast<const unsigned char*>(tiles),
      static_cast<T*>(out), dm, lay);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_layer_ell_max_d() { return kMaxHD; }
int gat_layer_ell_max_heads() { return kMaxHeads; }
int gat_layer_ell_rows_per_block() { return kRows; }
int gat_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The bf16 form's weight chunks at H*D = hd: dims = (K', the skip chunks,
// the projection chunks, the bytes of a chunk).
void gat_layer_ell_tile_dims(int hd, int* dims) {
  const Geom g = geom(hd);
  dims[0] = g.kp;
  dims[1] = g.skip_chunks;
  dims[2] = g.proj_chunks;
  dims[3] = g.chunk_bytes;
}

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_layer_ell_smem_optin(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gat_layer_ell_smem_per_sm(int device) {
  return hopper::device_bytes(device, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
}

// Dynamic shared memory (bytes) one block needs; dtype as in
// gat_layer_ell_launch, stages the bf16 form's weight ring.
long long gat_layer_ell_smem_bytes(int dtype, int hd, int heads, int stages) {
  return (long long)smem_layout(dtype == 1, hd, heads, stages).total;
}

// Opt every form in to `bytes` of dynamic shared memory on `device` (once
// per launch plan). Returns a cudaError_t.
int gat_layer_ell_prepare(long long bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  for (int heads : {kHalfHeads, kMaxHeads}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_of<float, false>(heads),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_of<__nv_bfloat16, true>(heads),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  }
  return int(err);
}

// The blocks of the form of `dtype` at `heads` heads with `bytes` of
// dynamic shared memory that fit one SM, in out[0]. Returns a cudaError_t.
int gat_layer_ell_occupancy(int dtype, int heads, long long bytes, int* out) {
  if (dtype == 0)
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel_of<float, false>(heads), kThreads, size_t(bytes)));
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel_of<__nv_bfloat16, true>(heads), kThreads, size_t(bytes)));
}

// dtype: 0 = float32, 1 = bfloat16 (h, s_src, s_tgt, prev, spill, a_mat,
// out). meta [num_windows*lanes, 5]: int32; spill may be null (no spill
// tail); out [n, 2*hd + 2*heads]. tiles: the layer's packed weights
// (ops.local_layer.gat_layer_tiles): bfloat16 the skip then the projection
// chunks as gat_layer_ell_tile_dims gives them, streamed through a ring of
// `stages` buffers (at least two unless there is one chunk in all);
// float32 w_skip^T and w_proj^T as [hd][64] f32 (stages 0). window must be
// 1..kMaxWindowBlocks whole blocks of kRows rows; the host opted the kernel
// in to the block's shared memory first (gat_layer_ell_prepare). knockout: 0
// (see Dims). Returns a cudaError_t.
int gat_layer_ell_launch(int dtype, const void* meta, const void* h, const void* s_src,
                         const void* s_tgt, const void* prev, const void* spill,
                         const void* a_mat, const void* tiles, void* out, int num_windows,
                         int n, int window, int lanes, int hd, int heads, int stages,
                         int knockout, int device, void* stream) {
  const Geom g = geom(hd);
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      hd < 1 || hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads ||
      num_windows < 1 || lanes < 0 ||
      (!(knockout & kNoProduct) &&
       (tiles == nullptr ||
        (dtype == 1 && stages < lw::min_stages(g.skip_chunks + g.proj_chunks)))))
    return int(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, hd, heads, dtype == 1 ? stages : 0, knockout};
  const Smem lay = smem_layout(dtype == 1, hd, heads, dm.stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_form<float, false>(meta, h, s_src, s_tgt, prev, spill, a_mat, tiles, out,
                                    num_windows, dm, lay, s);
  else if (dtype == 1)
    err = launch_form<__nv_bfloat16, true>(meta, h, s_src, s_tgt, prev, spill, a_mat, tiles,
                                           out, num_windows, dm, lay, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
