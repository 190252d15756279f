// GAT's edge-softmax sums, the message walk shared by kernel table rows 17
// (gat_local_message_ell.cu, the sums to device memory in h's type), 23
// (gat_local_layer_ell.cu, the f32 sums into shared memory, before the
// layer's products) and 21 (gat_local_message_slots.cu, over the slot
// layout, divided or not). The walk is templated on where a row's lanes
// come from (the Walk policy):
//
// - EllRuns (rows 17, 23): meta [NW*lanes, 5] = (u, v, three bond rows; the
//   bond rows unused) per lane, the lanes of a window one run sorted by v
//   (pad lanes, v = W, last), so each row's lanes are one contiguous run,
//   found by lanes::ell_runs. A lane whose u lies outside [0, W), or on a
//   padding row, reads a zero source and a zero s_tgt (its score still
//   counts); a lane whose v lies outside the window (a sentinel lane) is in
//   no row's run and adds nothing, whatever its score. Each lane's [score *
//   h_u | score] is rounded to h's type before the f32 sum, as the TPU
//   kernels cast it for their scatter matmul.
// - SlotRows (row 21): slot_stack [NW*S*W], slot_stack[w][s][r] the s-th
//   in-window source of row r (sentinel W: an empty slot), S <= 8. A row's S
//   slots are loaded by its group's first S threads in one go and the
//   valid ones packed in slot order by one ballot, so an empty slot is
//   skipped and adds nothing, whatever its score; a source on a padding row
//   reads as zero (its score counts, as the plain version's zero-padded
//   rows do). [score * h_u | score] are summed in f32 unrounded, as the TPU
//   kernel's dense slot sums are.
//
// h [n, H*D] head-major, s_src and s_tgt [n, H] in h's type. Per window row
// v, head k and lane (or valid slot) u -> v, in lane (slot) order:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))     (raw exp, no max)
//   num[v][k*D:(k+1)*D] += score * h_u[...],  den[v][k] += score
// with f32 sums. The TPU kernels compute exp(raw) * valid on every lane,
// which is 0 * inf = NaN once raw passes f32 exp's overflow (88.7); here a
// sentinel lane or an empty slot is skipped before the exp.
//
// The walk. The block's rows run in groups of G threads a row (G = 32: a
// warp a row; G = 16: a half-warp a row, two rows a warp), each thread
// holding C consecutive columns of H*D (loaded and stored as one vector
// where aligned) and, thread k < H of the group, head k's score, computed
// once a lane and handed to the head's columns by shuffle, and its sum.
// A row's lane sources are loaded G at a time, one a thread, and walked by
// shuffle, kBatch lanes' h_u rows and s_tgt in flight before their sums,
// which stay in lane order. A row's s_src, spill sums and first G lane
// sources (its packed slots) are loaded one row ahead, so a row's chain
// starts at its first gather.
//
// What bounds it on this card: the latency of the dependent gathers (the
// lanes' sources, then h_u and s_tgt), not the bytes: per lane 20 B of meta
// (4 B a slot), an H*D-wide source row, mostly from L2, and H source scores.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace gat_messages {

constexpr int kMeta = lanes::kEllMeta;  // ints per lane: u, v, three bond rows
constexpr int kBatch = 4;  // a row's lanes whose sources are in flight at once

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(cvt<T>(x)); }

__device__ __forceinline__ float leaky_exp(float raw) {
  return expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
}

// The widest aligned vector (bytes) that C elements of T make.
template <typename T, int C>
__host__ __device__ constexpr int vec_bytes() {
  return (C * sizeof(T)) % 16 == 0 ? 16 : (C * sizeof(T)) % 8 == 0 ? 8
         : (C * sizeof(T)) % 4 == 0 ? 4 : 0;
}
template <int B>
using Vec = typename std::conditional<
    B == 16, uint4, typename std::conditional<B == 8, uint2, unsigned>::type>::type;

// x[c] = p[c] for the `valid` first of C consecutive columns, 0 past them:
// one vector load where all C are real and p is aligned to it.
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* p, int valid, float (&x)[C]) {
  constexpr int kB = vec_bytes<T, C>();
  if constexpr (kB > 0) {
    if (valid == C && !(reinterpret_cast<uintptr_t>(p) % kB)) {
      Vec<kB> w[C * sizeof(T) / kB];
#pragma unroll
      for (int i = 0; i < int(C * sizeof(T) / kB); ++i)
        w[i] = __ldg(reinterpret_cast<const Vec<kB>*>(p) + i);
      const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = to_f(e[c]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = c < valid ? ld(p + c) : 0.f;
}

// p[c] = v[c] for the `valid` first of C consecutive columns: one vector
// store where all C are real and p is aligned to it.
template <typename O, int C>
__device__ __forceinline__ void store_cols(O* p, int valid, const float (&v)[C]) {
  constexpr int kB = vec_bytes<O, C>();
  if constexpr (kB > 0) {
    if (valid == C && !(reinterpret_cast<uintptr_t>(p) % kB)) {
      Vec<kB> w[C * sizeof(O) / kB];
      O* e = reinterpret_cast<O*>(w);
#pragma unroll
      for (int c = 0; c < C; ++c) e[c] = cvt<O>(v[c]);
#pragma unroll
      for (int i = 0; i < int(C * sizeof(O) / kB); ++i) reinterpret_cast<Vec<kB>*>(p)[i] = w[i];
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < valid) p[c] = cvt<O>(v[c]);
}

// A row's lanes as a Walk hands them over: its run [e0, e1) of lanes and
// the group's thread t's first source u (-1: a zero source).
struct Run {
  int e0, e1, u;
};

// The ELL runs of rows 17 and 23: row r's lanes are meta_w's [lo_s[r],
// lo_s[r+1]) (lanes::ell_runs), each lane's products rounded to h's type
// before the sum.
struct EllRuns {
  const int* meta_w;  // the window's lanes
  const int* lo_s;    // the block's rows' runs
  int lanes;
  static constexpr bool kRoundLane = true;
  static constexpr bool kWarpWide = false;  // run() is called for real rows only

  // Lane e's source if e < e1 and its u is a real row of the window, else -1.
  __device__ __forceinline__ int source(int e, int e1, long wrow0, int window, int n) const {
    const int u = e < e1 ? __ldg(meta_w + e * kMeta) : -1;
    return unsigned(u) < unsigned(window) && wrow0 + u < n ? u : -1;
  }

  // Block row r's run and the first G lanes' sources, one a thread.
  __device__ __forceinline__ Run run(int r, bool, int t, int, unsigned, long wrow0, int window,
                                     int n, bool gather) const {
    int e1 = lo_s[r + 1];
    e1 = e1 < 0 ? 0 : e1 > lanes ? lanes : e1;
    int e0 = lo_s[r];
    e0 = e0 < 0 ? 0 : e0 > e1 ? e1 : e0;
    if (!gather) e1 = e0;
    return Run{e0, e1, source(e0 + t, e1, wrow0, window, n)};
  }
};

// The slot rows of row 21: window row wr's slot s is slot_w[s * window +
// wr], sentinel W for an empty slot; the valid slots packed in slot order,
// their products summed unrounded.
struct SlotRows {
  const int* slot_w;  // the window's slot stack [S][W]
  int wr0;            // the block's first window row
  int slots;
  static constexpr bool kRoundLane = false;
  static constexpr bool kWarpWide = true;  // run() holds a ballot: every row calls it

  // A row's sources are all in its first chunk (S <= kMaxSlots <= G).
  __device__ __forceinline__ int source(int, int, long, int, int) const { return -1; }

  // Block row r's valid slots, packed: the run [0, count) and thread t's
  // t-th valid source (`real`: r is a real row of the block; none if not).
  // Threads t < S load slot t; one ballot over the warp finds the group's
  // valid ones (every thread of the warp calls it; gmask: the group's bits,
  // `base` its first lane).
  __device__ __forceinline__ Run run(int r, bool real, int t, int base, unsigned gmask, long wrow0,
                                     int window, int n, bool gather) const {
    int u = window;
    if (real && gather && t < slots) u = __ldg(slot_w + long(t) * window + wr0 + r);
    const unsigned valid =
        (__ballot_sync(0xffffffffu, unsigned(u) < unsigned(window)) >> base) & gmask;
    unsigned m = valid;  // drop the t lowest: the t-th valid slot is the lowest left
#pragma unroll
    for (int i = 0; i < lanes::kMaxSlots; ++i)
      if (i < t) m &= m - 1;
    const int v = __shfl_sync(0xffffffffu, u, base + (m ? __ffs(m) - 1 : 0));
    const int count = __popc(valid);
    return Run{0, count, t < count && wrow0 + v < n ? v : -1};
  }
};

// The sums of a block's R rows (window rows row0 - wrow0 ..), the lanes of
// each as `walk` gives them. kDivide: row r's num / den (a zero den taken
// as 1) written to dst + (dst_row0 + r) * H*D; else [the H*D sums | the H
// score sums] + the spill tail's sums (spill [n, H*D + H], or null) to dst +
// (dst_row0 + r) * (H*D + H). kGlobal: to device memory in O = h's type,
// real rows only; else f32 into shared memory, every row (a padding row's
// zero). G threads a row, C consecutive columns a thread (H*D <= G*C, H <=
// G); the block's `nthreads` threads (a multiple of 32, with R a multiple
// of nthreads / G). gather = false: no lane is walked (dst = the spill
// sums, or zero; a timing knob).
template <typename T, typename O, int G, int C, int R, bool kGlobal, bool kDivide = false,
          typename Walk>
__device__ __forceinline__ void messages(const Walk& walk, const T* __restrict__ h,
                                         const T* __restrict__ s_src,
                                         const T* __restrict__ s_tgt, const T* __restrict__ spill,
                                         O* dst, long dst_row0, long wrow0, long row0, int n,
                                         int window, int hd, int heads, bool gather, int tid,
                                         int nthreads) {
  static_assert(G == 16 || G == 32, "a row's group is a warp or a half-warp");
  const int TW = hd + heads, dh = hd / heads;
  const int lane = tid % 32, t = lane % G, base = lane - t;  // base: the group's first lane
  const unsigned gmask = G == 32 ? 0xffffffffu : 0xffffu;
  const int group = tid / G, groups = nthreads / G;
  const int c0 = t * C;
  const int ncol = hd - c0 < 0 ? 0 : hd - c0 < C ? hd - c0 : C;  // this thread's real columns
  // The shuffle source of each column's score: its head's thread; one
  // shuffle a lane where the thread's C columns share a head.
  int src[C];
#pragma unroll
  for (int c = 0; c < C; ++c) src[c] = base + (c0 + c < hd ? (c0 + c) / dh : 0);
  const bool one_head = dh % C == 0;

  // A row's inputs, loaded one row ahead of their use: s_src, the spill
  // sums, its run and its first G lane sources (-1: a zero source).
  struct RowIn {
    float ss, sp[C], sd;
    Run run;
  };
  auto row_in = [&](int r) {
    RowIn in{0.f, {}, 0.f, Run{0, 0, -1}};
#pragma unroll
    for (int c = 0; c < C; ++c) in.sp[c] = 0.f;
    const long row = row0 + r;
    const bool real = r < R && row < n;
    auto run = [&] { in.run = walk.run(r, real, t, base, gmask, wrow0, window, n, gather); };
    if constexpr (Walk::kWarpWide) run();
    if (!real) return in;
    if constexpr (!Walk::kWarpWide) run();
    if (t < heads) in.ss = ld(s_src + row * heads + t);
    if (spill == nullptr) return in;
    const T* sp = spill + row * TW;
    load_cols<T, C>(sp + c0, ncol, in.sp);
    if (t < heads) in.sd = ld(sp + hd + t);
    return in;
  };
  // The larger of a value over the warp's two groups (G = 16).
  auto warp_max = [](int x) {
    if constexpr (G < 32) {
      const int y = __shfl_xor_sync(0xffffffffu, x, 16);
      return x > y ? x : y;
    }
    return x;
  };
  // A lane's term, rounded to h's type where the walk's layout does.
  auto term = [](float x) { return Walk::kRoundLane ? rnd<T>(x) : x; };

  RowIn next = row_in(group);
  for (int r = group; r < R; r += groups) {
    const RowIn in = next;
    next = row_in(r + groups);
    const int e0 = in.run.e0, e1 = in.run.e1;
    float num[C];
#pragma unroll
    for (int c = 0; c < C; ++c) num[c] = 0.f;
    float den = 0.f;  // thread k < H: head k's
    const int chunks = warp_max((e1 - e0 + G - 1) / G);
    for (int ch = 0; ch < chunks; ++ch) {
      const int first = e0 + ch * G;
      const int cnt = e1 - first < 0 ? 0 : e1 - first < G ? e1 - first : G;
      const int my_u = ch == 0 ? in.run.u : walk.source(first + t, e1, wrow0, window, n);
      const int steps = warp_max(cnt);
      for (int i0 = 0; i0 < steps; i0 += kBatch) {
        float x[kBatch][C], st[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int u = __shfl_sync(0xffffffffu, my_u, base + ((i0 + b) & (G - 1)));
          const bool ok = i0 + b < cnt && u >= 0;
          st[b] = ok && t < heads ? ld(s_tgt + (wrow0 + u) * heads + t) : 0.f;
          load_cols<T, C>(h + (wrow0 + (ok ? u : 0)) * hd + c0, ok ? ncol : 0, x[b]);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (i0 + b >= steps) break;  // the same for the whole warp
          const bool live = i0 + b < cnt;
          float sc = 0.f;
          if (t < heads) {
            sc = leaky_exp(__fadd_rn(in.ss, st[b]));
            if (live) den = __fadd_rn(den, term(sc));
          }
          float sc_c[C];
          if (one_head) {
            const float s = __shfl_sync(0xffffffffu, sc, src[0]);
#pragma unroll
            for (int c = 0; c < C; ++c) sc_c[c] = s;
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) sc_c[c] = __shfl_sync(0xffffffffu, sc, src[c]);
          }
          if (live) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (c < ncol) num[c] = __fadd_rn(num[c], term(__fmul_rn(sc_c[c], x[b][c])));
          }
        }
      }
    }
    const long row = row0 + r;
    auto add_spill = [&] {
      if (spill == nullptr) return;
#pragma unroll
      for (int c = 0; c < C; ++c) num[c] = __fadd_rn(num[c], in.sp[c]);
      den = __fadd_rn(den, in.sd);
    };
    if constexpr (kDivide) {
      add_spill();
      // Each column's head's den, by shuffle, before any thread leaves the row.
      if (one_head) {
        const float dv = __shfl_sync(0xffffffffu, den, src[0]);
#pragma unroll
        for (int c = 0; c < C; ++c) num[c] = __fdiv_rn(num[c], dv == 0.f ? 1.f : dv);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float dv = __shfl_sync(0xffffffffu, den, src[c]);
          num[c] = __fdiv_rn(num[c], dv == 0.f ? 1.f : dv);
        }
      }
    }
    if (kGlobal && row >= n) continue;
    if constexpr (!kDivide) add_spill();
    O* d = dst + (dst_row0 + r) * (kDivide ? hd : TW);
    store_cols<O, C>(d + c0, ncol, num);
    if (!kDivide && t < heads) d[hd + t] = cvt<O>(den);
  }
}

}  // namespace gat_messages
