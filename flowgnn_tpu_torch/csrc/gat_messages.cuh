// GAT's edge-softmax sums over the ELL layout: the message walk shared by
// kernel table rows 17 (gat_local_message_ell.cu, the sums to device memory
// in h's type) and 23 (gat_local_layer_ell.cu, the f32 sums into shared
// memory, before the layer's products).
//
// Layout: meta [NW*lanes, 5] = (u, v, three bond rows; the bond rows unused)
// per lane, the lanes of a window one run sorted by v (pad lanes, v = W,
// last), so each row's lanes are one contiguous run; h [n, H*D] head-major,
// s_src and s_tgt [n, H] in h's type. Per window row v, head k and lane u ->
// v, in lane order:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))     (raw exp, no max)
//   sum[v][k*D:(k+1)*D] += rnd(score * h_u[...]),  sum[v][H*D + k] += rnd(score)
// with f32 sums; each lane's [score * h_u | score] is rounded to h's type
// before the sum, as the TPU kernels cast it for their scatter matmul. A
// lane whose u lies outside [0, W), or on a padding row, reads a zero source
// and a zero s_tgt (its score still counts); a lane whose v lies outside the
// window (a sentinel lane) is in no row's run and adds nothing, whatever its
// score: the TPU kernels compute exp(raw) * valid on every lane, which is
// 0 * inf = NaN once raw passes f32 exp's overflow (88.7).
//
// The walk. The block's rows run in groups of G threads a row (G = 32: a
// warp a row; G = 16: a half-warp a row, two rows a warp), each thread
// holding C consecutive columns of H*D (loaded and stored as one vector
// where aligned) and, thread k < H of the group, head k's score and its sum.
// A row's lane sources are loaded G at a time, one a thread, and walked by
// shuffle, kBatch lanes' h_u rows and s_tgt in flight before their sums,
// which stay in lane order. A row's s_src, spill sums and the first G lane
// sources are loaded one row ahead, so a row's chain starts at shared
// memory. The runs come from lanes::ell_runs.
//
// What bounds it on this card: the latency of the dependent gathers (meta,
// then h_u and s_tgt), not the bytes: per lane 20 B of meta, an H*D-wide
// source row, mostly from L2, and H source scores.

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

// The sums of a block's R rows (window rows row0 - wrow0 ..), row r's
// written to dst + (dst_row0 + r) * (H*D + H) as [the H*D sums | the H score
// sums] + the spill tail's sums (spill [n, H*D + H], or null): kGlobal, to
// device memory in O = h's type, real rows only; else f32 into shared
// memory, every row (a padding row's zero). G threads a row, C consecutive
// columns a thread (H*D <= G*C, H <= G); the block's `nthreads` threads
// (a multiple of 32, with R a multiple of nthreads / G). gather = false:
// no lane is walked (dst = the spill sums; a timing knob).
template <typename T, typename O, int G, int C, int R, bool kGlobal>
__device__ __forceinline__ void messages(const int* __restrict__ meta_w, const T* __restrict__ h,
                                         const T* __restrict__ s_src, const T* __restrict__ s_tgt,
                                         const T* __restrict__ spill, const int* lo_s, O* dst,
                                         long dst_row0, long wrow0, long row0, int n, int window,
                                         int lanes, int hd, int heads, bool gather, int tid,
                                         int nthreads) {
  static_assert(G == 16 || G == 32, "a row's group is a warp or a half-warp");
  const int TW = hd + heads, dh = hd / heads;
  const int lane = tid % 32, t = lane % G, base = lane - t;  // base: the group's first lane
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
  // sums, its run and its first G lane sources (-1: outside the window or a
  // padding row, read as zero).
  struct RowIn {
    float ss, sp[C], sd;
    int e0, e1, u;
  };
  auto source = [&](int e, int e1) {
    int u = e < e1 ? __ldg(meta_w + e * kMeta) : -1;
    return unsigned(u) < unsigned(window) && wrow0 + u < n ? u : -1;
  };
  auto row_in = [&](int r) {
    RowIn in{0.f, {}, 0.f, 0, 0, -1};
#pragma unroll
    for (int c = 0; c < C; ++c) in.sp[c] = 0.f;
    const long row = row0 + r;
    if (r >= R || row >= n) return in;
    int e1 = lo_s[r + 1];
    e1 = e1 < 0 ? 0 : e1 > lanes ? lanes : e1;
    int e0 = lo_s[r];
    e0 = e0 < 0 ? 0 : e0 > e1 ? e1 : e0;
    in.e0 = e0;
    in.e1 = gather ? e1 : e0;
    in.u = source(in.e0 + t, in.e1);
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

  RowIn next = row_in(group);
  for (int r = group; r < R; r += groups) {
    const RowIn in = next;
    next = row_in(r + groups);
    float num[C];
#pragma unroll
    for (int c = 0; c < C; ++c) num[c] = 0.f;
    float den = 0.f;  // thread k < H: head k's
    const int chunks = warp_max((in.e1 - in.e0 + G - 1) / G);
    for (int ch = 0; ch < chunks; ++ch) {
      const int first = in.e0 + ch * G;
      const int cnt = in.e1 - first < 0 ? 0 : in.e1 - first < G ? in.e1 - first : G;
      const int my_u = ch == 0 ? in.u : source(first + t, in.e1);
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
            if (live) den = __fadd_rn(den, rnd<T>(sc));
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
              if (c < ncol) num[c] = __fadd_rn(num[c], rnd<T>(__fmul_rn(sc_c[c], x[b][c])));
          }
        }
      }
    }
    const long row = row0 + r;
    if (kGlobal && row >= n) continue;
    if (spill != nullptr) {
#pragma unroll
      for (int c = 0; c < C; ++c) num[c] = __fadd_rn(num[c], in.sp[c]);
      den = __fadd_rn(den, in.sd);
    }
    O* d = dst + (dst_row0 + r) * TW;
    store_cols<O, C>(d + c0, ncol, num);
    if (t < heads) d[hd + t] = cvt<O>(den);
  }
}

}  // namespace gat_messages
