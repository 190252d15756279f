// One GIN / GIN-VN layer for Hopper (sm_90a): the kernel body of the
// per-layer GIN kernels, kernel table rows 13 (gin_local_layer_ell.cu), 10
// and 12 (gin_local_layer_blocks.cu) and 25 (gin_layer_fused.cu). They
// compute one layer and differ only in how a block finds and reads its rows'
// lanes, the lane walk, a template policy here:
// - EllBondWalk (row 13): the ELL layout's meta [NW*lanes, 5] = (u, v, three
//   bond-table rows); each lane's bond embedding is the sum of its three
//   rows of this layer's table, staged in shared memory as f32;
// - BlockWalk<T, true> (rows 10 and 12): lanes in blocks of `block`, each
//   block belonging to one window (block_window [NB] non-decreasing, found by
//   binary search; null: window w owns block w), the lane's bond embedding
//   given per lane (vals [P, D] in h's type);
// - BlockWalk<T, false> (row 25): the same blocks, each lane's message given
//   (vals: relu(h_u + ee), already rounded), so there is nothing to gather.
// Within a window's run of lanes, lanes are stably sorted by destination row
// v, pad lanes (v = W, the sentinel) last, so each row's lanes are one
// contiguous run. Per window row v over its lanes u -> v in lane order:
//   acc = sum rnd(relu(h_u + ee))   (row 25: acc = sum vals)
//   act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z   = rnd(relu(act . w1^T + b1))              [D] -> [H]
//   out = rnd(z . w2^T + b2), with a ReLU when final_relu
// with f32 sums and products. Rounding points are the TPU kernels': each
// lane's message before the f32 sum, act, and z. A lane whose u lies outside
// [0, W) reads a zero source and one whose v does lands nowhere, as the TPU
// kernels' one-hot gather and scatter give.
//
// Design: h lives in device memory between layers, so the kernel needs no
// cluster: one block of 256 threads (two warpgroups) per 128 rows of a
// window (grid NW*W/128, W a whole number of 128-row tiles up to 1024). The
// TPU kernels walk the lane blocks in order on one core and carry a window's
// accumulator from grid step to grid step; here each block finds its rows'
// lane runs by binary search on v, then sums each row's lanes one warp per
// row in f32, with no atomics: deterministic, in lane order. Each lane of the
// warp holds column pairs (2p, 2p+1), so a source row of h and a lane's vals
// row are read as bf16 (or float) pairs.
// - bf16: act is written as bf16 straight into wgmma's A layout [D'/8][128][8]
//   (28.7 KB at D = 100) and the update MLP is gin_mlp.cuh's, on the tensor
//   cores, this layer's weight chunks (packed once per weight set on the
//   host) streamed through a ring of S buffers (13.8 KB each at D = 100)
//   whose first S loads are issued before the messages. The host takes the
//   largest S <= C (the chunks, 7 at H = 200) that keeps two blocks an SM, so
//   a launch of a few hundred blocks runs in one wave on 132 SMs; registers
//   are capped at 128 a thread for the same reason.
// - f32: act stays f32 [128][D] and the MLP is register-tiled FMA (8 rows x
//   7 columns per thread), w1 and w2 staged through shared memory in chunks
//   of 32 hidden units (TF32 would break the f32 gate of 1e-4).
// The shared-memory carve-up is computed on the host and passed in.
//
// What bounds it on this card: per 128 rows the MLP is 4*128*D*H operations
// (10.2 M at D=100, H=200) against a few D-wide lane reads per row; device
// memory moves the lanes, h, m_spill and out once. In bf16 the MLP on the
// tensor cores takes a few microseconds a launch, so the lane gathers'
// latency and the block's fixed costs (the run search, the ring's first
// copies) bound it; in f32 the FMA MLP on the CUDA cores does.
//
// Dims::knockout is a timing knob, never set on the model path: bit 0 skips
// the MLP (and the weight ring; out is not written), bit 1 skips the
// messages (act = rnd(m_spill + (1+eps) h)); the phase split of
// chip_smoke.py times the kernel with each.
//
// The messages-only form (kMessages, a template parameter, compiled out of
// rows 10, 12, 13 and 25 by `if constexpr`): the same lane walk and the same
// per-row f32 sums in lane order, written straight to device memory as
//   out_v = rnd(sum rnd(relu(h_u + ee)) + m_spill_v)
// with no (1+eps) h_v term, no MLP and no weight ring: the TPU kernels'
// pass-through epilogue (gin_local_message_ell, and local_scatter_apply_ell
// as the ELL stage bench drives it). Its block's shared memory holds the
// walk's own bytes and the row runs only (msg_smem_layout: 5.7 KB with row
// 13's table at D = 100, 0.5 KB with per-lane ee), so registers and threads,
// not shared memory, set its blocks an SM. What bounds it: bytes; per lane a
// D-wide source row (and ee) read, per row h's and m_spill's rows read and
// out written once; two operations a lane and column.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gin_mlp.cuh"
#include "hopper.cuh"

namespace gin_layer {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 MLP tile
constexpr int kTC = 16;                // thread columns of the f32 MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneP = (kMaxD / 2 + 31) / 32;  // column pairs per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kNoMlp = 1, kNoMessages = 2;  // Dims::knockout bits

static_assert(kMaxD == gin_mlp::kMaxD && kRows == gin_mlp::kRows && kThreads == gin_mlp::kThreads,
              "the bf16 MLP's block shape");

struct Dims {
  int n, window, d, hid, final_relu, stages, knockout;
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 form (act
// bf16 in the A layout, the weight ring); else act f32 and the FMA MLP's
// chunk tiles. ext: the lane walk's own bytes (row 13's bond table).
struct Smem {
  size_t act, ext, lo, hid, w1c, w2c, b1c, ring, bars, total;
};

// The messages-only form's carve-up: the walk's own bytes and the row runs.
inline Smem msg_smem_layout(size_t ext) {
  Smem s{};
  s.ext = 0;
  s.lo = (ext + 15) / 16 * 16;
  s.total = s.lo + ((kRows + 1) * 4 + 15) / 16 * 16;
  return s;
}

inline Smem smem_layout(bool wg, int d, int hid, size_t ext, int stages) {
  const size_t D = d;
  const gin_mlp::Geom gm = gin_mlp::geom(d, hid);
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.act = take(kRows * (wg ? size_t(gm.dp) * 2 : D * 4));
  s.ext = take(ext);
  s.lo = take((kRows + 1) * 4);
  s.hid = take(wg ? 0 : kRows * kHC * 4);
  s.w1c = take(wg ? 0 : kHC * (D + 1) * 4);
  s.w2c = take(wg ? 0 : D * (kHC + 1) * 4);
  s.b1c = take(wg ? 0 : kHC * 4);
  s.ring = take(wg ? size_t(stages) * gm.chunk_bytes : 0);
  s.bars = take(wg ? size_t(stages) * 8 : 0);
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Columns c and c + 1 (c even) of a row of `D` values in device memory:
// one pair load when D is even (the host checks that the row then starts
// 4 or 8 bytes aligned), else two loads; the second is 0 past the row.
__device__ __forceinline__ float2 ld_pair(const float* row, int c, int D) {
  if (!(D & 1)) return __ldg(reinterpret_cast<const float2*>(row + c));
  return make_float2(__ldg(row + c), c + 1 < D ? __ldg(row + c + 1) : 0.f);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* row, int c, int D) {
  if (!(D & 1)) return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + c)));
  return make_float2(__bfloat162float(row[c]), c + 1 < D ? __bfloat162float(row[c + 1]) : 0.f);
}
// The same from an f32 row in shared memory.
__device__ __forceinline__ float2 smem_pair(const float* row, int c, int D) {
  if (!(D & 1)) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(row[c], c + 1 < D ? row[c + 1] : 0.f);
}

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A window's run of lanes: lane i of the run is lane p0 + i of the layout,
// its v at v[i * vstride].
struct Run {
  long p0;
  int count;
  const int* v;
  int vstride;
};

// Where a window's source row u lies in h, or null for a zero source (u
// outside the window, or a padding row).
template <typename T>
__device__ __forceinline__ const T* source(const T* h, int u, long wrow0, const Dims& dm) {
  return unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n ? h + (wrow0 + u) * dm.d : nullptr;
}

// Row 13's lane walk: ELL meta, bond embeddings summed from the layer's
// table in shared memory.
template <typename T>
struct EllBondWalk {
  static constexpr int kMeta = 5;  // ints per lane: u, v, three bond rows
  const int* meta;
  const T* tab;
  int lanes, vocab;

  static size_t ext_bytes(int d, int vocab) { return size_t(vocab) * d * 4; }

  __device__ void stage(unsigned char* ext, int d, int tid) const {
    float* tab_s = reinterpret_cast<float*>(ext);
    for (int i = tid; i < vocab * d; i += kThreads) tab_s[i] = ld(tab + i);
  }
  __device__ Run run(int win) const {
    const long p0 = long(win) * lanes;
    return Run{p0, lanes, meta + p0 * kMeta + 1, kMeta};
  }
  struct Lane {
    const T* hu;
    const float *e1, *e2, *e3;
  };
  __device__ const float* bond(const unsigned char* ext, int a, int d) const {
    return unsigned(a) < unsigned(vocab) ? reinterpret_cast<const float*>(ext) + a * d : nullptr;
  }
  __device__ Lane lane(long p, const T* h, long wrow0, const unsigned char* ext,
                       const Dims& dm) const {
    const int* m = meta + p * kMeta;
    return Lane{source(h, __ldg(m), wrow0, dm), bond(ext, __ldg(m + 2), dm.d),
                bond(ext, __ldg(m + 3), dm.d), bond(ext, __ldg(m + 4), dm.d)};
  }
  // The lane's message at columns c, c + 1.
  __device__ float2 message(const Lane& ln, int c, int D) const {
    float2 ee = make_float2(0.f, 0.f);
    if (ln.e1) { const float2 t = smem_pair(ln.e1, c, D); ee.x += t.x; ee.y += t.y; }
    if (ln.e2) { const float2 t = smem_pair(ln.e2, c, D); ee.x += t.x; ee.y += t.y; }
    if (ln.e3) { const float2 t = smem_pair(ln.e3, c, D); ee.x += t.x; ee.y += t.y; }
    const float2 hv = ln.hu ? ld_pair(ln.hu, c, D) : make_float2(0.f, 0.f);
    return make_float2(rnd<T>(fmaxf(hv.x + ee.x, 0.f)), rnd<T>(fmaxf(hv.y + ee.y, 0.f)));
  }
};

// The first block b in [0, nb) with block_window[b] >= key.
__device__ inline int first_block(const int* __restrict__ block_window, int nb, int key) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(block_window + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Rows 10, 12 (kGather: vals is each lane's bond embedding, u_local its
// source) and 25 (!kGather: vals is each lane's message): lanes in blocks of
// `block`, u_local / v_local `stride` ints apart.
template <typename T, bool kGather>
struct BlockWalk {
  const T* vals;
  const int *u_local, *v_local, *block_window;
  int nb, block, stride;

  static size_t ext_bytes(int, int) { return 0; }

  __device__ void stage(unsigned char*, int, int) const {}
  __device__ Run run(int win) const {
    const int b0 = block_window ? first_block(block_window, nb, win) : min(win, nb);
    const int b1 = block_window ? first_block(block_window, nb, win + 1) : min(win + 1, nb);
    const long p0 = long(b0) * block;
    return Run{p0, (b1 - b0) * block, v_local + p0 * stride, stride};
  }
  struct Lane {
    const T* hu;
    const T* val;
  };
  __device__ Lane lane(long p, const T* h, long wrow0, const unsigned char*,
                       const Dims& dm) const {
    const T* hu = kGather ? source(h, __ldg(u_local + p * stride), wrow0, dm) : nullptr;
    return Lane{hu, vals + p * dm.d};
  }
  __device__ float2 message(const Lane& ln, int c, int D) const {
    const float2 x = ld_pair(ln.val, c, D);
    if (!kGather) return x;
    const float2 hv = ln.hu ? ld_pair(ln.hu, c, D) : make_float2(0.f, 0.f);
    return make_float2(rnd<T>(fmaxf(hv.x + x.x, 0.f)), rnd<T>(fmaxf(hv.y + x.y, 0.f)));
  }
};

// The register-tiled FMA MLP of the f32 form over the block's 128 rows of
// act f32 [128][D]: out = relu(act.w1^T + b1).w2^T + b2 (-> relu), in chunks
// of kHC hidden units, stored to rows row0.. of out.
template <typename T>
__device__ __forceinline__ void fma_mlp(const float* act_f, unsigned char* smem, const Smem& lay,
                                        const T* __restrict__ w1, const T* __restrict__ b1,
                                        const T* __restrict__ w2, const T* __restrict__ b2,
                                        T* __restrict__ out, long row0, const Dims& dm, int tid) {
  const int D = dm.d;
  float* hid_s = reinterpret_cast<float*>(smem + lay.hid);  // [kRows][kHC] a chunk of z
  float* w1c = reinterpret_cast<float*>(smem + lay.w1c);    // [kHC][D+1]
  float* w2c = reinterpret_cast<float*>(smem + lay.w2c);    // [D][kHC+1]
  float* b1c = reinterpret_cast<float*>(smem + lay.b1c);    // [kHC]
  const int tr = tid / kTC, tc = tid % kTC;
  float o[kRowsPT][kColsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
  for (int j0 = 0; j0 < dm.hid; j0 += kHC) {
    __syncthreads();  // act is written; the previous chunk's readers are done
    for (int i = tid; i < kHC * D; i += kThreads) {
      const int j = i / D, k = i - j * D;
      w1c[j * (D + 1) + k] = j0 + j < dm.hid ? ld(w1 + long(j0 + j) * D + k) : 0.f;
    }
    for (int i = tid; i < D * kHC; i += kThreads) {
      const int c = i / kHC, j = i - c * kHC;
      w2c[c * (kHC + 1) + j] = j0 + j < dm.hid ? ld(w2 + long(c) * dm.hid + j0 + j) : 0.f;
    }
    for (int j = tid; j < kHC; j += kThreads) b1c[j] = j0 + j < dm.hid ? ld(b1 + j0 + j) : 0.f;
    __syncthreads();

    float z[kRowsPT][kHcPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kHcPT; ++m) z[i][m] = 0.f;
    for (int k = 0; k < D; ++k) {
      float a[kRowsPT], wv[kHcPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) a[i] = act_f[(tr + kTR * i) * D + k];
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
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const long row = row0 + tr + kTR * i;
    if (row >= dm.n) continue;
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      if (c >= D) continue;
      float v = o[i][m] + ld(b2 + c);
      if (dm.final_relu) v = fmaxf(v, 0.f);
      out[row * D + c] = cvt<T>(v);
    }
  }
}

// N2 = 0: the float32 form (FMA MLP); N2 = 104 or 112: the bf16 form with
// the wgmma MLP, N2 its second product's width. tiles: the bf16 form's
// packed weight chunks of this layer (gin_mlp.cuh). lay: the shared-memory
// carve-up, computed once on the host (smem_layout). kMessages: the
// messages-only form (N2 = 0 in both types; w1 .. tiles and eps1 unread,
// lay from msg_smem_layout).
template <typename T, int N2, typename Walk, bool kMessages = false>
__global__ void __launch_bounds__(kThreads, kMessages ? 4 : (N2 > 0 ? 2 : 1))
layer_kernel(Walk walk, const T* __restrict__ h, const T* __restrict__ m_spill,
             const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ b2, const float* __restrict__ eps1,
             const unsigned char* __restrict__ tiles, T* __restrict__ out, Dims dm, Smem lay) {
  constexpr bool kWg = N2 > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const gin_mlp::Geom gm = gin_mlp::geom(dm.d, dm.hid);
  // act: f32 [kRows][D], or bf16 [D'/8][kRows][8] (the wgmma A layout).
  float* act_f = reinterpret_cast<float*>(smem + lay.act);
  __nv_bfloat16* act_b = reinterpret_cast<__nv_bfloat16*>(smem + lay.act);
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs
  const gin_mlp::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                           dm.stages, gm.chunks, gm.chunk_bytes};
  const bool mlp = !(dm.knockout & kNoMlp), messages = !(dm.knockout & kNoMessages);

  const int D = dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(part) * kRows;

  if constexpr (kWg) {
    if (tid == 0 && mlp) ring.init();
    // act's pad columns stay zero; the messages write columns < D only.
    const int pad = gm.dp - D;
    for (int i = tid; i < kRows * pad; i += kThreads)
      act_b[gin_mlp::act_index(i / pad, D + i % pad)] = __float2bfloat16_rn(0.f);
  }
  const Run run = messages ? walk.run(win) : Run{0, 0, nullptr, 1};
  if (messages) {
    walk.stage(smem + lay.ext, D, tid);
    // Row r's lanes are [lo_s[r], lo_s[r+1]) of the run: the first lane
    // whose v is at least the row's window-local index, by binary search.
    for (int r = tid; r <= kRows; r += kThreads) {
      const int key = part * kRows + r;
      int lo = 0, hi = run.count;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(run.v + long(mid) * run.vstride) < key) lo = mid + 1; else hi = mid;
      }
      lo_s[r] = lo;
    }
  } else {
    for (int r = tid; r <= kRows; r += kThreads) lo_s[r] = 0;
  }
  __syncthreads();
  if constexpr (kWg) {
    if (tid == 0 && mlp) ring.prefetch();  // the layer's first S weight chunks, behind the messages
  }

  // Messages, one warp per destination row; lane j of the warp holds the
  // column pairs p = j, j + 32, ... (columns 2p and 2p + 1) of the row.
  const float eps = kMessages ? 0.f : __ldg(eps1);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float2 acc[kLaneP];
#pragma unroll
    for (int j = 0; j < kLaneP; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const typename Walk::Lane ln = walk.lane(run.p0 + e, h, wrow0, smem + lay.ext, dm);
#pragma unroll
      for (int j = 0; j < kLaneP; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c >= D) break;
        const float2 m = walk.message(ln, c, D);
        acc[j].x += m.x;
        acc[j].y += m.y;
      }
    }
    const long row = row0 + r;
    const bool real = row < dm.n;
    if constexpr (kMessages) {
      if (real) {
#pragma unroll
        for (int j = 0; j < kLaneP; ++j) {
          const int c = 2 * (lane + 32 * j);
          if (c >= D) break;
          const float2 sp = m_spill != nullptr ? ld_pair(m_spill + row * D, c, D)
                                               : make_float2(0.f, 0.f);
          out[row * D + c] = cvt<T>(__fadd_rn(acc[j].x, sp.x));
          if (c + 1 < D) out[row * D + c + 1] = cvt<T>(__fadd_rn(acc[j].y, sp.y));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLaneP; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c >= D) break;
        const float2 hv = real ? ld_pair(h + row * D, c, D) : make_float2(0.f, 0.f);
        const float2 sp = real && m_spill != nullptr ? ld_pair(m_spill + row * D, c, D)
                                                     : make_float2(0.f, 0.f);
        const float a0 = rnd<T>(__fadd_rn(__fadd_rn(acc[j].x, sp.x), __fmul_rn(eps, hv.x)));
        const float a1 = rnd<T>(__fadd_rn(__fadd_rn(acc[j].y, sp.y), __fmul_rn(eps, hv.y)));
        if constexpr (kWg) {
          // Columns c, c + 1 share a core-matrix row: one 4-byte store (a
          // pad column c + 1 = D, for an odd D, stores zero).
          *reinterpret_cast<__nv_bfloat162*>(act_b + gin_mlp::act_index(r, c)) =
              __floats2bfloat162_rn(a0, c + 1 < D ? a1 : 0.f);
        } else {
          act_f[r * D + c] = a0;
          if (c + 1 < D) act_f[r * D + c + 1] = a1;
        }
      }
    }
  }
  if (kMessages || !mlp) return;

  if constexpr (kWg) {
    fence_proxy_async();  // act, written here, is read by wgmma
    __syncthreads();
    float o[N2 / 2];
    gin_mlp::run<N2>(o, act_b, ring, 0, gm, b1, b2, D, dm.hid, dm.final_relu != 0, tid);
    gin_mlp::for_each_out<N2>(o, D, tid, [&](int r, int c, float v) {
      if (row0 + r < dm.n) out[(row0 + r) * D + c] = cvt<T>(v);
    });
  } else {
    fma_mlp<T>(act_f, smem, lay, w1, b1, w2, b2, out, row0, dm, tid);
  }
}

// Every instantiation a library launches: f32, and bf16 at N2 = 104 and 112.
template <typename Walk32, typename Walk16, typename F>
void for_each_form(F&& f) {
  f(layer_kernel<float, 0, Walk32>);
  f(layer_kernel<__nv_bfloat16, 104, Walk16>);
  f(layer_kernel<__nv_bfloat16, 112, Walk16>);
}

// Opt every form of the library in to `bytes` of dynamic shared memory on
// `device`: the host does this once per launch plan, raising the limit only
// (so every plan made before stays valid), and the launches do not.
template <template <typename> class Walk>
int prepare(long long bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  for_each_form<Walk<float>, Walk<__nv_bfloat16>>([&](auto kernel) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  });
  return int(err);
}

template <typename T, int N2, typename Walk>
cudaError_t launch_form(const Walk& walk, const void* h, const void* m_spill, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* eps1,
                        const void* tiles, void* out, int num_windows, const Dims& dm,
                        const Smem& lay, cudaStream_t stream) {
  layer_kernel<T, N2, Walk><<<num_windows * (dm.window / kRows), kThreads, lay.total, stream>>>(
      walk, static_cast<const T*>(h), static_cast<const T*>(m_spill), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps1), static_cast<const unsigned char*>(tiles),
      static_cast<T*>(out), dm, lay);
  return cudaGetLastError();
}

// Check the geometry, then launch the form of `dtype` (0 = float32, 1 =
// bfloat16) with the lane walks walk32 / walk16 of the two types. ext: the
// walk's shared bytes. bfloat16 needs `tiles` and a ring of at least
// gin_mlp::min_stages buffers. Returns a cudaError_t.
template <typename Walk32, typename Walk16>
int launch(int dtype, const Walk32& walk32, const Walk16& walk16, size_t ext, const void* h,
           const void* m_spill, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* eps1, const void* tiles, void* out, int num_windows, const Dims& dm,
           int device, void* stream) {
  if (dm.window % kRows || dm.window / kRows < 1 || dm.window / kRows > kMaxWindowBlocks ||
      dm.d < 1 || dm.d > kMaxD || dm.hid < 1 || num_windows < 1 ||
      (dtype == 1 && !(dm.knockout & kNoMlp) &&
       (tiles == nullptr || dm.stages < gin_mlp::min_stages(dm.d, dm.hid))))
    return int(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Smem lay = smem_layout(dtype == 1, dm.d, dm.hid, ext, dm.stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_form<float, 0>(walk32, h, m_spill, w1, b1, w2, b2, eps1, nullptr, out,
                                num_windows, dm, lay, s);
  else if (dtype == 1 && gin_mlp::geom(dm.d, dm.hid).n2 == 104)
    err = launch_form<__nv_bfloat16, 104>(walk16, h, m_spill, w1, b1, w2, b2, eps1, tiles, out,
                                          num_windows, dm, lay, s);
  else if (dtype == 1)
    err = launch_form<__nv_bfloat16, 112>(walk16, h, m_spill, w1, b1, w2, b2, eps1, tiles, out,
                                          num_windows, dm, lay, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

// The messages-only form: the widest D its lanes' column pairs cover.
constexpr int kMsgMaxD = 64 * kLaneP;

// Check the geometry, then launch the messages-only form of `dtype` (0 =
// float32, 1 = bfloat16) with the lane walks walk32 / walk16; ext: the
// walk's shared bytes; m_spill may be null. Returns a cudaError_t.
template <typename Walk32, typename Walk16>
int launch_messages(int dtype, const Walk32& walk32, const Walk16& walk16, size_t ext,
                    const void* h, const void* m_spill, void* out, int num_windows, int n,
                    int window, int d, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks || d < 1 ||
      d > kMsgMaxD || num_windows < 1 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, d, 0, 0, 0, 0};
  const Smem lay = msg_smem_layout(ext);
  const int grid = num_windows * (window / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    layer_kernel<float, 0, Walk32, true><<<grid, kThreads, lay.total, s>>>(
        walk32, static_cast<const float*>(h), static_cast<const float*>(m_spill), nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<float*>(out), dm, lay);
  else
    layer_kernel<__nv_bfloat16, 0, Walk16, true><<<grid, kThreads, lay.total, s>>>(
        walk16, static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(m_spill), nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, static_cast<__nv_bfloat16*>(out), dm, lay);
  return int(cudaGetLastError());
}

// What the occupancy calculator says of the messages-only form of `dtype`
// with `bytes` of dynamic shared memory: the blocks that fit one SM.
template <template <typename> class Walk>
int msg_occupancy(int dtype, long long bytes, int* out) {
  if (dtype == 0)
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, layer_kernel<float, 0, Walk<float>, true>, kThreads, size_t(bytes)));
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, layer_kernel<__nv_bfloat16, 0, Walk<__nv_bfloat16>, true>, kThreads, size_t(bytes)));
}

// What the occupancy calculator says of the form of `dtype` with `bytes` of
// dynamic shared memory: the blocks that fit one SM. Returns a cudaError_t.
template <template <typename> class Walk>
int occupancy(int dtype, int d, int hid, long long bytes, int* out) {
  if (dtype == 0)
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, layer_kernel<float, 0, Walk<float>>, kThreads, size_t(bytes)));
  if (gin_mlp::geom(d, hid).n2 == 104)
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, layer_kernel<__nv_bfloat16, 104, Walk<__nv_bfloat16>>, kThreads, size_t(bytes)));
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, layer_kernel<__nv_bfloat16, 112, Walk<__nv_bfloat16>>, kThreads, size_t(bytes)));
}

}  // namespace gin_layer
