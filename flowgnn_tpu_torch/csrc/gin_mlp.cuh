// The GIN update MLP on Hopper's tensor cores, shared by the bf16 forms of
// rows 1 and 8 (gin_local_model_slots.cu, gin_local_model.cu through
// gin_model.cuh) and of the per-layer rows 13, 10 / 12 and 25
// (gin_local_layer_ell.cu, gin_local_layer_blocks.cu, gin_layer_fused.cu
// through gin_layer.cuh).
//
// One block of 128 rows (two warpgroups of 64) computes
//   out = z · W2ᵀ + b2 (relu but on the last layer),  z = bf16(relu(act · W1ᵀ + b1)),
// act [128, D] bf16 in shared memory in wgmma's K-major A layout
// [D'/8][128][8] (D' = D padded to 16 with zero columns), W1 [H, D], W2 [D, H].
// Per chunk of 32 hidden units: z = act · W1cᵀ as wgmma m64n32k16 from
// shared memory (D'/16 steps); in registers + b1, relu, rounded to bf16 and
// paired into the A fragment of the next product; out += z · W2cᵀ as wgmma
// m64nN2k16 with A from registers (two steps). The hidden layer never goes
// to shared memory, and the register plan (out N2/2 = 52 or 56 f32 a
// thread, z 16, the fragment 8) does not depend on H. The caller gets out +
// b2 (relu'd) in f32 registers, the m64nN2 accumulator fragment of
// hopper.cuh, and rounds it where it stores it (for_each_out).
//
// Weights. The host packs W1 and W2 once per weight set into chunks
// (flowgnn_tpu_torch/ops/local_layer.py: gin_mlp_tiles): chunk c of a layer
// is W1's rows 32c..32c+31 as the B operand [D'/8][32][8] followed by W2's
// columns 32c..32c+31 as the B operand [4][N2][8] (H' = H padded to 32, N2 =
// D padded to 104 or 112; pads zero), (D' + N2)·64 bytes, 13.8 KB at D = 100.
// A Ring of S chunk buffers in shared memory is fed by one bulk copy per
// chunk against a "full" mbarrier per buffer: the caller prefetches the
// first S chunks of its sequence (all layers' chunks in order for the
// whole-model kernels, one layer's for the per-layer ones) as early as it can, and the
// MLP refills a buffer with the chunk S further on as soon as every warp's
// wgmma has finished reading it (a named barrier, then one thread issues the
// copy). With S = C (all of a layer's chunks: 97 KB at D = 100, H = 200) the
// next layer's weights stream in during this layer's MLP; with S < C any H
// fits (H = 512 is 16 chunks), at the price of L2 latency inside the MLP
// where the MLP outruns the copies. The wrapper picks S by shape from the
// card's shared memory.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace gin_mlp {

using namespace hopper;

constexpr int kRows = 128;     // rows per block: two warpgroups of 64
constexpr int kThreads = 256;  // the two warpgroups
constexpr int kHC = 32;        // hidden units per chunk
constexpr int kMaxD = 112;     // widest D: K of the first product in 7 steps
constexpr int kBar = 1;        // the named barrier the ring's refills use

// The MLP's tile geometry for width d and hidden width hid: K of the first
// product, the hidden units padded to whole chunks, the second product's
// width, the chunks per layer, and a chunk's W1 part and whole size (bytes).
struct Geom {
  int dp, hp, n2, chunks, w1_bytes, chunk_bytes;
};

__host__ __device__ inline Geom geom(int d, int hid) {
  Geom g;
  g.dp = (d + 15) / 16 * 16;
  g.hp = (hid + kHC - 1) / kHC * kHC;
  g.n2 = d <= 104 ? 104 : 112;
  g.chunks = g.hp / kHC;
  g.w1_bytes = g.dp * kHC * 2;
  g.chunk_bytes = g.w1_bytes + kHC * g.n2 * 2;
  return g;
}

// The geometry as the wrappers check it: D', H', N2, the bytes of a chunk.
inline void dims(int d, int hid, int* out) {
  const Geom g = geom(d, hid);
  out[0] = g.dp;
  out[1] = g.hp;
  out[2] = g.n2;
  out[3] = g.chunk_bytes;
}

// The fewest buffers the ring runs on: chunk c + 1 is loaded into chunk
// c − 1's buffer once the MLP has waited for chunk c, so a single buffer
// would wait on itself unless a layer is one chunk.
__host__ __device__ inline int min_stages(int d, int hid) { return geom(d, hid).chunks > 1 ? 2 : 1; }

// act's element (r, c) in the A layout [D'/8][128][8].
__device__ __forceinline__ int act_index(int r, int c) { return ((c >> 3) * kRows + r) * 8 + (c & 7); }

__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }

// A ring of `stages` chunk buffers at `buf` (16-byte aligned), mbarriers at
// `full`, fed from `src`, whose chunk i (of `total`) is at src + i·chunk_bytes.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  const unsigned char* src;
  int stages, total, chunk_bytes;

  // One thread, then a __syncthreads before any prefetch or wait.
  __device__ void init() const {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  // One thread: chunk i into buffer i % stages.
  __device__ void load(int i) const {
    const int s = i % stages;
    mbar_arrive_expect_tx(full + s, uint32_t(chunk_bytes));
    bulk_g2s(buf + size_t(s) * chunk_bytes, src + size_t(i) * chunk_bytes, uint32_t(chunk_bytes),
             full + s);
  }
  // One thread: the first `stages` chunks.
  __device__ void prefetch() const {
    for (int i = 0; i < stages && i < total; ++i) load(i);
  }
  // Every consumer: chunk i's buffer once it has landed.
  __device__ const unsigned char* wait(int i) const {
    const int s = i % stages;
    mbar_wait(full + s, uint32_t(i / stages) & 1);
    return buf + size_t(s) * chunk_bytes;
  }
  // All kThreads threads, after each has waited for the wgmma groups that
  // read chunk i: refill its buffer with chunk i + stages.
  __device__ void release(int i, int tid) const {
    if (i + stages >= total) return;
    bar_sync(kBar, kThreads);
    if (tid == 0) load(i + stages);
  }
};

// The MLP over the block's 128 rows on chunks first..first+C-1 of `ring`
// (all kThreads threads; act written and made visible to the async proxy,
// fence_proxy_async, before the barrier that precedes the call). b1 [H] and
// b2 [D] are this layer's. Leaves out + b2, relu'd when `relu_out`, in o.
template <int N2, typename T>
__device__ __forceinline__ void run(float (&o)[N2 / 2], const __nv_bfloat16* act_s, const Ring& ring,
                                    int first, const Geom& gm, const T* __restrict__ b1,
                                    const T* __restrict__ b2, int d, int hid, bool relu_out,
                                    int tid) {
  const int wg = tid / 128, q = tid % 4;
  float z[kHC / 2];
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kHC / 2; ++i) z[i] = 0.f;
  for (int c = 0; c < gm.chunks; ++c) {
    const unsigned char* chunk = ring.wait(first + c);
    const __nv_bfloat16* w1c = reinterpret_cast<const __nv_bfloat16*>(chunk);
    const __nv_bfloat16* w2c = reinterpret_cast<const __nv_bfloat16*>(chunk + gm.w1_bytes);
    wgmma_fence();
    for (int ks = 0; ks < gm.dp / 16; ++ks) {
      const uint64_t da = desc(act_s + (size_t(2 * ks) * kRows + 64 * wg) * 8, kRows * 16, 128);
      const uint64_t db = desc(w1c + size_t(2 * ks) * kHC * 8, kHC * 16, 128);
      mma_bf16_ss<kHC>(z, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // also completes chunk c - 1's second product
    fence_regs(z);
    if (c > 0) ring.release(first + c - 1, tid);
    // z + b1, relu, bf16: n8 tile j is half (j & 1) of K step j / 2's A.
    uint32_t fa[2][4];
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j) {
      const int col = kHC * c + 8 * j + 2 * q;
      const float c0 = col < hid ? ldf(b1 + col) : 0.f;
      const float c1 = col + 1 < hid ? ldf(b1 + col + 1) : 0.f;
      fa[j / 2][(j & 1) * 2] = pack_bf16(fmaxf(z[4 * j] + c0, 0.f), fmaxf(z[4 * j + 1] + c1, 0.f));
      fa[j / 2][(j & 1) * 2 + 1] =
          pack_bf16(fmaxf(z[4 * j + 2] + c0, 0.f), fmaxf(z[4 * j + 3] + c1, 0.f));
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t db = desc(w2c + size_t(2 * s) * N2 * 8, N2 * 16, 128);
      mma_bf16_rs<N2>(o, fa[s], db, c > 0 || s > 0);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);
  ring.release(first + gm.chunks - 1, tid);
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      if (col < d) {
        const float v = o[4 * j + e] + ldf(b2 + col);
        o[4 * j + e] = relu_out ? fmaxf(v, 0.f) : v;
      }
    }
}

// f(row, col, value) for every output of the fragment `o` with col < d:
// row 64wg + 16w + g (+ 8), columns 8j + 2q (+ 1), as hopper.cuh lays out
// the m64nN2 accumulator.
template <int N2, typename F>
__device__ __forceinline__ void for_each_out(const float (&o)[N2 / 2], int d, int tid, F&& f) {
  const int wg = tid / 128, w = (tid % 128) / 32, g = (tid % 32) / 4, q = tid % 4;
  const int r = 64 * wg + 16 * w + g;
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * q + (e & 1);
      if (col < d) f(r + 8 * (e >> 1), col, o[4 * j + e]);
    }
}

}  // namespace gin_mlp
