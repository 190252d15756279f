// One bf16 product on Hopper's tensor cores, shared by the bf16 forms of
// rows 9 (gcn_local_model.cu: the next conv, x · wn_l) and 3
// (pna_local_model.cu: the tower, [mean | min | max | std] · w_l), and of
// rows 2, 4, 5, 20, 22 and 23 (GAT's fused ELL layer: its skip and its
// projection, N = 64), and of rows 27-30 (gat_model.cuh's ablation forms:
// N = 64, 128, 136 and 256).
//
// One block of 128 rows (two warpgroups of 64) computes acc = A · B, A
// [128, K'] bf16 in shared memory in wgmma's K-major A layout
// [K'/8][128][8] (K' = K padded to whole chunks of kKC = 32, pad columns
// zero), B [K', N] with N a wgmma width (104 or 112 for row 9, 240 for row 3).
// The caller gets the f32 accumulator fragment of hopper.cuh's m64nN
// layout in registers and runs its own epilogue there (for_each).
//
// Weights. The host packs B once per weight set (flowgnn_tpu_torch/ops/
// local_layer.py: linear_tiles) into K-chunks: chunk c is B's rows
// 32c..32c+31 as the B operand [4][N][8], 64·N bytes (6.7 KB at N = 104,
// 15.4 KB at N = 240), every layer's chunks one sequence. They stream
// through gin_mlp.cuh's Ring: S chunk buffers in shared memory, each filled
// by one bulk copy against its "full" mbarrier; the caller prefetches the
// first S chunks as early as it can (before its first layer), and run()
// refills chunk c − 1's buffer with chunk c − 1 + S once every warp's
// wgmma on it has completed, so the next layer's chunks land during this
// layer's work. Per chunk the block issues its two K steps as one wgmma
// group and waits for the previous group only: the copy engine and the
// tensor cores overlap. A ring of one buffer would wait on itself (chunk
// c + 1 is loaded into chunk c − 1's buffer after chunk c was waited for),
// so the wrapper gives at least two (min_stages), and picks S by shape.

#pragma once

#include <cuda_bf16.h>

#include "gin_mlp.cuh"
#include "hopper.cuh"

namespace linear_wgmma {

using namespace hopper;
using Ring = gin_mlp::Ring;

constexpr int kRows = 128;     // rows per block: two warpgroups of 64
constexpr int kThreads = 256;  // the two warpgroups
constexpr int kKC = 32;        // K per weight chunk: two wgmma K steps

static_assert(kThreads == gin_mlp::kThreads, "the ring's named barrier spans the block");

// K padded to whole chunks, the chunks, and a chunk's bytes for width n.
struct Geom {
  int kp, chunks, chunk_bytes;
};

__host__ __device__ inline Geom geom(int k, int n) {
  Geom g;
  g.kp = (k + kKC - 1) / kKC * kKC;
  g.chunks = g.kp / kKC;
  g.chunk_bytes = kKC * n * 2;
  return g;
}

// The fewest buffers the ring runs on (see above), at `chunks` a product.
__host__ __device__ inline int min_stages(int chunks) { return chunks > 1 ? 2 : 1; }

// A's element (r, c) in the A layout [K'/8][128][8]; columns c, c + 1 of an
// even c are adjacent (one 4-byte pair).
__device__ __forceinline__ int a_index(int r, int c) { return ((c >> 3) * kRows + r) * 8 + (c & 7); }

// acc = A · B over chunks first..first+chunks-1 of `ring` (all kThreads
// threads; A written and made visible to the async proxy,
// fence_proxy_async, before the barrier that precedes the call).
template <int N>
__device__ __forceinline__ void run(float (&acc)[N / 2], const __nv_bfloat16* a_s, const Ring& ring,
                                    int first, int chunks, int tid) {
  const int wg = tid / 128;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(ring.wait(first + c));
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kKC / 16; ++s) {
      const int ks = c * (kKC / 16) + s;  // K step of the whole product
      const uint64_t da = desc(a_s + (size_t(2 * ks) * kRows + 64 * wg) * 8, kRows * 16, 128);
      const uint64_t db = desc(b + size_t(2 * s) * N * 8, N * 16, 128);
      mma_bf16_ss<N>(acc, da, db, c > 0 || s > 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();  // chunk c − 1's group is done; chunk c's may run on
      ring.release(first + c - 1, tid);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(first + chunks - 1, tid);
}

// The row and the first column of accumulator acc[4j + e]: row 64wg + 16w +
// g (+ 8 for e >= 2), column 8j + 2q (+ 1 for odd e), as hopper.cuh lays
// out the m64nN accumulator.
__device__ __forceinline__ int acc_row(int tid, int e) {
  return 64 * (tid / 128) + 16 * ((tid % 128) / 32) + (tid % 32) / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int tid, int j, int e) { return 8 * j + 2 * (tid % 4) + (e & 1); }

// f(row, col, value) for every accumulator of the fragment with col < ncols.
template <int N, typename F>
__device__ __forceinline__ void for_each(const float (&acc)[N / 2], int ncols, int tid, F&& f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = acc_col(tid, j, e);
      if (col < ncols) f(acc_row(tid, e), col, acc[4 * j + e]);
    }
}

}  // namespace linear_wgmma
