// The lane walks of the whole-model kernels' message stages, shared by
// gin_model.cuh (rows 8 and 1) and gcn_model.cuh (rows 9 and 2; the ELL walk
// also rows 15 and 14): the k = 1 ELL layout and the degree-sorted slot layout that
// flowgnn_tpu_torch/models/base.py:as_batch builds. The ELL runs (ell_runs)
// also serve dgn_model.cuh's ELL walk (row 18), gat_messages.cuh (rows 17
// and 23) and row 16 (dgn_local_layer_ell.cu).
//
// A walk serves a block of kRows window rows (one block of a cluster of
// W/128): prepare(win, rank, tid, lo_s) runs once before the layers (lo_s:
// kRows + 1 ints of shared scratch), and visit(win, rank, r, lo_s, window,
// f) calls f(u, a1, a2, a3) for each lane of the block's row r in order: u
// the source's window row, a1..a3 the lane's bond-table rows (outside the
// vocabulary: none). The slot walk skips an empty lane; the ELL walk hands
// every lane of the row's run on, u outside [0, W) included.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace lanes {

constexpr int kRows = 128;     // window rows per block
constexpr int kThreads = 256;  // threads per block
constexpr int kEllMeta = 5;    // ints per ELL lane: u, v, three bond rows
constexpr int kMaxSlots = 8;   // deepest slot axis

// lo_s[r] for r = 0..R: the first of the window's `lanes` lanes whose v is
// at least key0 + r, so row r's lanes are [lo_s[r], lo_s[r+1]). One pass
// over the lanes marks where v changes: lane e writes every key in
// (v[e-1], v[e]], the last lane's successor every key past the last v. The
// layout keeps v ascending within a window, which this needs; it takes no
// dependent load, where a binary search per row takes about log2(lanes).
template <int R>
__device__ __forceinline__ void ell_runs(const int* __restrict__ meta_w, int lanes, int key0,
                                         int* lo_s, int tid, int nthreads) {
  for (int e = tid; e <= lanes; e += nthreads) {
    const int prev = e == 0 ? INT_MIN : __ldg(meta_w + (e - 1) * kEllMeta + 1);
    const int cur = e == lanes ? INT_MAX : __ldg(meta_w + e * kEllMeta + 1);
    const int hi = cur < key0 + R ? cur : key0 + R;
    for (int k = prev < key0 ? key0 : prev + 1; k <= hi; ++k) lo_s[k - key0] = e;
  }
}

// The k = 1 ELL layout: `block` lanes per window of `meta`, sorted by v
// within the window (a stable sort by receiver), so each destination row's
// lanes are one contiguous run; pad lanes carry u = v = W and come last.
struct Ell {
  const int* meta;
  int block;

  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index (ell_runs).
  __device__ __forceinline__ void prepare(int win, int rank, int tid, int* lo_s) const {
    ell_runs<kRows>(meta + long(win) * block * kEllMeta, block, rank * kRows, lo_s, tid, kThreads);
  }

  template <typename F>
  __device__ __forceinline__ void visit(int win, int, int r, const int* lo_s, int, F&& f) const {
    const int* meta_w = meta + long(win) * block * kEllMeta;
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int* m = meta_w + e * kEllMeta;
      f(__ldg(m), __ldg(m + 2), __ldg(m + 3), __ldg(m + 4));
    }
  }
};

// The degree-sorted prefix layout: `sw` = Σ caps lanes per window of
// `meta` (4 ints each: src − half, three bond attrs with their vocabulary
// offsets), slot k's lanes at offs[k]..offs[k]+caps[k], row r of slot k at
// lane offs[k] + r. An empty lane has src = W − half and is skipped. Each
// row's ≤ S lanes are read from device memory through L1, once per row.
struct Slots {
  const int* meta;
  int sw, half, slots;
  int caps[kMaxSlots];
  int offs[kMaxSlots];

  __device__ __forceinline__ void prepare(int, int, int, int*) const {}

  template <typename F>
  __device__ __forceinline__ void visit(int win, int rank, int r, const int*, int window,
                                        F&& f) const {
    const int row = rank * kRows + r;  // the window row
    const int* meta_w = meta + long(win) * sw * 4;
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k) {
      if (k >= slots || row >= caps[k]) continue;
      const int* m = meta_w + (offs[k] + row) * 4;
      const int src = __ldg(m) + half;
      if (unsigned(src) >= unsigned(window)) continue;  // empty lane
      f(src, __ldg(m + 1), __ldg(m + 2), __ldg(m + 3));
    }
  }
};

// The slot walk over `meta` with `slots` caps; false when a count or a cap
// is out of range (a cap above the window, or more than kMaxSlots slots).
inline bool make_slots(Slots& s, const void* meta, int half, const int* caps, int slots,
                       int window) {
  if (slots < 1 || slots > kMaxSlots) return false;
  s = Slots{};
  s.meta = static_cast<const int*>(meta);
  s.half = half;
  s.slots = slots;
  int off = 0;
  for (int k = 0; k < slots; ++k) {
    if (caps[k] < 0 || caps[k] > window) return false;
    s.caps[k] = caps[k];
    s.offs[k] = off;
    off += caps[k];
  }
  s.sw = off;
  return true;
}

}  // namespace lanes
