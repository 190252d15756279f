// The lane walks of the whole-model kernels' message stages, shared by
// gin_model.cuh (rows 8 and 1) and gcn_model.cuh (rows 9 and 2): the k = 1
// ELL layout and the degree-sorted slot layout that
// flowgnn_tpu_torch/models/base.py:as_batch builds.
//
// A walk serves a block of kRows window rows (one block of a cluster of
// W/128): prepare(win, rank, tid, lo_s) runs once before the layers (lo_s:
// kRows + 1 ints of shared scratch), and visit(win, rank, r, lo_s, window,
// f) calls f(u, a1, a2, a3) for each lane of the block's row r in order: u
// the source's window row, a1..a3 the lane's bond-table rows (outside the
// vocabulary: none). The slot walk skips an empty lane; the ELL walk hands
// every lane of the row's run on, u outside [0, W) included.

#pragma once

#include <cuda_runtime.h>

namespace lanes {

constexpr int kRows = 128;     // window rows per block
constexpr int kThreads = 256;  // threads per block
constexpr int kEllMeta = 5;    // ints per ELL lane: u, v, three bond rows
constexpr int kMaxSlots = 8;   // deepest slot axis

// The k = 1 ELL layout: `block` lanes per window of `meta`, sorted by v
// within the window (a stable sort by receiver), so each destination row's
// lanes are one contiguous run; pad lanes carry u = v = W and come last.
struct Ell {
  const int* meta;
  int block;

  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index, by binary search over v.
  __device__ __forceinline__ void prepare(int win, int rank, int tid, int* lo_s) const {
    const int* meta_w = meta + long(win) * block * kEllMeta;
    for (int r = tid; r <= kRows; r += kThreads) {
      const int key = rank * kRows + r;
      int lo = 0, hi = block;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(meta_w + mid * kEllMeta + 1) < key) lo = mid + 1; else hi = mid;
      }
      lo_s[r] = lo;
    }
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
