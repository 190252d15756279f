// Spill-tail windowed segment sum for Hopper (sm_90a): kernel table row 24.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/spmm.py:windowed_segment_sum.
// Same operands, same output: values [P, D] in blocked lane order (P = NB *
// block), v_local [P] each lane's row in its window (sentinel >= window on pad
// lanes), block_window [NB] each block's output window, non-decreasing; out
// [num_windows * window, D] in the values' type, row t*window + v the sum of
// the lanes of window t's blocks whose v_local is v, in lane order. A window
// with no block comes out zero (the TPU kernel leaves such a window
// unwritten). Two layouts feed it: the spill tail's (windows of 512 rows, only
// the T windows that receive a lane; within a window the lanes are not sorted
// by receiver) and the edge-block layout's (every window of 128 rows, sorted
// by receiver but for each block's pad lanes; the blocks left over, about
// 100,000 sentinel lanes on a molhiv bucket, parked on the last window).
//
// The TPU kernel walks the blocks in order on one core and carries a window's
// f32 accumulator from one grid step to the next. Here the work is cut by
// output rows: one block of 512 threads per (output window t, 128-row slice s
// of it) owns all D columns of its rows, and no two blocks write one row.
// - Its run: the window's blocks, found by a 512-way search on block_window
//   (__syncthreads_count, two rounds for up to 262,144 blocks).
// - Index pass: each warp reads one contiguous piece of the run's v as
//   16-byte loads, four in flight a thread, counts per row the lanes that fall
//   in the slice (sentinels and lanes outside [0, window) fall in none) and
//   notes its last such lane: past it the warp reads nothing again, which
//   keeps the parked sentinel blocks to one read. A scan gives each row its run of a
//   list in shared memory, and a second walk over each piece (up to its last
//   lane) fills the list stably: peers of one row in a step of 32 lanes are
//   ranked by __match_any_sync, the steps go in order, and the pieces follow
//   one another, so each row's list is its lanes in lane order.
// - Sum pass: a warp, or a half-warp where a row is at most 16 vectors, takes
//   one row at a time; each thread owns one vector of the row's columns (16,
//   8, 4 or 2 bytes, the widest that divides the row's bytes and the
//   pointers' alignment), issues the loads of kSumAhead of the row's lanes
//   before it adds them, sums in f32 in list order, and writes the row once,
//   cast to the values' type, in the same vectors; a row that receives no
//   lane is written as zeros by the same stores.
// - The list holds kChunk lanes. A slice with more is done in groups of
//   whole rows that fit, and a row with more than kChunk lanes (a hub) in
//   chunks of its list, all threads on its columns with the sums kept in
//   registers, so every sum stays in lane order.
// The carve-up (vector width, lanes a row, slices) is computed on the host
// and passed in. Two launches on the same operands give equal bits.
//
// What bounds it on this card: the bytes. Each lane's values are read once and
// each output row written once (most rows of a spill window receive no lane
// and are written as zeros); a lane costs one add per column. At the models'
// shapes the output writes dominate that bound; the index pass reads each
// lane's v about twice more (the second time from L1 / L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;       // output rows per block: one slice of a window
constexpr int kChunk = 4096;     // lanes the shared list holds
constexpr int kIndexAhead = 4;   // 16-byte v loads a thread keeps in flight (index pass)
constexpr int kSumAhead = 4;     // lanes whose value loads go out before their adds
constexpr int kNoSums = 2;       // knockout bit 1: the index pass, then zeros written
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  int cnt[kWarps][kRows];  // each warp's piece: lanes per row of the slice
  int cur[kWarps][kRows];  // fill cursors: the piece's next rank within its row
  int total[kRows];        // lanes per row
  int start[kRows + 1];    // exclusive scan of total: each row's list offset
  int last[kWarps];        // each piece's end after its last lane in the slice, from p0
  int list[kChunk];        // lanes (from p0) of a group of rows, by row, in lane order
  int b0, b1;              // the window's blocks [b0, b1)
};

// The vector of VB bytes a thread moves at once, as 32-bit words (VB = 2: one
// bf16 in the low half).
template <int VB>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (VB == 16) {
    const uint4 x = __ldg(static_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VB == 8) {
    const uint2 x = __ldg(static_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

template <int VB>
__device__ __forceinline__ void store_words(void* p, const unsigned* w) {
  if constexpr (VB == 16) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VB == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (VB == 4) {
    *static_cast<unsigned*>(p) = w[0];
  } else {
    *static_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  }
}

// The elements of one vector: EV of them, in f32.
template <typename T, int VB> struct Vec {
  static constexpr int kWords = VB < 4 ? 1 : VB / 4;
  static constexpr int kElems = VB / int(sizeof(T));

  __device__ __forceinline__ static void add(float* acc, const unsigned* w) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < kElems; ++k) acc[k] += __uint_as_float(w[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kElems; ++k)
        acc[k] += __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
    }
  }

  __device__ __forceinline__ static void pack(const float* acc, unsigned* w) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < kElems; ++k) w[k] = __float_as_uint(acc[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k) w[k] = 0u;
#pragma unroll
      for (int k = 0; k < kElems; ++k)
        w[k / 2] |= unsigned(__bfloat16_as_ushort(__float2bfloat16_rn(acc[k]))) << (16 * (k % 2));
    }
  }
};

// The window's blocks [b0, b1): the first block whose window is >= t and the
// first whose window is > t, by a kThreads-way search (every thread takes
// part; block_window is non-decreasing). Each round probes kThreads evenly
// spaced blocks of the span left and keeps the one step between the last
// probe below the key and the first at or above it.
__device__ void window_run(const int* __restrict__ block_window, int nb, int t, Shared& s) {
  int lo[2] = {0, 0}, hi[2] = {nb, nb};
  while (hi[0] > lo[0] || hi[1] > lo[1]) {
    int step[2], c[2];
    bool below[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // both probes' loads go out before either count
      step[k] = (hi[k] - lo[k] + kThreads - 1) / kThreads;
      const int q = lo[k] + int(threadIdx.x) * step[k];
      const int w = hi[k] > lo[k] && q < hi[k] ? __ldg(block_window + q) : INT_MAX;
      below[k] = k == 0 ? w < t : w <= t;
    }
    c[0] = __syncthreads_count(below[0]);
    c[1] = __syncthreads_count(below[1]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (hi[k] <= lo[k]) continue;
      const int nlo = c[k] ? lo[k] + (c[k] - 1) * step[k] + 1 : lo[k];
      const int nhi = lo[k] + c[k] * step[k] < hi[k] ? lo[k] + c[k] * step[k] : hi[k];
      lo[k] = nlo;
      hi[k] = nhi;
    }
  }
  if (threadIdx.x == 0) {
    s.b0 = lo[0];
    s.b1 = lo[1];
  }
}

// The list for rows [r0, r1) of the slice: each lane of those rows whose rank
// within its row lies in [k0, k0 + kChunk) at list[start[r] - start[r0] +
// rank] (one row, big: at list[rank - k0]). Warp w walks its piece [a, e) in
// steps of 32 lanes, kSumAhead steps loaded at once.
__device__ void fill(Shared& s, const int* __restrict__ vloc, long p0, long a, long e, int slice0,
                     int rows, int r0, int r1, int k0, bool big) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int r = tid; r < rows; r += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      s.cur[w][r] = run;
      run += s.cnt[w][r];
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const int base = s.start[r0];
  for (long i0 = a; i0 < e; i0 += 32 * kSumAhead) {
    int key[kSumAhead];
#pragma unroll
    for (int u = 0; u < kSumAhead; ++u) {
      const long i = i0 + 32 * u + lane;
      const int r = i < e ? __ldg(vloc + i) - slice0 : -1;
      key[u] = r >= r0 && r < r1 ? r : -1;
    }
#pragma unroll
    for (int u = 0; u < kSumAhead; ++u) {
      if (i0 + 32 * u >= e) break;  // warp-uniform
      const int r = key[u];
      const unsigned peers = __match_any_sync(kFull, r);
      int rank = 0;
      if (r >= 0) {
        rank = s.cur[warp][r] + __popc(peers & lt);
        const int rel = int(i0 + 32 * u + lane - p0);
        if (!big)
          s.list[s.start[r] - base + rank] = rel;
        else if (rank >= k0 && rank < k0 + kChunk)
          s.list[rank - k0] = rel;
      }
      __syncwarp();
      if (r >= 0 && lane == __ffs(peers) - 1) s.cur[warp][r] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// Sums list[from, from + n) of the row's lanes into acc at vector vi of their
// values, kSumAhead lanes' loads ahead of their adds, in list order.
template <typename T, int VB>
__device__ __forceinline__ void sum_list(float* acc, const Shared& s, int from, int n,
                                         const T* __restrict__ values, long p0, int d, int vi) {
  using V = Vec<T, VB>;
  for (int e = 0; e < n; e += kSumAhead) {
    unsigned w[kSumAhead][V::kWords];
#pragma unroll
    for (int u = 0; u < kSumAhead; ++u)
      if (e + u < n)
        load_words<VB>(values + (p0 + s.list[from + e + u]) * d + vi * V::kElems, w[u]);
#pragma unroll
    for (int u = 0; u < kSumAhead; ++u)
      if (e + u < n) V::add(acc, w[u]);
  }
}

// One (window, slice) block. group: the threads a row (16 or 32); nvec: the
// vectors of VB bytes a row holds.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 2)
wss_kernel(const T* __restrict__ values, const int* __restrict__ vloc,
           const int* __restrict__ block_window, T* __restrict__ out, int nb, int block, int d,
           int window, int group, int nvec, int knockout) {
  using V = Vec<T, VB>;
  __shared__ Shared s;
  const int t = blockIdx.x, slice0 = blockIdx.y * kRows;
  const int rows = window - slice0 < kRows ? window - slice0 : kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool sums = !(knockout & kNoSums);

  for (int i = tid; i < kWarps * kRows; i += kThreads) (&s.cnt[0][0])[i] = 0;
  window_run(block_window, nb, t, s);
  __syncthreads();
  const long p0 = long(s.b0) * block, run = long(s.b1 - s.b0) * block;

  // Index pass: counts per row, piece by piece, and each piece's last lane.
  const long piece = (run + kWarps - 1) / kWarps;
  const long a = p0 + (warp * piece < run ? warp * piece : run);
  const long b = p0 + ((warp + 1) * piece < run ? (warp + 1) * piece : run);
  {
    // 16-byte loads from the aligned quad that holds lane a; lanes counted
    // from the quad below p0 (off of them before p0), in 32-bit indices.
    const int off = int(((reinterpret_cast<uintptr_t>(vloc) / 4) + p0) & 3);
    const int4* vq = reinterpret_cast<const int4*>(vloc + p0 - off);
    const int ia = int(a - p0) + off, ib = int(b - p0) + off;  // the piece, from vq
    const int q1 = (ib + 3) / 4;
    int end = 0;  // after this thread's last lane in the slice, from p0
    for (int qb = ia / 4; qb < q1; qb += 32 * kIndexAhead) {
      int4 x[kIndexAhead];
#pragma unroll
      for (int u = 0; u < kIndexAhead; ++u) {
        const int q = qb + 32 * u + lane;
        x[u] = q < q1 ? __ldg(vq + q) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kIndexAhead; ++u) {
        if (qb + 32 * u >= q1) break;  // warp-uniform: the rest of the round is past the piece
        const int q = qb + 32 * u + lane;
        const int v4[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * q + k;
          const int r = v4[k] - slice0;
          if (i >= ia && i < ib && unsigned(r) < unsigned(rows)) {
            atomicAdd(&s.cnt[warp][r], 1);
            end = i - off + 1;
          }
        }
      }
    }
    end = int(__reduce_max_sync(kFull, unsigned(end)));
    if (lane == 0) s.last[warp] = end;
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += s.cnt[w][r];
    s.total[r] = n;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of total over the slice's rows, 4 a thread
    int v[4], run4 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * lane + k;
      v[k] = run4;
      run4 += r < rows ? s.total[r] : 0;
    }
    int incl = run4;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - run4;
#pragma unroll
    for (int k = 0; k < 4; ++k) s.start[4 * lane + k] = excl + v[k];
    if (lane == 31) s.start[kRows] = incl;
  }
  __syncthreads();
  const long e = p0 + s.last[warp];  // this warp's piece ends at its last lane in the slice

  const int groups = kThreads / group, gid = tid / group, gl = tid % group;
  T* out_s = out + (long(t) * window + slice0) * d;
  int r0 = 0;
  while (r0 < rows) {
    if (s.total[r0] > kChunk) {
      // A row past the list: its lanes kChunk at a time, every thread on its
      // own vectors of the row, the sums in registers across the chunks.
      const int n = s.total[r0];
      for (int c0 = 0; c0 < nvec; c0 += kThreads) {
        const int vi = c0 + tid;
        float acc[V::kElems];
#pragma unroll
        for (int k = 0; k < V::kElems; ++k) acc[k] = 0.f;
        for (int k0 = 0; k0 < n; k0 += kChunk) {
          fill(s, vloc, p0, a, e, slice0, rows, r0, r0 + 1, k0, true);
          if (sums && vi < nvec)
            sum_list<T, VB>(acc, s, 0, n - k0 < kChunk ? n - k0 : kChunk, values, p0, d, vi);
          __syncthreads();  // the list is read before the next chunk fills it
        }
        if (vi < nvec) {
          unsigned w[V::kWords];
          V::pack(acc, w);
          store_words<VB>(out_s + long(r0) * d + vi * V::kElems, w);
        }
      }
      ++r0;
      continue;
    }
    // The rows [r0, r1) whose lists fit the list together.
    int r1 = r0 + 1;
    if (s.start[rows] - s.start[r0] <= kChunk) {
      r1 = rows;
    } else {
      while (r1 < rows && s.start[r1 + 1] - s.start[r0] <= kChunk) ++r1;
    }
    fill(s, vloc, p0, a, e, slice0, rows, r0, r1, 0, false);
    for (int r = r0 + gid; r < r1; r += groups) {
      const int from = s.start[r] - s.start[r0], n = sums ? s.total[r] : 0;
      for (int c0 = 0; c0 < nvec; c0 += group) {
        const int vi = c0 + gl;
        if (vi >= nvec) break;
        float acc[V::kElems];
#pragma unroll
        for (int k = 0; k < V::kElems; ++k) acc[k] = 0.f;
        sum_list<T, VB>(acc, s, from, n, values, p0, d, vi);
        unsigned w[V::kWords];
        V::pack(acc, w);
        store_words<VB>(out_s + long(r) * d + vi * V::kElems, w);
      }
    }
    __syncthreads();  // the list is read before the next group fills it
    r0 = r1;
  }
}

template <typename T, int VB>
cudaError_t launch_vb(const void* values, const void* vloc, const void* block_window, void* out,
                      int nb, int block, int d, int window, int num_windows, int group,
                      int knockout, cudaStream_t stream) {
  const int nvec = d * int(sizeof(T)) / VB;
  const dim3 grid(num_windows, (window + kRows - 1) / kRows);
  wss_kernel<T, VB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(vloc),
      static_cast<const int*>(block_window), static_cast<T*>(out), nb, block, d, window, group,
      nvec, knockout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int vb, const void* values, const void* vloc, const void* block_window,
                   void* out, int nb, int block, int d, int window, int num_windows, int group,
                   int knockout, cudaStream_t stream) {
  const auto go = [&](auto kernel) {
    return kernel(values, vloc, block_window, out, nb, block, d, window, num_windows, group,
                  knockout, stream);
  };
  if (vb == 16) return go(launch_vb<T, 16>);
  if (vb == 8) return go(launch_vb<T, 8>);
  if (vb == 4) return go(launch_vb<T, 4>);
  if constexpr (sizeof(T) == 2) {
    if (vb == 2) return go(launch_vb<T, 2>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long wss_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Shared memory (bytes, static) one block takes, whatever the geometry.
long long wss_smem_bytes() { return (long long)sizeof(Shared); }

// The lanes the shared list holds: a slice with more runs in groups of rows.
int wss_chunk() { return kChunk; }

// dtype: 0 = float32, 1 = bfloat16 (values, out). values [nb*block, d]; vloc
// [nb*block] and block_window [nb]: int32; out [num_windows*window, d]. The
// host's plan: vb the bytes a thread moves at once (16, 8, 4, or 2 in
// bfloat16), dividing d's row bytes and both pointers' alignment; group the
// threads a row (16 or 32). knockout: 0 (bit 1 skips the sums: timing only).
// Returns a cudaError_t.
int wss_launch(int dtype, const void* values, const void* vloc, const void* block_window,
               void* out, int nb, int block, int d, int window, int num_windows, int vb,
               int group, int knockout, int device, void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (nb < 1 || block < 1 || d < 1 || window < 1 || num_windows < 1 || vb < esz ||
      (vb & (vb - 1)) || vb > 16 || (d * esz) % vb ||
      (reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(out)) % vb ||
      (group != 16 && group != 32) || (window + kRows - 1) / kRows > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(vb, values, vloc, block_window, out, nb, block, d, window, num_windows,
                        group, knockout, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(vb, values, vloc, block_window, out, nb, block, d, window,
                                num_windows, group, knockout, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* wss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
