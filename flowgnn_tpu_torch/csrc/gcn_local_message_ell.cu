// GCN's message sum over the ELL layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_message_ell. Same operands, same output: meta [NW*lanes, 5] =
// (u, v, three bond-table rows) per lane, h [n, D] (this layer's conv
// output), dis [n] = 1/sqrt(out_deg + 1), this layer's bond table [vocab, D];
// out [n, D] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   m[v] = rnd(dis_v * sum rnd(dis_u * relu(h_u + ee)))
// dis comes in h's type (the TPU kernel rounds it: it rides the gather), the
// message is rounded before the f32 sum, and dis_v factors out of the sum as
// in the TPU kernel. A lane whose u lies outside [0, W) has dis_u = 0 and one
// whose v does lands nowhere. The JAX GCN runs it on every layer of an ELL
// batch with a spill tail, whose messages the caller adds through the spill
// scatter.
//
// Layout and design as csrc/gin_local_layer_ell.cu: the k*B lanes of a window
// are one run sorted by v; one block of 256 threads per 128 rows of a window
// (W a whole number of 128-row tiles up to 1024), h in device memory, the
// lane runs found by binary search on v, one warp per destination row with
// the lanes over D, f32 sums, no atomics. Only the bond table and the lane
// runs sit in shared memory.
//
// What bounds it on this card: bytes. Per lane it reads 20 B of meta and a
// D-wide source row (from L2 mostly: a window's rows are read ~1.7 times),
// and each row of h, dis and out moves once; the arithmetic is 5 operations
// per lane and column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kMaxD = 128;             // widest D the per-lane registers cover
constexpr int kLaneD = kMaxD / 32;     // D columns per lane
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, d, vocab;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t tab, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d, int vocab) {
  Smem s;
  size_t o = 0;
  s.tab = o; o += size_t(vocab) * d;
  s.lo = o; o += kRows + 1;
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// The bond-table row `a` in shared memory, or null outside the vocabulary.
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab,
                                                 int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gcn_msg_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                   const T* __restrict__ dis, const T* __restrict__ tab,
                   T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const Smem lay = smem_layout(dm.d, dm.vocab);
  float* tab_s = smem + lay.tab;                      // [vocab][D]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs

  const int D = dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab + i);
  // Row r's lanes are [lo_s[r], lo_s[r+1]), by binary search over v.
  for (int r = tid; r <= kRows; r += kThreads) {
    const int key = part * kRows + r;
    int lo = 0, hi = dm.lanes;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(meta_w + mid * kMeta + 1) < key) lo = mid + 1; else hi = mid;
    }
    lo_s[r] = lo;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    float acc[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int* m = meta_w + e * kMeta;
      const int u = __ldg(m);
      // Outside the window, or a padding row: dis_u = 0, no message.
      if (unsigned(u) >= unsigned(dm.window) || wrow0 + u >= dm.n) continue;
      const float dis_u = ld(dis + wrow0 + u);
      const T* hu = h + (wrow0 + u) * D;
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
        acc[j] += rnd<T>(__fmul_rn(dis_u, fmaxf(ld(hu + c) + ee, 0.f)));
      }
    }
    const float dv = ld(dis + row);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      out[row * D + c] = cvt<T>(__fmul_rn(acc[j], dv));
    }
  }
}

template <typename T>
cudaError_t launch(const void* meta, const void* h, const void* dis, const void* tab,
                   void* out, int num_windows, const Dims& dm, cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.d, dm.vocab).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_msg_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gcn_msg_ell_kernel<T><<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(dis),
      static_cast<const T*>(tab), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gcn_msg_ell_max_d() { return kMaxD; }
int gcn_msg_ell_rows_per_block() { return kRows; }
int gcn_msg_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_msg_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs.
long long gcn_msg_ell_smem_bytes(int d, int vocab) {
  return (long long)(smem_layout(d, vocab).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, dis, tab, out). meta
// [num_windows*lanes, 5]: int32; out [n, d]. window must be
// 1..kMaxWindowBlocks whole blocks of kRows rows. Returns a cudaError_t.
int gcn_msg_ell_launch(int dtype, const void* meta, const void* h, const void* dis,
                       const void* tab, void* out, int num_windows, int n, int window,
                       int lanes, int d, int vocab, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || num_windows < 1 || lanes < 0 || vocab < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d, vocab};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h, dis, tab, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h, dis, tab, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gcn_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
