// DGN's two message channels over the ELL layout for Hopper (sm_90a):
// kernel table row 16.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_message_ell (the channels, for the caller to merge a spill
// tail). Operands: meta [NW*lanes, 5] = (u, v, three bond rows; the bond
// rows unused) per lane, h [n, D], eig [n]; out [n, 2D] = [rnd(m1) |
// rnd(m2)] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   acc = sum [rnd(h_u) | rnd(eig_u * h_u)]              (f32 sums)
//   m1 = acc1,  m2 = acc2 - eig_v * m1      (the TPU kernel's factoring of
//                                            sum (eig_u - eig_v) * h_u)
// Rounding points are the TPU kernel's: each lane's two channels before the
// f32 sum; eig comes in h's type (it rides the TPU kernel's feature tile).
// The m2 chain uses __fmul_rn / __fadd_rn / __fsub_rn, so a contracted FMA
// leaves no residual the plain version does not have. A lane whose u lies
// outside [0, W), or on a padding row, adds nothing, and one whose v does
// lands nowhere. Row 18, the whole layer over the same layout, is
// dgn_local_layer_ell_model.cu.
//
// h lives in device memory, so one block of 256 threads owns 128 rows of a
// window (grid NW*W/128, W a whole number of 128-row tiles up to 1024); the
// k*B lanes of a window are one run sorted by v, so the block finds each
// row's run by one pass over the lanes (lanes::ell_runs, any k) and sums it
// one warp per row, the lanes over D, with no atomics. What bounds it on
// this card: the bytes (per lane 20 B of meta and a D-wide source row,
// mostly from L2, and per row h, eig and the 2D-wide output once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kMaxD = 112;             // widest D (row 18's tile's)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the channels
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, lanes, d;
};

// Shared-memory carve-up of one block, in 4-byte words: the lane runs.
struct Smem {
  size_t lo, total;
};

__host__ __device__ inline Smem smem_layout() { return Smem{0, kRows + 1}; }

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

// m1 and m2 of window row r (block-local) into the warp's registers, lane j
// of the warp holding columns j, j + 32, ...
template <typename T>
__device__ inline void channels(const int* meta_w, const T* h, const T* eig, const int* lo_s,
                                int r, long wrow0, long row, const Dims& dm, float* m1,
                                float* m2) {
  const int D = dm.d, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kLaneD; ++j) { m1[j] = 0.f; m2[j] = 0.f; }
  for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
    const int u = __ldg(meta_w + e * kMeta);
    // Outside the window, or a padding row: a zero source adds nothing.
    if (unsigned(u) >= unsigned(dm.window) || wrow0 + u >= dm.n) continue;
    const T* hu = h + (wrow0 + u) * D;
    const float eu = ld(eig + wrow0 + u);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      const float x = ld(hu + c);
      m1[j] = __fadd_rn(m1[j], x);
      m2[j] = __fadd_rn(m2[j], rnd<T>(__fmul_rn(eu, x)));
    }
  }
  const float ev = ld(eig + row);
#pragma unroll
  for (int j = 0; j < kLaneD; ++j) m2[j] = __fsub_rn(m2[j], __fmul_rn(ev, m1[j]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgn_msg_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                   const T* __restrict__ eig, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  int* lo_s = reinterpret_cast<int*>(smem + smem_layout().lo);
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;
  lanes::ell_runs<kRows>(meta_w, dm.lanes, part * kRows, lo_s, threadIdx.x, kThreads);
  __syncthreads();

  const int D = dm.d, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    float m1[kLaneD], m2[kLaneD];
    channels(meta_w, h, eig, lo_s, r, wrow0, row, dm, m1, m2);
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      out[row * 2 * D + c] = cvt<T>(m1[j]);
      out[row * 2 * D + D + c] = cvt<T>(m2[j]);
    }
  }
}

template <typename T>
cudaError_t launch_messages(const void* meta, const void* h, const void* eig, void* out,
                            int num_windows, const Dims& dm, cudaStream_t stream) {
  const size_t bytes = smem_layout().total * 4;
  const int blocks = num_windows * (dm.window / kRows);
  dgn_msg_ell_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(eig),
      static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dgn_msg_ell_max_d() { return kMaxD; }
int dgn_msg_ell_rows_per_block() { return kRows; }
int dgn_msg_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_msg_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs: the lane runs (d unused).
long long dgn_msg_ell_smem_bytes(int d) {
  (void)d;
  return (long long)(smem_layout().total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, out). meta [num_windows*lanes,
// 5]: int32; out [n, 2d]. window must be 1..kMaxWindowBlocks whole blocks of
// kRows rows. Returns a cudaError_t.
int dgn_msg_ell_launch(int dtype, const void* meta, const void* h, const void* eig, void* out,
                       int num_windows, int n, int window, int lanes, int d, int device,
                       void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || num_windows < 1 || lanes < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_messages<float>(meta, h, eig, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch_messages<__nv_bfloat16>(meta, h, eig, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* dgn_msg_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
