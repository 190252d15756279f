// Chained-matmul microbenchmark kernel for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernel of flowgnn_tpu/bench/matmul_shapes.py:measure
// (the kernel body at :58-74, its pallas_call at :80). Per row of A (the TPU
// grid tiles A's rows, and rows are independent, so the tiling does not
// change the function), with B [K, N] shared by all rows:
//   acc = 0
//   repeat layers times:
//     prod = a . B                     (f32 for bf16, int32 for int8)
//     acc += float(prod)
//     a = cast(relu(a) + float(prod[:, 0]) * 1e-9)   (bf16: round to nearest
//                                       even; int8: truncate toward zero)
//   out = acc                          (float32 [rows, N])
// The relu keeps the chain nonlinear, so no compiler may fold the layers'
// products into one.
//
// What bounds it on this card: 2*rows*K*N*layers operations over 989 TF/s
// (bf16) or 1979 TOP/s (int8), against A and B read once and the float32
// output written once; every shape of SHAPES is far above the ridge, so the
// bound is the tensor cores. Design: warp-level tensor cores,
// mma.sync.aligned.m16n8k16 (bf16 -> f32) or m16n8k32 (s8 -> s32). One
// 256-thread block owns a slab of 64 rows, which lives in shared memory for
// all layers (K <= 1024: 130 KB in bf16), rows past the end zero. B does not
// fit a block (1024 x 256 bf16 is 512 KB): where the slab and all of B fit
// the card's shared memory B is loaded once and stays for all layers
// (every SHAPES row but the fat anchors), else it streams through shared
// memory in chunks of 128 bytes of K, every layer. B is stored n-major so
// that every B fragment is one 32-bit load; both A and B rows are padded by
// 16 bytes, which makes the fragment loads free of bank conflicts. Eight warps: four
// along the rows (one m16 tile each) times two along the columns (n8 tiles
// j = 2i + w); N = 136 is 17 n8 tiles. prod[:, 0] is held by the lanes of
// the column-0 warps; they publish it through shared memory before the
// relu update of the slab. The running sum and the layer's product stay in
// registers. The B chunk's loads are not overlapped with the products, and
// the products are mma.sync, not wgmma from TMA-fed shared memory: that is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;             // rows per block
constexpr int kWarpRows = 4;        // warps along the rows, one m16 tile each
constexpr int kWarpCols = 2;        // warps along the columns
constexpr int kMaxN = 256;
constexpr int kMaxTiles = kMaxN / 8 / kWarpCols;  // n8 tiles per warp
constexpr int kChunkBytes = 128;    // bytes of K per B chunk row
constexpr int kPadBytes = 16;       // row padding of the A slab and the B chunk

// K elements of B held in shared memory at once: all of K, or one chunk.
__host__ __device__ inline int chunk_of(int es, int k, bool resident) {
  return resident ? k : kChunkBytes / es;
}

__host__ __device__ inline size_t smem_bytes(int es, int k, int n, bool resident) {
  return size_t(kBM) * (size_t(k) * es + kPadBytes) +
         size_t(n) * (size_t(chunk_of(es, k, resident)) * es + kPadBytes) + kBM * sizeof(float);
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  using Acc = float;
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Traits<int8_t> {
  using Acc = int;
  __device__ static float to_float(int8_t x) { return float(x); }
  // Truncation toward zero, as XLA's convert and torch's .to(int8) do for
  // values in range (relu keeps a in [0, 127 + 0.02]).
  __device__ static int8_t from_float(float x) { return int8_t(int(x)); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cmm_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
           int rows, int K, int N, int layers, bool resident) {
  using Acc = typename Traits<T>::Acc;
  constexpr int es = sizeof(T);
  const int chunk = chunk_of(es, K, resident);  // K elements of B per pass
  const int b_ld = chunk * es + kPadBytes;      // bytes per B row in shared memory
  constexpr int kStep = 32 / es;             // K elements per mma
  constexpr int kVec = 8;                    // B elements per vector load
  using Vec = typename std::conditional<es == 2, uint4, uint2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a_ld = K * es + kPadBytes;
  unsigned char* a_s = smem;                         // [64][K] slab
  unsigned char* b_s = smem + size_t(kBM) * a_ld;    // [N][chunk] B, n-major
  float* p0_s = reinterpret_cast<float*>(b_s + size_t(N) * b_ld);  // prod[:, 0]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp % kWarpRows, wc = warp / kWarpRows;
  const int arow = wr * 16;
  const long row0 = long(blockIdx.x) * kBM;
  const int ntiles = N / 8;

  const int vrow = K * es / 16;  // 16-byte vectors per A row
  for (int i = tid; i < kBM * vrow; i += kThreads) {
    const int r = i / vrow, v = i - r * vrow;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = reinterpret_cast<const uint4*>(a + (row0 + r) * K)[v];
    *reinterpret_cast<uint4*>(a_s + size_t(r) * a_ld + v * 16) = val;
  }

  float acc[kMaxTiles][4];
  Acc prod[kMaxTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int l = 0; l < layers; ++l) {
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) prod[j][e] = Acc(0);
    for (int k0 = 0; k0 < K; k0 += chunk) {
      const int kc = min(chunk, K - k0);
      __syncthreads();  // the slab is updated; the previous chunk is consumed
      // The chunk B[k0 : k0 + kc, :] into b_s[n][k] (a resident B once): one
      // vector load of 8 columns of one row, consecutive threads on
      // consecutive k.
      const int groups = N / kVec;
      for (int i = tid; i < (resident && l > 0 ? 0 : kc * groups); i += kThreads) {
        const int ng = i / kc, k = i - ng * kc;
        const Vec v = *reinterpret_cast<const Vec*>(b + long(k0 + k) * N + ng * kVec);
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          reinterpret_cast<T*>(b_s + size_t(ng * kVec + x) * b_ld)[k] = e[x];
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += kStep) {
        // A fragment: rows g and g + 8 of the warp's m16 tile; bytes t4*4 and
        // t4*4 + 16 of the 32-byte K step (bf16 columns 2*t4 and 2*t4 + 8,
        // int8 columns 4*t4 and 4*t4 + 16).
        const unsigned char* ap = a_s + size_t(arow + g) * a_ld + size_t(k0 + kk) * es + t4 * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * a_ld);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * a_ld + 16);
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          const int tile = wc + kWarpCols * j;
          if (tile < ntiles) {
            const unsigned char* bp = b_s + size_t(tile * 8 + g) * b_ld + kk * es + t4 * 4;
            mma(prod[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bp),
                *reinterpret_cast<const uint32_t*>(bp + 16));
          }
        }
      }
    }
    // prod[:, 0]: n8 tile 0 of the column-0 warps, lanes with t4 == 0.
    if (wc == 0 && t4 == 0) {
      p0_s[arow + g] = float(prod[0][0]);
      p0_s[arow + g + 8] = float(prod[0][2]);
    }
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], float(prod[j][e]));
    if (l + 1 == layers) break;
    __syncthreads();  // p0 published; every warp is done reading the slab
    // The relu update, 16 bytes of a row a thread.
    for (int i = tid; i < kBM * vrow; i += kThreads) {
      const int r = i / vrow, v = i - r * vrow;
      const float add = __fmul_rn(p0_s[r], 1e-9f);
      uint4* p = reinterpret_cast<uint4*>(a_s + size_t(r) * a_ld + v * 16);
      uint4 val = *p;
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int x = 0; x < 16 / es; ++x)
        e[x] = Traits<T>::from_float(__fadd_rn(fmaxf(Traits<T>::to_float(e[x]), 0.f), add));
      *p = val;
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) {
    const int tile = wc + kWarpCols * j;
    if (tile >= ntiles) continue;
    const int col = tile * 8 + t4 * 2;
    const long r = row0 + arow + g;
    if (r < rows) *reinterpret_cast<float2*>(out + r * N + col) = make_float2(acc[j][0], acc[j][1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(out + (r + 8) * N + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

__global__ void cmm_empty_kernel() {}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, int rows, int k, int n,
                   int layers, int device, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const bool resident = smem_bytes(sizeof(T), k, n, true) <= size_t(optin);
  const size_t bytes = smem_bytes(sizeof(T), k, n, resident);
  err = cudaFuncSetAttribute(
      cmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kBM - 1) / kBM;
  cmm_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(out), rows, k, n,
      layers, resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cmm_max_n() { return kMaxN; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long cmm_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs at the least (B streamed);
// dtype as in cmm_launch. The launch keeps B resident where it fits.
long long cmm_smem_bytes(int dtype, int k, int n) {
  return (long long)smem_bytes(dtype == 1 ? 1 : 2, k, n, false);
}

// dtype: 0 = bfloat16, 1 = int8 (a [rows, k], b [k, n], both row-major);
// out: float32 [rows, n]. k a multiple of 32, n a multiple of 8 up to
// cmm_max_n. Returns a cudaError_t.
int cmm_launch(int dtype, const void* a, const void* b, void* out, int rows, int k, int n,
               int layers, int device, void* stream) {
  if (rows < 1 || k < 32 || k % 32 || n < 8 || n > kMaxN || n % 8 ||
      layers < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<__nv_bfloat16>(a, b, out, rows, k, n, layers, device, s);
  else if (dtype == 1)
    err = launch<int8_t>(a, b, out, rows, k, n, layers, device, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

// One launch of an empty kernel on the stream: the launch floor.
int cmm_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cmm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

const char* cmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
