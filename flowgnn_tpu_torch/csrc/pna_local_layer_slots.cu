// One PNA layer over the slot layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_layer. Same operands, same output: slot_src [NW*W, S] each row's
// in-window sources (sentinel W for an empty slot), h [n, D], the node terms
// invd = 1/max(in_deg, 1), t and scale [n], the tower w_cat [4D, 3D] =
// [w_none^T | w_t^T | w_scale^T] and b [1, D]; out [n, D] in h's type. Per row
// v over its valid slot sources u, in slot order:
//   s, q, mn, mx = sum, sum of squares, min and max of h_u, mn seeded at
//                  min_init and mx at max_init (a row with no source keeps them)
//   mean = s * invd_v, std = sqrt(max(q * invd_v - mean^2, 0))
//   y    = [rnd(mean) | rnd(mn) | rnd(mx) | rnd(std)] . w_cat     [4D] -> [3D]
//   acc  = y[:D] + t_v * y[D:2D] + scale_v * y[2D:] + b
//   h'   = rnd(h + relu(acc))
// The node terms come in h's type: the TPU kernel rounds them to it (they
// ride its feature tile). q * invd - mean^2 runs as __fmul_rn / __fsub_rn: a
// contracted FMA would leave a residual of ~1e-8 * x^2 where the plain
// version has exactly 0 (one in-edge), which the sqrt turns into ~1e-4 * |x|.
// The JAX PNA runs it on every layer of a slot batch with no spill tail that
// the whole-model kernel does not take (intermediates asked for, or more
// graphs in a window than its pooling layout holds).
//
// The design is one layer of csrc/pna_local_model.cu without its pooling
// head: a block owns one window of W rows; h stays in shared memory (40 KB in
// f32 at W=128, D=80) as the sources and the residual; the stats and the
// tower run over row blocks of kRB = 64 rows (stats 82 KB), the stats one
// warp per destination row with the lanes over D, the tower register-tiled
// FMA (each thread holds the three scaler outputs of its 4 rows x 5 columns)
// with w_cat streamed from L2 in chunks of kKC = 32 input channels (30 KB):
// the whole tower, 307 KB in f32, does not fit a block's 227 KB. ~158 KB in
// all at W=128, S=6, one 256-thread block per SM. Every sum has a fixed
// order and no atomics.
//
// What bounds it on this card: arithmetic on chip. Per window the tower is
// W*4D*3D multiply-adds (9.8 M at W=128, D=80) against S*W*D gathered values
// for the four aggregates, while h and the node terms are read once and h'
// written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;                // thread rows of the tower tile
constexpr int kTC = 16;                // thread columns of the tower tile
constexpr int kRowsPT = 4;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per stats / tower block (64)
constexpr int kColsPT = 5;             // output columns per thread and scaler
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (80)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the stats
constexpr int kKC = 32;                // tower input channels per weight chunk
constexpr int kMaxSlots = 8;

struct Dims {
  int n, window, d, slots;
  float min_init, max_init;
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, st, wc, src, aux, total;
};

__host__ __device__ inline Smem smem_layout(int window, int d, int slots) {
  const size_t W = window, D = d;
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.st = o; o += size_t(kRB) * (4 * D + 1);  // stats, row stride 4D+1
  s.wc = o; o += size_t(kKC) * 3 * D;
  s.src = o; o += W * slots;
  s.aux = o; o += 3 * W;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pna_layer_kernel(const int* __restrict__ slot_src, const T* __restrict__ h,
                 const T* __restrict__ invd, const T* __restrict__ tdeg,
                 const T* __restrict__ scale, const T* __restrict__ w_cat,
                 const T* __restrict__ b, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm.window, dm.d, dm.slots);
  const int W = dm.window, D = dm.d, S = dm.slots, tid = threadIdx.x;
  const int K4 = 4 * D, N3 = 3 * D, SP = K4 + 1;
  float* h_s = smem + lay.h;       // [W][D] h
  float* st_s = smem + lay.st;     // [kRB][SP] a row block's stats
  float* wc_s = smem + lay.wc;     // [kKC][3D] a chunk of the tower
  int* src_s = reinterpret_cast<int*>(smem + lay.src);  // [W][S]
  float* invd_s = smem + lay.aux;  // [W] 1/max(in_deg, 1), then t and scale
  float* t_s = invd_s + W;
  float* sc_s = t_s + W;

  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int i = tid; i < W * S; i += kThreads) src_s[i] = slot_src[row0 * S + i];
  for (int r = tid; r < W; r += kThreads) {
    const bool real = row0 + r < dm.n;
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    t_s[r] = real ? ld(tdeg + row0 + r) : 0.f;
    sc_s[r] = real ? ld(scale + row0 + r) : 0.f;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int tr = tid / kTC, tc = tid % kTC;
  for (int rb = 0; rb < W; rb += kRB) {
    __syncthreads();  // h is staged; the last row block's tower is done with st_s, wc_s

    // Stats of rows rb..rb+kRB-1, one warp per row, lanes over D.
    for (int rl = warp; rl < kRB; rl += kWarps) {
      const int r = rb + rl;
      float s[kLaneD], q[kLaneD], mn[kLaneD], mx[kLaneD];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        s[j] = 0.f; q[j] = 0.f; mn[j] = dm.min_init; mx[j] = dm.max_init;
      }
      for (int k = 0; r < W && k < S; ++k) {
        const int src = src_s[r * S + k];
        if (unsigned(src) >= unsigned(W)) continue;  // empty slot
        const float* hu = h_s + src * D;
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) {
          const int d = lane + 32 * j;
          if (d >= D) break;
          const float x = hu[d];
          s[j] = __fadd_rn(s[j], x);
          q[j] = __fadd_rn(q[j], __fmul_rn(x, x));
          mn[j] = fminf(mn[j], x);
          mx[j] = fmaxf(mx[j], x);
        }
      }
      const float inv = r < W ? invd_s[r] : 0.f;
      float* st_r = st_s + rl * SP;
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int d = lane + 32 * j;
        if (d >= D) break;
        const float mean = __fmul_rn(s[j], inv);
        const float var = __fsub_rn(__fmul_rn(q[j], inv), __fmul_rn(mean, mean));
        st_r[d] = rnd<T>(mean);
        st_r[D + d] = rnd<T>(mn[j]);
        st_r[2 * D + d] = rnd<T>(mx[j]);
        st_r[3 * D + d] = rnd<T>(sqrtf(fmaxf(var, 0.f)));
      }
    }

    // Tower: y[r][p*D + c] = sum_k st[r][k] . w_cat[k][p*D + c], the weight
    // streamed in chunks of kKC input channels.
    float acc[kRowsPT][3][kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][p][m] = 0.f;
    for (int kc = 0; kc < K4; kc += kKC) {
      const int kn = K4 - kc < kKC ? K4 - kc : kKC;
      __syncthreads();  // the stats are written; the last chunk is consumed
      for (int i = tid; i < kn * N3; i += kThreads) wc_s[i] = ld(w_cat + long(kc) * N3 + i);
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float a[kRowsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) a[i] = st_s[(tr + kTR * i) * SP + kc + kk];
        const float* wrow = wc_s + kk * N3;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            const float wv = c < D ? wrow[p * D + c] : 0.f;
#pragma unroll
            for (int i = 0; i < kRowsPT; ++i) acc[i][p][m] = fmaf(a[i], wv, acc[i][p][m]);
          }
      }
    }

    // Scalers, bias and residual into h'.
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const int r = rb + tr + kTR * i;
      if (r >= W || row0 + r >= dm.n) continue;
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        if (c >= D) continue;
        float a = __fadd_rn(acc[i][0][m], __fmul_rn(t_s[r], acc[i][1][m]));
        a = __fadd_rn(a, __fmul_rn(sc_s[r], acc[i][2][m]));
        a = __fadd_rn(a, ld(b + c));
        out[(row0 + r) * D + c] = cvt<T>(__fadd_rn(h_s[r * D + c], fmaxf(a, 0.f)));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* slot_src, const void* h, const void* invd, const void* tdeg,
                   const void* scale, const void* w_cat, const void* b, void* out,
                   int num_windows, const Dims& dm, cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.window, dm.d, dm.slots).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pna_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  pna_layer_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_src), static_cast<const T*>(h),
      static_cast<const T*>(invd), static_cast<const T*>(tdeg),
      static_cast<const T*>(scale), static_cast<const T*>(w_cat),
      static_cast<const T*>(b), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pna_layer_max_d() { return kMaxD; }
int pna_layer_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_layer_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long pna_layer_smem_bytes(int window, int d, int slots) {
  return (long long)(smem_layout(window, d, slots).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, invd, t, scale, w_cat, b, out).
// slot_src [num_windows*window, slots]: int32; out [n, d]. min_init /
// max_init seed the running min and max. Returns a cudaError_t.
int pna_layer_launch(int dtype, const void* slot_src, const void* h, const void* invd,
                     const void* tdeg, const void* scale, const void* w_cat, const void* b,
                     void* out, int num_windows, int n, int window, int d, int slots,
                     float min_init, float max_init, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1 || window < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, d, slots, min_init, max_init};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_src, h, invd, tdeg, scale, w_cat, b, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_src, h, invd, tdeg, scale, w_cat, b, out, num_windows,
                                dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* pna_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
