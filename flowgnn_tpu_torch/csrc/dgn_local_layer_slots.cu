// One DGN layer over the slot layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_layer_slots. Same operands, same output: slot_src [NW*W, S] each
// row's in-window sources (sentinel W for an empty slot), h [n, D], the node
// terms eig, invd = 1/max(out_deg, 1), ews = sum of eig_u - eig_v over
// in-edges and inva = 1/sum |eig_u - eig_v| [n], the posttrans w_post [2D, D]
// and b_post [1, D], and optionally m_spill [n, 2D], the spill tail's two
// channels summed per node; out [n, D] in h's type. Per row v over its valid
// slot sources u, in slot order:
//   m1 = sum h_u,  m2 = sum e_u * h_u - e_v * m1     (the TPU kernel's factoring)
//   m1 += m_spill[:D],  m2 += m_spill[D:]            (already weighted)
//   a1 = m1 * invd_v,  a2 = |m2 - ews_v * h_v| * inva_v
//   y  = [rnd(a1) | rnd(a2)] . w_post + b_post        [2D] -> [D]
//   h' = rnd(h + relu(y))
// The node terms come in h's type: the TPU kernel rounds them to it (they
// ride its feature tile). The m2 and a2 chains use __fmul_rn / __fadd_rn /
// __fsub_rn: m2 - ews * h cancels, and inva reaches 1/EIG_EPS = 8192, so a
// contracted FMA would leave a residual the plain version does not have.
//
// The design is one layer of csrc/dgn_local_model.cu: a block owns one window
// of W=128 rows; h (51 KB in f32 at D=100) and the window's [W, 2D] channels
// (102 KB) stay in shared memory; the channels run one warp per destination
// row with the lanes over D; the posttrans is register-tiled FMA (8 rows x 7
// columns per thread) with w_post streamed from L2 in chunks of kKC = 32
// input channels (12.8 KB). ~171 KB in all, one 256-thread block per SM.
//
// What bounds it on this card: arithmetic on chip. Per window the posttrans
// is W*2D*D multiply-adds (2.6 M at D=100) against 2*S*W*D for the channels,
// while h, the node terms and m_spill are read once and h' written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;                // thread rows of the posttrans tile
constexpr int kTC = 16;                // thread columns of the posttrans tile
constexpr int kRowsPT = 8;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per posttrans block (128)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the channels
constexpr int kKC = 32;                // posttrans input channels per chunk
constexpr int kMaxSlots = 8;

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, a, wc, src, aux, total;
};

__host__ __device__ inline Smem smem_layout(int window, int d, int slots) {
  const size_t W = window, D = d;
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.a = o; o += W * 2 * D;
  s.wc = o; o += size_t(kKC) * D;
  s.src = o; o += W * slots;
  s.aux = o; o += 4 * W;
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
dgn_layer_kernel(const int* __restrict__ slot_src, const T* __restrict__ h,
                 const T* __restrict__ eig, const T* __restrict__ invd,
                 const T* __restrict__ ews, const T* __restrict__ inva,
                 const T* __restrict__ w_post, const T* __restrict__ b_post,
                 const T* __restrict__ m_spill, T* __restrict__ out, int n,
                 int window, int d, int slots) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(window, d, slots);
  const int W = window, D = d, S = slots, K2 = 2 * d, tid = threadIdx.x;
  float* h_s = smem + lay.h;       // [W][D]
  float* a_s = smem + lay.a;       // [W][2D] the rounded channels
  float* wc_s = smem + lay.wc;     // [kKC][D] a chunk of the posttrans
  int* src_s = reinterpret_cast<int*>(smem + lay.src);  // [W][S]
  float* eig_s = smem + lay.aux;   // [W] eig, then invd, ews and inva
  float* invd_s = eig_s + W;
  float* ews_s = invd_s + W;
  float* inva_s = ews_s + W;

  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < n ? ld(h + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int i = tid; i < W * S; i += kThreads) src_s[i] = slot_src[row0 * S + i];
  for (int r = tid; r < W; r += kThreads) {
    const bool real = row0 + r < n;
    eig_s[r] = real ? ld(eig + row0 + r) : 0.f;
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    ews_s[r] = real ? ld(ews + row0 + r) : 0.f;
    inva_s[r] = real ? ld(inva + row0 + r) : 0.f;
  }
  __syncthreads();

  // Channels of every row, one warp per row, lanes over D.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < W; r += kWarps) {
    float m1[kLaneD], m2[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) { m1[j] = 0.f; m2[j] = 0.f; }
    for (int k = 0; k < S; ++k) {
      const int src = src_s[r * S + k];
      if (unsigned(src) >= unsigned(W)) continue;  // empty slot
      const float* hu = h_s + src * D;
      const float eu = eig_s[src];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        const float x = hu[c];
        m1[j] = __fadd_rn(m1[j], x);
        m2[j] = __fadd_rn(m2[j], __fmul_rn(eu, x));
      }
    }
    const bool real = row0 + r < n;
    const float ev = eig_s[r], iv = invd_s[r], ew = ews_s[r], ia = inva_s[r];
    float* a_r = a_s + r * K2;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) break;
      float m1v = m1[j];
      float m2v = __fsub_rn(m2[j], __fmul_rn(ev, m1v));
      if (m_spill != nullptr && real) {
        m1v = __fadd_rn(m1v, ld(m_spill + (row0 + r) * K2 + c));
        m2v = __fadd_rn(m2v, ld(m_spill + (row0 + r) * K2 + D + c));
      }
      const float dir = __fsub_rn(m2v, __fmul_rn(ew, h_s[r * D + c]));
      a_r[c] = rnd<T>(__fmul_rn(m1v, iv));
      a_r[D + c] = rnd<T>(__fmul_rn(fabsf(dir), ia));
    }
  }

  // Posttrans: y[r][c] = sum_k a[r][k] . w_post[k][c], the weight streamed in
  // chunks of kKC input channels; then h' = rnd(h + relu(y + b)).
  const int tr = tid / kTC, tc = tid % kTC;
  for (int rb = 0; rb < W; rb += kRB) {
    float acc[kRowsPT][kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
    for (int kc = 0; kc < K2; kc += kKC) {
      const int kn = K2 - kc < kKC ? K2 - kc : kKC;
      __syncthreads();  // the channels are written; the last chunk is consumed
      for (int i = tid; i < kn * D; i += kThreads) wc_s[i] = ld(w_post + long(kc) * D + i);
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float a[kRowsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const int r = rb + tr + kTR * i;
          a[i] = r < W ? a_s[r * K2 + kc + kk] : 0.f;
        }
        const float* wrow = wc_s + kk * D;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          const float wv = c < D ? wrow[c] : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(a[i], wv, acc[i][m]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const int r = rb + tr + kTR * i;
      if (r >= W || row0 + r >= n) continue;
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        if (c >= D) continue;
        const float y = __fadd_rn(acc[i][m], ld(b_post + c));
        out[(row0 + r) * D + c] = cvt<T>(__fadd_rn(h_s[r * D + c], fmaxf(y, 0.f)));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* slot_src, const void* h, const void* eig,
                   const void* invd, const void* ews, const void* inva,
                   const void* w_post, const void* b_post, const void* m_spill,
                   void* out, int num_windows, int n, int window, int d, int slots,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(window, d, slots).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dgn_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dgn_layer_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_src), static_cast<const T*>(h),
      static_cast<const T*>(eig), static_cast<const T*>(invd),
      static_cast<const T*>(ews), static_cast<const T*>(inva),
      static_cast<const T*>(w_post), static_cast<const T*>(b_post),
      static_cast<const T*>(m_spill), static_cast<T*>(out), n, window, d, slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dgn_layer_max_d() { return kMaxD; }
int dgn_layer_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_layer_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long dgn_layer_smem_bytes(int window, int d, int slots) {
  return (long long)(smem_layout(window, d, slots).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, eig, invd, ews, inva, w_post, b_post,
// m_spill, out). slot_src [num_windows*window, slots]: int32; m_spill may be
// null; out [n, d]. Returns a cudaError_t.
int dgn_layer_launch(int dtype, const void* slot_src, const void* h, const void* eig,
                     const void* invd, const void* ews, const void* inva,
                     const void* w_post, const void* b_post, const void* m_spill,
                     void* out, int num_windows, int n, int window, int d, int slots,
                     int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_src, h, eig, invd, ews, inva, w_post, b_post, m_spill,
                        out, num_windows, n, window, d, slots, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_src, h, eig, invd, ews, inva, w_post, b_post,
                                m_spill, out, num_windows, n, window, d, slots, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* dgn_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
