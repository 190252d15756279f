// DGN whole-model slot megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// dgn_local_model (with its helpers _slot_onehot and _pool_epilogue). Same
// operands, same output: [NW*GMAX, T] float32 per-window pool sums of
// h . mlp1_w (readout MLP-1), for all L DGN conv layers plus the finalize,
// in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; slot_src [NW*W, S] holds each row's
// in-window sources, sentinel W for an empty slot, and slot k counts only
// for rows below caps[k]. pool_gl holds each row's window-local graph id,
// GMAX for padding rows. eig, invd, ews and inva are per-row node terms: the
// eigenvector entry, 1/max(out_deg, 1), the sum of eig_u - eig_v over
// in-edges and 1/sum |eig_u - eig_v| (EIG_EPS-guarded).
//
// Per layer, for window row v and its valid slot sources u, in slot order:
//   m1 = sum h_u,  m2 = sum e_u * h_u - e_v * m1   (the TPU kernel's factoring)
//   a1 = m1 * invd_v,  a2 = |m2 - ews_v * h_v| * inva_v
//   y  = [rnd(a1) | rnd(a2)] . w_l + b_l          [2D] -> [D]
//   h  = rnd(h + relu(y))
// and after the last layer the head pools h . mlp1_w (_pool_epilogue).
// The m2 and a2 chains are written with __fmul_rn / __fadd_rn / __fsub_rn:
// m2 - ews * h cancels (exactly, when every e_u equals e_v) and inva may be
// 1/EIG_EPS = 8192, so a contracted FMA would leave a residual the plain
// version does not have, amplified 8192-fold.
//
// What bounds it on this card: per window and layer the posttrans is
// W*2D*D multiply-adds (2.6 M at W=128, D=100) against 2*S*W*D for the two
// channels; h is read once and GMAX*T floats written per window, so the
// kernel is bound on chip (arithmetic and shared-memory traffic). Shared
// memory holds h (51 KB in f32 at W=128, D=100) and the [W, 2D] channels of
// the whole window (102 KB): every row's channels read the whole window's
// h, so they are all computed before h is overwritten in place. A layer's
// posttrans (80 KB) does not fit beside them and streams from L2 in chunks
// of kKC = 32 input channels (12.8 KB); ~174 KB in all, one 256-thread
// block per SM. The channels run one warp per destination row with the
// lanes over D (slot indices read once per row, as a broadcast); the
// posttrans is register-tiled FMA, each thread holding 8 rows x 7 columns.
// Every sum has a fixed order and no atomics. wgmma and TMA are later work.
//
// Numerics follow the TPU kernel: activations, node terms and weights are
// float or bfloat16 (T); every product and sum is float32; the two channels
// and the new h are rounded to T where the TPU kernel casts to its compute
// dtype.

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

struct Dims {
  int n, window, d, layers, gmax, tout, slots;
};

struct Caps {
  int caps[kMaxSlots];
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, a, wc, src, aux, gl, rows, gstart, total;
};

__host__ __device__ inline Smem smem_layout(const Dims& dm) {
  const size_t W = dm.window, D = dm.d;
  size_t a = W * 2 * D;                   // channels [W][2D]
  if (W * dm.tout > a) a = W * dm.tout;   // head outputs
  if (size_t(dm.gmax) > a) a = dm.gmax;   // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.a = o; o += a;
  s.wc = o; o += size_t(kKC) * D;
  s.src = o; o += W * dm.slots;
  s.aux = o; o += 4 * W;
  s.gl = o; o += W;
  s.rows = o; o += W;
  s.gstart = o; o += dm.gmax + 1;
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgn_model_kernel(const int* __restrict__ slot_src, const T* __restrict__ h0,
                 const T* __restrict__ eig, const T* __restrict__ invd,
                 const T* __restrict__ ews, const T* __restrict__ inva,
                 const T* __restrict__ w_all, const T* __restrict__ b_all,
                 const int* __restrict__ pool_gl, const T* __restrict__ mlp1_w,
                 float* __restrict__ out, Dims dm, Caps cp) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm);
  const int W = dm.window, D = dm.d, S = dm.slots, tid = threadIdx.x;
  const int K2 = 2 * D;
  float* h_s = smem + lay.h;       // [W][D] h, updated in place per layer
  float* a_s = smem + lay.a;       // [W][2D] channels; head outputs; CSR cursor
  float* wc_s = smem + lay.wc;     // [kKC][D] a chunk of this layer's posttrans
  int* src_s = reinterpret_cast<int*>(smem + lay.src);  // [W][S]
  float* eig_s = smem + lay.aux;   // [W] eig, then invd, ews and inva
  float* invd_s = eig_s + W;
  float* ews_s = invd_s + W;
  float* inva_s = ews_s + W;
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [W]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [W] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]

  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int i = tid; i < W * S; i += kThreads) {
    // A slot beyond its prefix cap counts for nothing: mark it empty.
    const int r = i / S, k = i - r * S;
    src_s[i] = r < cp.caps[k] ? slot_src[row0 * S + i] : W;
  }
  for (int r = tid; r < W; r += kThreads) {
    const bool real = row0 + r < dm.n;
    eig_s[r] = real ? ld(eig + row0 + r) : 0.f;
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    ews_s[r] = real ? ld(ews + row0 + r) : 0.f;
    inva_s[r] = real ? ld(inva + row0 + r) : 0.f;
    gl_s[r] = pool_gl[row0 + r];
  }
  __syncthreads();
  if (tid == 0) {
    // Group the window's rows by graph (ascending row order within a
    // graph): the finalize then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(a_s);
    for (int g = 0; g <= dm.gmax; ++g) gstart_s[g] = 0;
    for (int r = 0; r < W; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) ++gstart_s[gl_s[r] + 1];
    for (int g = 0; g < dm.gmax; ++g) {
      gstart_s[g + 1] += gstart_s[g];
      cursor[g] = gstart_s[g];
    }
    for (int r = 0; r < W; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) rows_s[cursor[gl_s[r]]++] = r;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int tr = tid / kTC, tc = tid % kTC;
  for (int l = 0; l < dm.layers; ++l) {
    __syncthreads();  // h is complete; a_s (the CSR cursor) is free

    // Channels of every row, one warp per row, lanes over D.
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
          const int d = lane + 32 * j;
          if (d >= D) break;
          const float x = hu[d];
          m1[j] = __fadd_rn(m1[j], x);
          m2[j] = __fadd_rn(m2[j], __fmul_rn(eu, x));
        }
      }
      const float ev = eig_s[r], iv = invd_s[r], ew = ews_s[r], ia = inva_s[r];
      float* a_r = a_s + r * K2;
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int d = lane + 32 * j;
        if (d >= D) break;
        const float m2v = __fsub_rn(m2[j], __fmul_rn(ev, m1[j]));
        const float dir = __fsub_rn(m2v, __fmul_rn(ew, h_s[r * D + d]));
        a_r[d] = rnd<T>(__fmul_rn(m1[j], iv));
        a_r[D + d] = rnd<T>(__fmul_rn(fabsf(dir), ia));
      }
    }

    // Posttrans: y[r][c] = sum_k a[r][k] . w_l[k][c], the weight streamed in
    // chunks of kKC input channels; then h = rnd(h + relu(y + b)) in place
    // (every row's channels are complete, and each thread writes only the
    // entries of h it reads).
    const T* w_l = w_all + long(l) * K2 * D;
    for (int rb = 0; rb < W; rb += kRB) {
      float acc[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
      for (int kc = 0; kc < K2; kc += kKC) {
        const int kn = K2 - kc < kKC ? K2 - kc : kKC;
        __syncthreads();  // the channels are written; the last chunk is consumed
        for (int i = tid; i < kn * D; i += kThreads) wc_s[i] = ld(w_l + long(kc) * D + i);
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
        if (r >= W) continue;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          if (c >= D) continue;
          const float y = __fadd_rn(acc[i][m], ld(b_all + long(l) * D + c));
          h_s[r * D + c] = rnd<T>(__fadd_rn(h_s[r * D + c], fmaxf(y, 0.f)));
        }
      }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = h . mlp1_w, then per-graph sums of p.
  float* p_s = a_s;  // [W][T]
  for (int i = tid; i < W * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(h_s[r * D + d], ld(mlp1_w + d * dm.tout + t), s);
    p_s[i] = s;
  }
  __syncthreads();
  float* out_w = out + long(blockIdx.x) * dm.gmax * dm.tout;
  for (int i = tid; i < dm.gmax * dm.tout; i += kThreads) {
    const int g = i / dm.tout, t = i - g * dm.tout;
    float s = 0.f;
    for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) s += p_s[rows_s[j] * dm.tout + t];
    out_w[i] = s;
  }
}

template <typename T>
cudaError_t launch(const void* slot_src, const void* h0, const void* eig,
                   const void* invd, const void* ews, const void* inva,
                   const void* w_all, const void* b_all, const void* pool_gl,
                   const void* mlp1_w, void* out, int num_windows, const Dims& dm,
                   const Caps& cp, cudaStream_t stream) {
  const size_t bytes = smem_layout(dm).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dgn_model_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dgn_model_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_src), static_cast<const T*>(h0),
      static_cast<const T*>(eig), static_cast<const T*>(invd),
      static_cast<const T*>(ews), static_cast<const T*>(inva),
      static_cast<const T*>(w_all), static_cast<const T*>(b_all),
      static_cast<const int*>(pool_gl), static_cast<const T*>(mlp1_w),
      static_cast<float*>(out), dm, cp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dgn_model_max_d() { return kMaxD; }
int dgn_model_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long dgn_model_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long dgn_model_smem_bytes(int window, int d, int gmax, int tout, int slots) {
  const Dims dm{0, window, d, 0, gmax, tout, slots};
  return (long long)(smem_layout(dm).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, eig, invd, ews, inva, w_all, b_all,
// mlp1_w). slot_src [num_windows*window, slots], pool_gl: int32; out: float32
// [num_windows*gmax, tout]. Returns a cudaError_t.
int dgn_model_launch(int dtype, const void* slot_src, const void* h0,
                     const void* eig, const void* invd, const void* ews,
                     const void* inva, const void* w_all, const void* b_all,
                     const void* pool_gl, const void* mlp1_w, void* out,
                     int num_windows, int n, int window, int d, int layers,
                     int gmax, int tout, const int* caps, int slots, int device,
                     void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, d, layers, gmax, tout, slots};
  Caps cp{};
  for (int k = 0; k < slots; ++k) cp.caps[k] = caps[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_src, h0, eig, invd, ews, inva, w_all, b_all, pool_gl,
                        mlp1_w, out, num_windows, dm, cp, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_src, h0, eig, invd, ews, inva, w_all, b_all,
                                pool_gl, mlp1_w, out, num_windows, dm, cp, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* dgn_model_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
