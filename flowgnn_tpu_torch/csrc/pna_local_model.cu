// PNA whole-model slot megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// pna_local_model (with its helpers _slot_onehot and _pool_epilogue). Same
// operands, same output: [NW*GMAX, T] float32 per-window pool sums of
// h . mlp1_w (readout MLP-1), for all L PNA conv layers plus the finalize,
// in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; slot_src [NW*W, S] holds each row's
// in-window sources, sentinel W for an empty slot, and slot k counts only
// for rows below caps[k] (the TPU kernel's prefix-sliced gathers). pool_gl
// holds each row's window-local graph id, GMAX for padding rows.
//
// Per layer, for window row v and its valid slot sources u:
//   s, q, mn, mx = sum, sum of squares, min and max of h_u, in slot order,
//                  mn seeded at min_init and mx at max_init (the ap_fixed
//                  extremes, so a row with no source keeps the seeds)
//   mean = s * invd_v, std = sqrt(max(q * invd_v - mean^2, 0))
//   y    = [rnd(mean) | rnd(mn) | rnd(mx) | rnd(std)] . w_l      [4D] -> [3D]
//   acc  = y[:D] + t_v * y[D:2D] + scale_v * y[2D:] + b_l
//   h    = rnd(h + relu(acc))
// and after the last layer the head pools h . mlp1_w (_pool_epilogue).
// q * invd - mean^2 is computed with __fmul_rn / __fsub_rn: a contracted FMA
// would leave a residual of ~1e-8 * x^2 where the plain version has exactly
// 0 (one in-edge), which the sqrt turns into ~1e-4 * |x|.
//
// What bounds it on this card: per window and layer the tower is
// W*4D*3D multiply-adds (9.8 M at W=128, D=80), against S*W*D gathered
// values for the four aggregates; h is read once and GMAX*T floats written
// per window, so the kernel is bound on chip (arithmetic, shared-memory
// traffic and latency). Shared memory cannot hold a whole layer: h is
// 40 KB in f32, the [W, 4D] stats 160 KB and one layer's f32 tower
// 307 KB. So the design keeps h and the next h resident for all L layers
// (the TPU kernel's VMEM residency), computes the stats and the tower over
// row blocks of kRB = 64 rows (stats 82 KB), and streams the tower's
// weights from L2 in chunks of kKC = 32 input channels (30 KB) into shared
// memory; ~201 KB in all at W=128, one 256-thread block per SM. The stats
// run one warp per destination row with the lanes over D (slot indices read
// once per row, as a broadcast); the tower is register-tiled FMA, each
// thread holding the three scaler outputs of its 4 rows x 5 columns. Every
// sum has a fixed order and no atomics. wgmma and TMA are later work.
//
// Numerics follow the TPU kernel: activations, scalers and weights are float
// or bfloat16 (T); every product and sum is float32; the stats and the new
// h are rounded to T where the TPU kernel casts to its compute dtype.

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
  int n, window, d, layers, gmax, tout, slots;
  float min_init, max_init;
};

struct Caps {
  int caps[kMaxSlots];
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, hn, st, wc, src, aux, gl, rows, gstart, total;
};

__host__ __device__ inline Smem smem_layout(const Dims& dm) {
  const size_t W = dm.window, D = dm.d;
  size_t st = size_t(kRB) * (4 * D + 1);            // stats, row stride 4D+1
  if (W * dm.tout > st) st = W * dm.tout;           // head outputs
  if (size_t(dm.gmax) > st) st = dm.gmax;           // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.hn = o; o += W * D;
  s.st = o; o += st;
  s.wc = o; o += size_t(kKC) * 3 * D;
  s.src = o; o += W * dm.slots;
  s.aux = o; o += 3 * W;
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
pna_model_kernel(const int* __restrict__ slot_src, const T* __restrict__ h0,
                 const T* __restrict__ invd, const T* __restrict__ tdeg,
                 const T* __restrict__ scale, const T* __restrict__ w_all,
                 const T* __restrict__ b_all, const int* __restrict__ pool_gl,
                 const T* __restrict__ mlp1_w, float* __restrict__ out,
                 Dims dm, Caps cp) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm);
  const int W = dm.window, D = dm.d, S = dm.slots, tid = threadIdx.x;
  const int K4 = 4 * D, N3 = 3 * D, SP = K4 + 1;
  float* h_s = smem + lay.h;       // [W][D] current h
  float* hn_s = smem + lay.hn;     // [W][D] next h
  float* st_s = smem + lay.st;     // [kRB][SP] stats; head outputs; CSR cursor
  float* wc_s = smem + lay.wc;     // [kKC][3D] a chunk of this layer's tower
  int* src_s = reinterpret_cast<int*>(smem + lay.src);  // [W][S]
  float* invd_s = smem + lay.aux;  // [W] 1/max(in_deg, 1), then t and scale
  float* t_s = invd_s + W;
  float* sc_s = t_s + W;
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
    invd_s[r] = real ? ld(invd + row0 + r) : 0.f;
    t_s[r] = real ? ld(tdeg + row0 + r) : 0.f;
    sc_s[r] = real ? ld(scale + row0 + r) : 0.f;
    gl_s[r] = pool_gl[row0 + r];
  }
  __syncthreads();
  if (tid == 0) {
    // Group the window's rows by graph (ascending row order within a
    // graph): the finalize then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(st_s);
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
    const T* w_l = w_all + long(l) * K4 * N3;
    for (int rb = 0; rb < W; rb += kRB) {
      __syncthreads();  // st_s and wc_s are free; last layer's h is complete

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

      // Tower: y[r][p*D + c] = sum_k st[r][k] . w_l[k][p*D + c], the weight
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
        for (int i = tid; i < kn * N3; i += kThreads) wc_s[i] = ld(w_l + long(kc) * N3 + i);
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

      // Scalers, bias and residual into the next h.
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = rb + tr + kTR * i;
        if (r >= W) continue;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          if (c >= D) continue;
          float a = __fadd_rn(acc[i][0][m], __fmul_rn(t_s[r], acc[i][1][m]));
          a = __fadd_rn(a, __fmul_rn(sc_s[r], acc[i][2][m]));
          a = __fadd_rn(a, ld(b_all + long(l) * D + c));
          hn_s[r * D + c] = rnd<T>(__fadd_rn(h_s[r * D + c], fmaxf(a, 0.f)));
        }
      }
    }
    float* tmp = h_s;
    h_s = hn_s;
    hn_s = tmp;
  }
  __syncthreads();

  // Finalize: per-row head p = h . mlp1_w, then per-graph sums of p.
  float* p_s = st_s;  // [W][T]
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
cudaError_t launch(const void* slot_src, const void* h0, const void* invd,
                   const void* tdeg, const void* scale, const void* w_all,
                   const void* b_all, const void* pool_gl, const void* mlp1_w,
                   void* out, int num_windows, const Dims& dm, const Caps& cp,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pna_model_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  pna_model_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(slot_src), static_cast<const T*>(h0),
      static_cast<const T*>(invd), static_cast<const T*>(tdeg),
      static_cast<const T*>(scale), static_cast<const T*>(w_all),
      static_cast<const T*>(b_all), static_cast<const int*>(pool_gl),
      static_cast<const T*>(mlp1_w), static_cast<float*>(out), dm, cp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pna_model_max_d() { return kMaxD; }
int pna_model_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long pna_model_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long pna_model_smem_bytes(int window, int d, int gmax, int tout, int slots) {
  const Dims dm{0, window, d, 0, gmax, tout, slots, 0.f, 0.f};
  return (long long)(smem_layout(dm).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, invd, t, scale, w_all, b_all,
// mlp1_w). slot_src [num_windows*window, slots], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. min_init / max_init seed the running min
// and max. Returns a cudaError_t.
int pna_model_launch(int dtype, const void* slot_src, const void* h0,
                     const void* invd, const void* tdeg, const void* scale,
                     const void* w_all, const void* b_all, const void* pool_gl,
                     const void* mlp1_w, void* out, int num_windows, int n,
                     int window, int d, int layers, int gmax, int tout,
                     float min_init, float max_init, const int* caps,
                     int slots, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, d, layers, gmax, tout, slots, min_init, max_init};
  Caps cp{};
  for (int k = 0; k < slots; ++k) cp.caps[k] = caps[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(slot_src, h0, invd, tdeg, scale, w_all, b_all, pool_gl,
                        mlp1_w, out, num_windows, dm, cp, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(slot_src, h0, invd, tdeg, scale, w_all, b_all,
                                pool_gl, mlp1_w, out, num_windows, dm, cp, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* pna_model_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
