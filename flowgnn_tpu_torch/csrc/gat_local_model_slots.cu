// GAT whole-model slot megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernels flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_model_pairs (the default), gat_local_model_slots and
// gat_local_model_dense (with their helper _pool_epilogue). The three compute
// the same function, the whole GAT model per node window; they differ in how
// they fill the TPU's 128-lane tiles (two windows per tile, a fused glue
// matmul, a dense [W, W] mask) and, in bf16 only, in where the scores round.
// This kernel follows the numerics of the default, gat_local_model_pairs.
// Output: [NW*GMAX, T] float32 per-window pool sums of the head-averaged
// prediction, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows sorted by in-degree; slot_pstack [NW*sum(c)] holds, for slot k
// and row r < caps[k], the source of row r's k-th in-edge at lane
// offs[k] + r, sentinel W for an empty lane. GAT's self edges come first, so
// slot 0 is full. pool_gl holds each row's window-local graph id, GMAX for
// padding rows.
//
// Per layer, for window row v, its valid lanes u -> v and each head k:
//   [s_src | s_tgt] = h . a_l           (from the rounded h, kept float32)
//   score = exp(leaky(s_src[v,k] + s_tgt[u,k], 0.2))  (no max subtraction)
//   msg   = rnd(sum score * h_u / sum score)            (zero sum -> 1)
// then, between layers,
//   feat = rnd(ELU(msg + skip)),  h = rnd(feat . proj_{l+1}),
//   skip = feat . skip_{l+1}      (float32, not rounded)
// and on the last layer the head pools rnd(msg + skip) . pred_hd, the head
// average composed with the prediction head (_pool_epilogue). The exp is
// expf, the reference's raw exp: a valid edge whose score overflows gives
// inf / inf as the reference does. An empty lane is skipped, not multiplied
// by a zero mask, so a non-edge's score never enters a sum.
//
// What bounds it on this card: per window and layer the messages are
// sum(c) lanes x H*D multiply-adds plus sum(c) x H exps, the glue
// W x H*D x 2*H*D multiply-adds (1 M at W=128, H*D=64); h0 and skip0 are
// read once and GMAX*T floats written per window, so the kernel is bound on
// chip (latency of the dependent layer chain and shared-memory traffic).
// Everything of a window fits a block: h, skip and msg/feat [W, H*D] f32 are
// 32 KB each at W=128, one layer's proj | skip [H*D, 2*H*D] 32 KB, ~143 KB
// in all, one 256-thread block per SM. The messages run one warp per
// destination row with the lanes over H*D (each lane's head sum computed
// beside its numerator, in the same order); the glue is register-tiled FMA,
// each thread holding 8 rows x 8 columns. Every sum has a fixed order and
// no atomics. wgmma and TMA are later work.
//
// Numerics: activations and weights are float or bfloat16 (T); every
// product and sum is float32; msg, feat, h and the final msg + skip round
// to T where the TPU kernel casts to its compute dtype; the scores and the
// skip term of layers >= 1 stay float32, as in gat_local_model_pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;                // thread rows of the glue tile
constexpr int kTC = 16;                // thread columns of the glue tile
constexpr int kRowsPT = 8;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per glue block (128)
constexpr int kColsPT = 8;             // output columns per thread
constexpr int kMaxHD = kTC * kColsPT / 2;  // widest H*D the glue tile covers (64)
constexpr int kLaneHD = (kMaxHD + 31) / 32;  // H*D columns per lane in the messages
constexpr int kMaxHeads = 8;
constexpr int kMaxSlots = 8;

struct Dims {
  int n, window, hd, heads, layers, gmax, tout, slots, lanes;
};

struct Caps {
  int caps[kMaxSlots];
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, skip, m, sc, w, a, p, src, gl, rows, gstart, total;
};

__host__ __device__ inline Smem smem_layout(const Dims& dm) {
  const size_t W = dm.window, HD = dm.hd, H2 = 2 * size_t(dm.heads);
  size_t p = W * dm.tout;                // head outputs
  if (size_t(dm.gmax) > p) p = dm.gmax;  // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += W * HD;
  s.skip = o; o += W * HD;
  s.m = o; o += W * HD;
  s.sc = o; o += W * H2;
  s.w = o; o += HD * 2 * HD;
  s.a = o; o += HD * H2;
  s.p = o; o += p;
  s.src = o; o += dm.lanes;
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
gat_slots_kernel(const int* __restrict__ pstack, const T* __restrict__ h0,
                 const T* __restrict__ skip0, const T* __restrict__ proj_w,
                 const T* __restrict__ skip_w, const T* __restrict__ a_all,
                 const int* __restrict__ pool_gl, const T* __restrict__ pred_hd,
                 float* __restrict__ out, Dims dm, Caps cp) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm);
  const int W = dm.window, HD = dm.hd, H = dm.heads, H2 = 2 * H;
  const int DH = HD / H, HD2 = 2 * HD, tid = threadIdx.x;
  float* h_s = smem + lay.h;       // [W][HD] h (rounded values)
  float* sk_s = smem + lay.skip;   // [W][HD] skip term
  float* m_s = smem + lay.m;       // [W][HD] msg, then feat or the final sum
  float* sc_s = smem + lay.sc;     // [W][2H] s_src | s_tgt
  float* w_s = smem + lay.w;       // [HD][2HD] proj_{l+1} | skip_{l+1}
  float* a_s = smem + lay.a;       // [HD][2H] this layer's score map
  float* p_s = smem + lay.p;       // [W][T] head outputs; CSR cursor
  int* src_s = reinterpret_cast<int*>(smem + lay.src);        // [sum(c)]
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [W]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [W] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]

  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * HD; i += kThreads) {
    const int r = i / HD;
    const bool real = row0 + r < dm.n;
    const long at = (row0 + r) * HD + (i - r * HD);
    h_s[i] = real ? ld(h0 + at) : 0.f;
    sk_s[i] = real ? ld(skip0 + at) : 0.f;
  }
  for (int i = tid; i < dm.lanes; i += kThreads) src_s[i] = pstack[long(blockIdx.x) * dm.lanes + i];
  for (int r = tid; r < W; r += kThreads) gl_s[r] = pool_gl[row0 + r];
  __syncthreads();
  if (tid == 0) {
    // Group the window's rows by graph (ascending row order within a
    // graph): the finalize then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(p_s);
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
    const bool last = l == dm.layers - 1;
    __syncthreads();  // h and skip are complete; w_s and a_s are consumed
    for (int i = tid; i < HD * H2; i += kThreads) a_s[i] = ld(a_all + long(l) * HD * H2 + i);
    if (!last) {
      const long wl = long(l) * HD * HD;
      for (int i = tid; i < HD * HD2; i += kThreads) {
        const int k = i / HD2, c = i - k * HD2;
        w_s[i] = c < HD ? ld(proj_w + wl + k * HD + c) : ld(skip_w + wl + k * HD + c - HD);
      }
    }
    __syncthreads();

    // Scores of every row from the rounded h.
    for (int i = tid; i < W * H2; i += kThreads) {
      const int r = i / H2, c = i - r * H2;
      float s = 0.f;
      for (int j = 0; j < HD; ++j) s = fmaf(h_s[r * HD + j], a_s[j * H2 + c], s);
      sc_s[i] = s;
    }
    __syncthreads();

    // Messages, one warp per destination row, lanes over H*D; then the
    // ELU (between layers) or the final sum, into m_s.
    for (int r = warp; r < W; r += kWarps) {
      float num[kLaneHD], den[kLaneHD];
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) { num[j] = 0.f; den[j] = 0.f; }
      int off = 0;
      for (int k = 0; k < dm.slots; off += cp.caps[k], ++k) {
        if (r >= cp.caps[k]) continue;
        const int src = src_s[off + r];
        if (unsigned(src) >= unsigned(W)) continue;  // empty lane
#pragma unroll
        for (int j = 0; j < kLaneHD; ++j) {
          const int c = lane + 32 * j;
          if (c >= HD) break;
          const int head = c / DH;
          const float raw = __fadd_rn(sc_s[r * H2 + head], sc_s[src * H2 + H + head]);
          const float score = expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
          num[j] = __fadd_rn(num[j], __fmul_rn(score, h_s[src * HD + c]));
          den[j] = __fadd_rn(den[j], score);
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) {
        const int c = lane + 32 * j;
        if (c >= HD) break;
        const float msg = rnd<T>(num[j] / (den[j] == 0.f ? 1.f : den[j]));
        const float x = __fadd_rn(msg, sk_s[r * HD + c]);
        m_s[r * HD + c] = last ? rnd<T>(x) : rnd<T>(x <= 0.f ? __fsub_rn(expf(x), 1.f) : x);
      }
    }
    if (last) break;
    __syncthreads();

    // Glue: [h | skip] = feat . [proj_{l+1} | skip_{l+1}], h rounded.
    for (int rb = 0; rb < W; rb += kRB) {
      float acc[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
      for (int k = 0; k < HD; ++k) {
        float a[kRowsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const int r = rb + tr + kTR * i;
          a[i] = r < W ? m_s[r * HD + k] : 0.f;
        }
        const float* wrow = w_s + k * HD2;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          const float wv = c < HD2 ? wrow[c] : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(a[i], wv, acc[i][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = rb + tr + kTR * i;
        if (r >= W) continue;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          if (c < HD) h_s[r * HD + c] = rnd<T>(acc[i][m]);
          else if (c < HD2) sk_s[r * HD + c - HD] = acc[i][m];
        }
      }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = rnd(msg + skip) . pred_hd, then per-graph sums.
  for (int i = tid; i < W * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int c = 0; c < HD; ++c) s = fmaf(m_s[r * HD + c], ld(pred_hd + c * dm.tout + t), s);
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
cudaError_t launch(const void* pstack, const void* h0, const void* skip0,
                   const void* proj_w, const void* skip_w, const void* a_all,
                   const void* pool_gl, const void* pred_hd, void* out,
                   int num_windows, const Dims& dm, const Caps& cp,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gat_slots_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gat_slots_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(pstack), static_cast<const T*>(h0),
      static_cast<const T*>(skip0), static_cast<const T*>(proj_w),
      static_cast<const T*>(skip_w), static_cast<const T*>(a_all),
      static_cast<const int*>(pool_gl), static_cast<const T*>(pred_hd),
      static_cast<float*>(out), dm, cp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_slots_max_d() { return kMaxHD; }
int gat_slots_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_slots_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry; lanes is
// sum(caps), the prefix lanes per window.
long long gat_slots_smem_bytes(int window, int hd, int heads, int gmax, int tout,
                               int lanes) {
  const Dims dm{0, window, hd, heads, 0, gmax, tout, 0, lanes};
  return (long long)(smem_layout(dm).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, skip0, proj_w, skip_w, a_all,
// pred_hd). slot_pstack [num_windows*sum(caps)], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. Returns a cudaError_t.
int gat_slots_launch(int dtype, const void* pstack, const void* h0,
                     const void* skip0, const void* proj_w, const void* skip_w,
                     const void* a_all, const void* pool_gl, const void* pred_hd,
                     void* out, int num_windows, int n, int window, int hd,
                     int heads, int layers, int gmax, int tout, const int* caps,
                     int slots, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || hd < 1 || hd > kMaxHD || heads < 1 ||
      heads > kMaxHeads || hd % heads || layers < 1 || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Caps cp{};
  int lanes = 0;
  for (int k = 0; k < slots; ++k) {
    cp.caps[k] = caps[k];
    lanes += caps[k];
  }
  const Dims dm{n, window, hd, heads, layers, gmax, tout, slots, lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl, pred_hd,
                        out, num_windows, dm, cp, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(pstack, h0, skip0, proj_w, skip_w, a_all, pool_gl,
                                pred_hd, out, num_windows, dm, cp, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
