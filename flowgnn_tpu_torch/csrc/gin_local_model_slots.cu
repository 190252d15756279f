// GIN / GIN-VN whole-model slot megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_model_slots (with its helpers _slot_prefix_geom, _slot_accumulate
// and _pool_epilogue). Same operands, same output: [NW*GMAX, T] float32
// per-window pool sums of the prediction head, for all L GIN layers plus
// the finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows, rows sorted by in-degree so that slot k of rows 0..caps[k]-1
// sits in prefix lanes offs[k]..offs[k]+caps[k] of the window's Σc lanes.
// slot_meta holds per lane (src − half, three bond attrs with vocabulary
// offsets); an empty lane has src = W and attrs −1. pool_gl holds each
// row's window-local graph id, GMAX for padding rows.
//
// What bounds it on this card: per window and layer the update MLP costs
// 2·W·D·H multiply-adds (5.1 M at W=128, D=100, H=200), against Σc·D
// gathered values for the messages and 160 KB of f32 weights read from L2.
// Device-memory traffic is small (h is read once, GMAX·T floats are
// written per window), so the kernel is bound on chip: by arithmetic,
// shared-memory traffic and, with one 8-warp block per SM, latency (on an
// H100 80GB HBM3 at 700 W the MLP takes ~44% of the kernel's time and the
// slot messages ~39%; PERF.md). The design keeps a window's h and act
// resident in shared memory for all L layers (the TPU kernel's VMEM
// residency), gathers sources by index instead of the TPU's one-hot
// matmul, accumulates each destination row over its slots with no atomics
// (destination rank r is window row r), and runs the MLP as register-tiled
// FMA over 32-unit chunks of the hidden layer, so the [W, H] hidden
// activation never exists whole. All sums have a fixed order, so results
// are deterministic. Plain FMA, one block per window and one block per SM
// (shared memory) leave the tensor cores idle: wgmma and TMA are later
// work.
//
// Numerics follow the TPU kernel: activations and weights are float or
// bfloat16 (T); every product and sum is float32; messages, act, the hidden
// layer and the new h are rounded to T where the TPU kernel casts to its
// compute dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 16;                // thread rows of the MLP tile
constexpr int kTC = 16;                // thread columns of the MLP tile
constexpr int kRowsPT = 8;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per MLP row block (128)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kHC = 32;                // hidden units per chunk
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kMaxSlots = 8;
// Bond vocabulary rows of the (0, 0, 0) attr that every analytic VN star
// edge carries: the feature offsets {0, 5, 11}.
constexpr int kE0Row0 = 0, kE0Row1 = 5, kE0Row2 = 11;

struct SlotGeom {
  int caps[kMaxSlots];
  int offs[kMaxSlots];
  int slots;
  int sw;  // Σ caps: prefix lanes per window
};

struct Dims {
  int n, window, half, d, hid, layers, vocab, gmax, tout;
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, act, scratch, tab, meta, gl, vn, rows, gstart, total;
};

__host__ __device__ inline Smem smem_layout(const Dims& dm, int sw) {
  const size_t W = dm.window, D = dm.d;
  const size_t mlp = kRB * kHC + kHC * (D + 1) + D * (kHC + 1) + kHC;
  const size_t pooled = size_t(dm.gmax) * 2 * D;
  const size_t pred = W * dm.tout;
  size_t scratch = mlp > pooled ? mlp : pooled;
  if (pred > scratch) scratch = pred;
  if (size_t(dm.gmax) > scratch) scratch = dm.gmax;  // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.act = o; o += W * D;
  s.scratch = o; o += scratch;
  s.tab = o; o += size_t(dm.vocab) * D;
  s.meta = o; o += size_t(sw) * 4;
  s.gl = o; o += W;
  s.vn = o; o += W;
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
gin_slots_kernel(const int* __restrict__ meta, const T* __restrict__ h0,
                 const int* __restrict__ pool_gl, const T* __restrict__ tab,
                 const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2,
                 const float* __restrict__ eps, const T* __restrict__ predw,
                 const T* __restrict__ vn_col, float* __restrict__ out,
                 Dims dm, SlotGeom geo) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm, geo.sw);
  float* h_s = smem + lay.h;        // [W][D] current h
  float* act_s = smem + lay.act;    // [W][D] (1+eps)·h + messages
  float* scr = smem + lay.scratch;  // VN pool, MLP chunks or head outputs
  float* tab_s = smem + lay.tab;    // [vocab][D] this layer's bond table
  int* meta_s = reinterpret_cast<int*>(smem + lay.meta);  // [sw][4]
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);      // [W]
  float* vn_s = smem + lay.vn;                            // [W]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);  // [W] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]

  const int W = dm.window, D = dm.d, tid = threadIdx.x;
  const bool has_vn = vn_col != nullptr;
  const long row0 = long(blockIdx.x) * W;

  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  const int* meta_w = meta + long(blockIdx.x) * geo.sw * 4;
  for (int i = tid; i < geo.sw * 4; i += kThreads) meta_s[i] = meta_w[i];
  for (int r = tid; r < W; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    vn_s[r] = has_vn && row0 + r < dm.n ? ld(vn_col + row0 + r) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    // Group the window's rows by graph (ascending row order within a
    // graph): the VN pool and the finalize then sum each graph's rows in a
    // fixed order, with no atomics.
    int* cursor = reinterpret_cast<int*>(scr);
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

  const int tr = tid / kTC, tc = tid % kTC;
  for (int l = 0; l < dm.layers; ++l) {
    __syncthreads();  // the previous phase is done with tab_s, scr and h_s
    const T* tab_l = tab + long(l) * dm.vocab * D;
    for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab_l + i);
    __syncthreads();

    // Analytic virtual node: per graph, the pooled star messages into the
    // VN (Σ over real rows of relu(h + e0)) and out of it (the same over
    // VN rows), e0 being the (0, 0, 0)-attr bond embedding.
    float* pooled = scr;  // [gmax][2D]: real-row sums ‖ VN-row sums
    if (has_vn) {
      for (int i = tid; i < dm.gmax * D; i += kThreads) {
        const int g = i / D, d = i - g * D;
        const float e0 = tab_s[kE0Row0 * D + d] + tab_s[kE0Row1 * D + d] +
                         tab_s[kE0Row2 * D + d];
        float s_real = 0.f, s_vn = 0.f;
        for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) {
          const int r = rows_s[j];
          const float v = rnd<T>(fmaxf(h_s[r * D + d] + e0, 0.f));
          if (vn_s[r] != 0.f) s_vn += v; else s_real += v;
        }
        pooled[g * 2 * D + d] = s_real;
        pooled[g * 2 * D + D + d] = s_vn;
      }
      __syncthreads();
    }

    // Messages: row r's slot k is lane offs[k] + r for r < caps[k].
    const float eps_l = eps[l];
    for (int i = tid; i < W * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float acc = 0.f;
      for (int k = 0; k < geo.slots; ++k) {
        if (r >= geo.caps[k]) continue;
        const int* m = meta_s + (geo.offs[k] + r) * 4;
        const int src = m[0] + dm.half;
        if (unsigned(src) >= unsigned(W)) continue;  // empty lane
        float ee = 0.f;
        for (int f = 1; f < 4; ++f)
          if (m[f] >= 0) ee += tab_s[m[f] * D + d];
        acc += rnd<T>(fmaxf(h_s[src * D + d] + ee, 0.f));
      }
      if (has_vn) {
        const int g = gl_s[r];
        if (unsigned(g) < unsigned(dm.gmax))
          acc += vn_s[r] != 0.f ? pooled[g * 2 * D + d] : pooled[g * 2 * D + D + d];
      }
      act_s[i] = rnd<T>(__fadd_rn(acc, __fmul_rn(eps_l, h_s[i])));
    }
    __syncthreads();

    // Update MLP: h = act·w1ᵀ + b1 → relu → ·w2ᵀ + b2 (→ relu), over row
    // blocks of kRB rows and chunks of kHC hidden units. Each thread owns
    // kRowsPT × kColsPT outputs in registers across all chunks.
    float* hid_s = scr;                    // [kRB][kHC]
    float* w1c = hid_s + kRB * kHC;        // [kHC][D+1]
    float* w2c = w1c + kHC * (D + 1);      // [D][kHC+1]
    float* b1c = w2c + D * (kHC + 1);      // [kHC]
    const T* w1_l = w1 + long(l) * dm.hid * D;
    const T* w2_l = w2 + long(l) * D * dm.hid;
    for (int rb = 0; rb < W; rb += kRB) {
      float o[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
      for (int j0 = 0; j0 < dm.hid; j0 += kHC) {
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < kHC * D; i += kThreads) {
          const int j = i / D, k = i - j * D;
          w1c[j * (D + 1) + k] = j0 + j < dm.hid ? ld(w1_l + long(j0 + j) * D + k) : 0.f;
        }
        for (int i = tid; i < D * kHC; i += kThreads) {
          const int c = i / kHC, j = i - c * kHC;
          w2c[c * (kHC + 1) + j] = j0 + j < dm.hid ? ld(w2_l + long(c) * dm.hid + j0 + j) : 0.f;
        }
        for (int j = tid; j < kHC; j += kThreads)
          b1c[j] = j0 + j < dm.hid ? ld(b1 + long(l) * dm.hid + j0 + j) : 0.f;
        __syncthreads();

        float z[kRowsPT][kHcPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) z[i][m] = 0.f;
        for (int k = 0; k < D; ++k) {
          float a[kRowsPT], wv[kHcPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) {
            const int r = rb + tr + kTR * i;
            a[i] = r < W ? act_s[r * D + k] : 0.f;
          }
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) wv[m] = w1c[(tc + kTC * m) * (D + 1) + k];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
            for (int m = 0; m < kHcPT; ++m) z[i][m] = fmaf(a[i], wv[m], z[i][m]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int m = 0; m < kHcPT; ++m) {
            const int j = tc + kTC * m;
            hid_s[(tr + kTR * i) * kHC + j] = rnd<T>(fmaxf(z[i][m] + b1c[j], 0.f));
          }
        __syncthreads();

        for (int j = 0; j < kHC; ++j) {
          float hv[kRowsPT], wv[kColsPT];
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) hv[i] = hid_s[(tr + kTR * i) * kHC + j];
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) {
            const int c = tc + kTC * m;
            wv[m] = c < D ? w2c[c * (kHC + 1) + j] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
            for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(hv[i], wv[m], o[i][m]);
        }
      }
      // h_s is not read during the MLP, so its rows can be replaced here.
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int r = rb + tr + kTR * i, c = tc + kTC * m;
          if (r < W && c < D) {
            float v = o[i][m] + ld(b2 + long(l) * D + c);
            if (l != dm.layers - 1) v = fmaxf(v, 0.f);
            h_s[r * D + c] = rnd<T>(v);
          }
        }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = h·pred_w, then per-graph sums of p.
  float* p_s = scr;  // [W][T]
  for (int i = tid; i < W * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(h_s[r * D + d], ld(predw + d * dm.tout + t), s);
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

SlotGeom make_geom(const int* caps, int slots) {
  SlotGeom geo{};
  geo.slots = slots;
  int off = 0;
  for (int k = 0; k < slots; ++k) {
    geo.caps[k] = caps[k];
    geo.offs[k] = off;
    off += caps[k];
  }
  geo.sw = off;
  return geo;
}

Dims make_dims(int n, int window, int half, int d, int hid, int layers,
               int vocab, int gmax, int tout) {
  return Dims{n, window, half, d, hid, layers, vocab, gmax, tout};
}

template <typename T>
cudaError_t launch(const void* meta, const void* h0, const void* pool_gl,
                   const void* tab, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* eps,
                   const void* predw, const void* vn_col, void* out,
                   int num_windows, const Dims& dm, const SlotGeom& geo,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm, geo.sw).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gin_slots_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gin_slots_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h0),
      static_cast<const int*>(pool_gl), static_cast<const T*>(tab),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps), static_cast<const T*>(predw),
      static_cast<const T*>(vn_col), static_cast<float*>(out), dm, geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gin_slots_max_d() { return kMaxD; }
int gin_slots_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_slots_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long gin_slots_smem_bytes(int window, int d, int vocab, int gmax,
                               int tout, const int* caps, int slots) {
  const Dims dm = make_dims(0, window, 0, d, 0, 0, vocab, gmax, tout);
  return (long long)(smem_layout(dm, make_geom(caps, slots).sw).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, tables, weights, biases, pred_w,
// vn_col). meta, pool_gl: int32; eps: float32 [L]; out: float32
// [num_windows*gmax, tout]. vn_col may be null. Returns a cudaError_t.
int gin_slots_launch(int dtype, const void* meta, const void* h0,
                     const void* pool_gl, const void* tab, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* eps, const void* predw, const void* vn_col,
                     void* out, int num_windows, int n, int window, int half,
                     int d, int hid, int layers, int vocab, int gmax, int tout,
                     const int* caps, int slots, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm = make_dims(n, window, half, d, hid, layers, vocab, gmax, tout);
  const SlotGeom geo = make_geom(caps, slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                        vn_col, out, num_windows, dm, geo, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps,
                                predw, vn_col, out, num_windows, dm, geo, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gin_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
