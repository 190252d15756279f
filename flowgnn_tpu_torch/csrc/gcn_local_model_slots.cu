// GCN whole-model slot megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_model_slots (with its helpers _slot_prefix_geom, _slot_accumulate
// and _pool_epilogue). Same operands, same output: [NW*GMAX, T] float32
// per-window pool sums of the prediction head, for all L GCN layers plus the
// finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch): node windows
// of W rows, rows sorted by in-degree so that slot k of rows 0..caps[k]-1
// sits in prefix lanes offs[k]..offs[k]+caps[k] of the window's sum(caps)
// lanes. slot_meta holds per lane (src - half, three bond attrs with
// vocabulary offsets); an empty lane has src = W and attrs -1. pool_gl holds
// each row's window-local graph id, GMAX for padding rows.
//
// Per layer l, for window row v and its slot sources u:
//   msg = rnd(dis_u * relu(h_u + ee_l))        ee_l: three bond-table rows
//   acc = sum of msg over v's slots, in slot order
//   a   = acc * dis_v + relu(h_v + root_l) * dis_v^2
//   x   = alpha_l * a + beta_l                 (BatchNorm folded on the host)
// then h = rnd(rnd(relu(x)) . wn_l + bn_l) between layers, and after the last
// layer the head pools rnd(x) . pred_w (no relu; _pool_epilogue).
//
// What bounds it on this card: per window and layer the next-conv matmul is
// W*D*D multiply-adds (1.28 M at W=128, D=100) against sum(caps)*D gathered
// values for the messages; h is read once and GMAX*T floats written per
// window, so device-memory traffic is small and the kernel is bound on chip
// (arithmetic, shared-memory traffic and latency, one 256-thread block per
// SM at ~155 KB of shared memory). The design keeps a window's h and the
// next conv's input resident in shared memory for all L layers (the TPU
// kernel's VMEM residency), with one layer's f32 weights (40 KB) beside
// them; gathers sources by index instead of the TPU's one-hot matmul; runs
// the messages one warp per destination row, the lanes over D, so that each
// lane's slot metadata is read once per row as a broadcast and no index is
// divided; accumulates each row over its slots in a fixed order with no
// atomics (destination rank r is window row r); and runs the conv as
// register-tiled FMA. Plain FMA and one block per window leave the tensor
// cores idle: wgmma and TMA are later work.
//
// Numerics follow the TPU kernel: activations, norms and weights are float
// or bfloat16 (T); every product and sum is float32; messages, the next
// conv's input, the new h and the head's input are rounded to T where the
// TPU kernel casts to its compute dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;                // thread rows of the conv tile
constexpr int kTC = 16;                // thread columns of the conv tile
constexpr int kRowsPT = 8;             // rows per thread
constexpr int kRB = kTR * kRowsPT;     // rows per conv row block (128)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kMaxSlots = 8;

struct SlotGeom {
  int caps[kMaxSlots];
  int offs[kMaxSlots];
  int slots;
  int sw;  // sum of caps: prefix lanes per window
};

struct Dims {
  int n, window, half, d, layers, vocab, gmax, tout;
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t h, x, w, tab, vec, meta, dis, gl, rows, gstart, total;
};

__host__ __device__ inline Smem smem_layout(const Dims& dm, int sw) {
  const size_t W = dm.window, D = dm.d;
  size_t wbuf = D * D;                                // next-conv weights
  if (W * dm.tout > wbuf) wbuf = W * dm.tout;         // head outputs
  if (size_t(dm.gmax) > wbuf) wbuf = dm.gmax;         // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += W * D;
  s.x = o; o += W * D;
  s.w = o; o += wbuf;
  s.tab = o; o += size_t(dm.vocab) * D;
  s.vec = o; o += 3 * D;
  s.meta = o; o += size_t(sw) * 4;
  s.dis = o; o += W;
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
gcn_slots_kernel(const int* __restrict__ meta, const T* __restrict__ h0,
                 const T* __restrict__ dis, const int* __restrict__ pool_gl,
                 const T* __restrict__ tab, const T* __restrict__ roots,
                 const T* __restrict__ alphas, const T* __restrict__ betas,
                 const T* __restrict__ wn, const T* __restrict__ bn,
                 const T* __restrict__ predw, float* __restrict__ out,
                 Dims dm, SlotGeom geo) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(dm, geo.sw);
  const int W = dm.window, D = dm.d, tid = threadIdx.x;
  float* h_s = smem + lay.h;        // [W][D] current h
  float* x_s = smem + lay.x;        // [W][D] rnd(relu(x)), or rnd(x) after the last layer
  float* w_s = smem + lay.w;        // [D][D] wn_l as [in][out]; head outputs; CSR cursor
  float* tab_s = smem + lay.tab;    // [vocab][D] this layer's bond table
  float* root_s = smem + lay.vec;   // [D] root_l, then alpha_l and beta_l
  float* alpha_s = root_s + D;
  float* beta_s = alpha_s + D;
  int* meta_s = reinterpret_cast<int*>(smem + lay.meta);  // [sw][4]
  float* dis_s = smem + lay.dis;                          // [W]
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);      // [W]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);  // [W] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]

  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  const int* meta_w = meta + long(blockIdx.x) * geo.sw * 4;
  for (int i = tid; i < geo.sw * 4; i += kThreads) meta_s[i] = meta_w[i];
  for (int r = tid; r < W; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    dis_s[r] = row0 + r < dm.n ? ld(dis + row0 + r) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    // Group the window's rows by graph (ascending row order within a
    // graph): the finalize then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(w_s);
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
    __syncthreads();  // the previous phase is done with tab_s, w_s and h_s
    const T* tab_l = tab + long(l) * dm.vocab * D;
    for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab_l + i);
    for (int i = tid; i < D; i += kThreads) {
      root_s[i] = ld(roots + long(l) * D + i);
      alpha_s[i] = ld(alphas + long(l) * D + i);
      beta_s[i] = ld(betas + long(l) * D + i);
    }
    if (!last) {
      const T* wn_l = wn + long(l) * D * D;
      for (int i = tid; i < D * D; i += kThreads) w_s[i] = ld(wn_l + i);
    }
    __syncthreads();

    // Messages, one warp per destination row r: row r's slot k is lane
    // offs[k] + r for r < caps[k]; lane j of the warp holds columns
    // j, j + 32, ... of the row.
    for (int r = warp; r < W; r += kWarps) {
      float acc[kLaneD];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
      for (int k = 0; k < geo.slots; ++k) {
        if (r >= geo.caps[k]) continue;
        const int* m = meta_s + (geo.offs[k] + r) * 4;
        const int src = m[0] + dm.half;
        if (unsigned(src) >= unsigned(W)) continue;  // empty lane
        const float dis_u = dis_s[src];
        const float* hu = h_s + src * D;
        const float* e1 = m[1] >= 0 ? tab_s + m[1] * D : nullptr;
        const float* e2 = m[2] >= 0 ? tab_s + m[2] * D : nullptr;
        const float* e3 = m[3] >= 0 ? tab_s + m[3] * D : nullptr;
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) {
          const int d = lane + 32 * j;
          if (d >= D) break;
          float ee = 0.f;
          if (e1) ee += e1[d];
          if (e2) ee += e2[d];
          if (e3) ee += e3[d];
          acc[j] += rnd<T>(__fmul_rn(dis_u, fmaxf(hu[d] + ee, 0.f)));
        }
      }
      const float dv = dis_s[r];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int d = lane + 32 * j;
        if (d >= D) break;
        const float root = fmaxf(h_s[r * D + d] + root_s[d], 0.f);
        const float a = __fadd_rn(__fmul_rn(acc[j], dv), __fmul_rn(root, __fmul_rn(dv, dv)));
        const float x = __fadd_rn(__fmul_rn(alpha_s[d], a), beta_s[d]);
        x_s[r * D + d] = last ? rnd<T>(x) : rnd<T>(fmaxf(x, 0.f));
      }
    }
    if (last) break;
    __syncthreads();

    // Next conv: h = rnd(x_s . wn_l + bn_l), over row blocks of kRB rows.
    // Each thread owns kRowsPT x kColsPT outputs in registers. h_s is not
    // read here, so its rows can be replaced.
    const T* bn_l = bn + long(l) * D;
    for (int rb = 0; rb < W; rb += kRB) {
      float o[kRowsPT][kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
      for (int k = 0; k < D; ++k) {
        float a[kRowsPT], wv[kColsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const int r = rb + tr + kTR * i;
          a[i] = r < W ? x_s[r * D + k] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = tc + kTC * m;
          wv[m] = c < D ? w_s[k * D + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
          for (int m = 0; m < kColsPT; ++m) o[i][m] = fmaf(a[i], wv[m], o[i][m]);
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int r = rb + tr + kTR * i, c = tc + kTC * m;
          if (r < W && c < D) h_s[r * D + c] = rnd<T>(o[i][m] + ld(bn_l + c));
        }
    }
  }
  __syncthreads();

  // Finalize: per-row head p = rnd(x) . pred_w, then per-graph sums of p.
  float* p_s = w_s;  // [W][T]
  for (int i = tid; i < W * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(x_s[r * D + d], ld(predw + d * dm.tout + t), s);
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

template <typename T>
cudaError_t launch(const void* meta, const void* h0, const void* dis,
                   const void* pool_gl, const void* tab, const void* roots,
                   const void* alphas, const void* betas, const void* wn,
                   const void* bn, const void* predw, void* out,
                   int num_windows, const Dims& dm, const SlotGeom& geo,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm, geo.sw).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_slots_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gcn_slots_kernel<T><<<num_windows, kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h0),
      static_cast<const T*>(dis), static_cast<const int*>(pool_gl),
      static_cast<const T*>(tab), static_cast<const T*>(roots),
      static_cast<const T*>(alphas), static_cast<const T*>(betas),
      static_cast<const T*>(wn), static_cast<const T*>(bn),
      static_cast<const T*>(predw), static_cast<float*>(out), dm, geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gcn_slots_max_d() { return kMaxD; }
int gcn_slots_max_slots() { return kMaxSlots; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_slots_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs for this geometry.
long long gcn_slots_smem_bytes(int window, int d, int vocab, int gmax,
                               int tout, const int* caps, int slots) {
  const Dims dm{0, window, 0, d, 0, vocab, gmax, tout};
  return (long long)(smem_layout(dm, make_geom(caps, slots).sw).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, dis, tables, roots, alphas, betas,
// wn, bn, pred_w). meta, pool_gl: int32; out: float32
// [num_windows*gmax, tout]. Returns a cudaError_t.
int gcn_slots_launch(int dtype, const void* meta, const void* h0,
                     const void* dis, const void* pool_gl, const void* tab,
                     const void* roots, const void* alphas, const void* betas,
                     const void* wn, const void* bn, const void* predw,
                     void* out, int num_windows, int n, int window, int half,
                     int d, int layers, int vocab, int gmax, int tout,
                     const int* caps, int slots, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || d < 1 || d > kMaxD || num_windows < 1 ||
      layers < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, half, d, layers, vocab, gmax, tout};
  const SlotGeom geo = make_geom(caps, slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h0, dis, pool_gl, tab, roots, alphas, betas, wn,
                        bn, predw, out, num_windows, dm, geo, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h0, dis, pool_gl, tab, roots, alphas,
                                betas, wn, bn, predw, out, num_windows, dm,
                                geo, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gcn_slots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
