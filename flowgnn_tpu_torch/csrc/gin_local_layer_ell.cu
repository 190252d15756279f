// One GIN / GIN-VN layer over the ELL layout for Hopper (sm_90a): kernel
// table row 13.
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// local_scatter_apply_ell_attr with the gin_local_layer_ell epilogue, and
// _local_scatter_apply_ell_wps, the same function with wps windows per grid
// step. Same operands, same output: meta [NW*lanes, 5] = (u, v, three
// bond-table rows) per lane, h and m_spill [n, D], this layer's bond table
// [vocab, D], w1 [H, D], b1 [H], w2 [D, H], b2 [D], eps1 = 1 + eps (float32);
// out [n, D] in h's type. Per window row v, over its lanes u -> v in lane
// order:
//   acc = sum rnd(relu(h_u + ee))            ee: the lane's three table rows
//   act = rnd(acc + m_spill_v + (1+eps) h_v)
//   z   = rnd(relu(act . w1^T + b1))         [D] -> [H]
//   out = rnd(z . w2^T + b2), with a ReLU when final_relu (every layer but the last)
// Rounding points are the TPU kernel's: the message before the f32 sum, act,
// and z. A lane whose u lies outside [0, W) reads a zero source and one whose
// v does lands nowhere, as the TPU kernel's one-hot gather and scatter give.
//
// Layout (flowgnn_tpu_torch/models/base.py:as_batch, blocked="local_ell"):
// node windows of W rows, each owning `lanes` = k*B lanes, both endpoints
// window-local. The k blocks of a window are one run stably sorted by v, pad
// lanes (u = v = W) last, so each destination row's lanes are one contiguous
// run at any k.
//
// What bounds it on this card: per 128 rows the MLP is 4*128*D*H operations
// (10.2 M at D=100, H=200; 2.6 GFLOP a launch on a 257-window hep10k
// bucket) against ~1.7 lanes per row of D-wide gathers; device memory moves
// the lanes (20 B each), h, m_spill and out once, a few microseconds a
// launch, so the MLP bounds it: on the CUDA cores in f32 (0.04 ms a launch
// at 67 TFLOP/s), on the tensor cores in bf16 (2.6 µs at 989).
//
// Design: h lives in device memory between layers, so the kernel needs no
// cluster: one block of 256 threads (two warpgroups) per 128 rows of a
// window (grid NW*W/128, W a whole number of 128-row tiles up to 1024). Each
// block finds its rows' lane runs by binary search on v, then sums each
// row's lanes one warp per row in f32, with no atomics: deterministic. Each
// lane of the warp holds column pairs (2p, 2p+1), so a source row of h is
// read from device memory (L1 / L2) as bf16 (or float) pairs, and the bond
// table rows from shared memory as float pairs.
// - bf16: act is written as bf16 straight into wgmma's A layout [D'/8][128][8]
//   (28.7 KB at D = 100) and the update MLP is gin_mlp.cuh's, on the tensor
//   cores, this layer's weight chunks streamed through a ring of S buffers
//   (13.8 KB each at D = 100) whose first S loads are issued before the
//   messages. The wrapper takes the largest S ≤ C (the chunks, 7 at H = 200)
//   that keeps two blocks an SM (S = 5 at D = 100, H = 200: 101 KB), so a
//   257-block launch runs in one wave on 132 SMs; registers are capped at 128
//   a thread for the same reason.
// - f32: act stays f32 [128][D] and the MLP is register-tiled FMA (8 rows x 7
//   columns per thread), w1 and w2 staged through shared memory in chunks of
//   32 hidden units (TF32 would break the f32 gate of 1e-4): ~100 KB at D =
//   100, two blocks an SM.
// The shared-memory carve-up is computed on the host and passed in, as in
// gin_model.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gin_mlp.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kTR = 16;                // thread rows of the f32 MLP tile
constexpr int kTC = 16;                // thread columns of the f32 MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneP = (kMaxD / 2 + 31) / 32;  // column pairs per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

static_assert(kMaxD == gin_mlp::kMaxD && kRows == gin_mlp::kRows && kThreads == gin_mlp::kThreads,
              "the bf16 MLP's block shape");

struct Dims {
  int n, window, lanes, d, hid, vocab, final_relu, stages;
};

// Shared-memory carve-up of one block, byte offsets. wg: the bf16 form (act
// bf16 in the A layout, the weight ring); else act f32 and the FMA MLP's
// chunk tiles.
struct Smem {
  size_t act, tab, lo, hid, w1c, w2c, b1c, ring, bars, total;
};

inline Smem smem_layout(bool wg, int d, int hid, int vocab, int stages) {
  const size_t D = d;
  const gin_mlp::Geom gm = gin_mlp::geom(d, hid);
  Smem s;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  s.act = take(kRows * (wg ? size_t(gm.dp) * 2 : D * 4));
  s.tab = take(size_t(vocab) * D * 4);
  s.lo = take((kRows + 1) * 4);
  s.hid = take(wg ? 0 : kRows * kHC * 4);
  s.w1c = take(wg ? 0 : kHC * (D + 1) * 4);
  s.w2c = take(wg ? 0 : D * (kHC + 1) * 4);
  s.b1c = take(wg ? 0 : kHC * 4);
  s.ring = take(wg ? size_t(stages) * gm.chunk_bytes : 0);
  s.bars = take(wg ? size_t(stages) * 8 : 0);
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Columns c and c + 1 (c even) of a row of `D` values in device memory:
// one pair load when D is even (the row then starts 4 or 8 bytes aligned),
// else two loads; the second is 0 past the row.
__device__ __forceinline__ float2 ld_pair(const float* row, int c, int D) {
  if (!(D & 1)) return __ldg(reinterpret_cast<const float2*>(row + c));
  return make_float2(__ldg(row + c), c + 1 < D ? __ldg(row + c + 1) : 0.f);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* row, int c, int D) {
  if (!(D & 1)) return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row + c)));
  return make_float2(__bfloat162float(row[c]), c + 1 < D ? __bfloat162float(row[c + 1]) : 0.f);
}
// The same from the f32 bond table in shared memory.
__device__ __forceinline__ float2 tab_pair(const float* row, int c, int D) {
  if (!(D & 1)) return *reinterpret_cast<const float2*>(row + c);
  return make_float2(row[c], c + 1 < D ? row[c + 1] : 0.f);
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
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab, int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

// N2 = 0: the float32 form (FMA MLP); N2 = 104 or 112: the bf16 form with
// the wgmma MLP, N2 its second product's width. tiles: the bf16 form's
// packed weight chunks of this layer (gin_mlp.cuh). lay: the shared-memory
// carve-up, computed once on the host (smem_layout).
template <typename T, int N2>
__global__ void __launch_bounds__(kThreads, N2 > 0 ? 2 : 1)
gin_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ m_spill, const T* __restrict__ tab,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     const float* __restrict__ eps1, const unsigned char* __restrict__ tiles,
                     T* __restrict__ out, Dims dm, Smem lay) {
  constexpr bool kWg = N2 > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const gin_mlp::Geom gm = gin_mlp::geom(dm.d, dm.hid);
  // act: f32 [kRows][D], or bf16 [D'/8][kRows][8] (the wgmma A layout).
  float* act_f = reinterpret_cast<float*>(smem + lay.act);
  __nv_bfloat16* act_b = reinterpret_cast<__nv_bfloat16*>(smem + lay.act);
  float* tab_s = reinterpret_cast<float*>(smem + lay.tab);  // [vocab][D] this layer's bonds
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);        // [kRows+1] lane runs
  const gin_mlp::Ring ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars), tiles,
                           dm.stages, gm.chunks, gm.chunk_bytes};

  const int D = dm.d, tid = threadIdx.x;
  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  if constexpr (kWg) {
    if (tid == 0) ring.init();
    // act's pad columns stay zero; the messages write columns < D only.
    const int pad = gm.dp - D;
    for (int i = tid; i < kRows * pad; i += kThreads)
      act_b[gin_mlp::act_index(i / pad, D + i % pad)] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab + i);
  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index, by binary search over v.
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
  if constexpr (kWg) {
    if (tid == 0) ring.prefetch();  // the layer's first S weight chunks, behind the messages
  }

  // Messages, one warp per destination row; lane j of the warp holds the
  // column pairs p = j, j + 32, ... (columns 2p and 2p + 1) of the row.
  const float eps = __ldg(eps1);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float2 acc[kLaneP];
#pragma unroll
    for (int j = 0; j < kLaneP; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
      const int* m = meta_w + e * kMeta;
      const int u = __ldg(m);
      const T* hu = unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n
                        ? h + (wrow0 + u) * D : nullptr;
      const float* e1 = bond_row(tab_s, __ldg(m + 2), dm.vocab, D);
      const float* e2 = bond_row(tab_s, __ldg(m + 3), dm.vocab, D);
      const float* e3 = bond_row(tab_s, __ldg(m + 4), dm.vocab, D);
#pragma unroll
      for (int j = 0; j < kLaneP; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c >= D) break;
        float2 ee = make_float2(0.f, 0.f);
        if (e1) { const float2 t = tab_pair(e1, c, D); ee.x += t.x; ee.y += t.y; }
        if (e2) { const float2 t = tab_pair(e2, c, D); ee.x += t.x; ee.y += t.y; }
        if (e3) { const float2 t = tab_pair(e3, c, D); ee.x += t.x; ee.y += t.y; }
        const float2 hv = hu ? ld_pair(hu, c, D) : make_float2(0.f, 0.f);
        acc[j].x += rnd<T>(fmaxf(hv.x + ee.x, 0.f));
        acc[j].y += rnd<T>(fmaxf(hv.y + ee.y, 0.f));
      }
    }
    const long row = row0 + r;
    const bool real = row < dm.n;
#pragma unroll
    for (int j = 0; j < kLaneP; ++j) {
      const int c = 2 * (lane + 32 * j);
      if (c >= D) break;
      const float2 hv = real ? ld_pair(h + row * D, c, D) : make_float2(0.f, 0.f);
      const float2 sp = real && m_spill != nullptr ? ld_pair(m_spill + row * D, c, D)
                                                   : make_float2(0.f, 0.f);
      const float a0 = rnd<T>(__fadd_rn(__fadd_rn(acc[j].x, sp.x), __fmul_rn(eps, hv.x)));
      const float a1 = rnd<T>(__fadd_rn(__fadd_rn(acc[j].y, sp.y), __fmul_rn(eps, hv.y)));
      if constexpr (kWg) {
        // Columns c, c + 1 share a core-matrix row: one 4-byte store (a
        // pad column c + 1 = D, for an odd D, stores zero).
        *reinterpret_cast<__nv_bfloat162*>(act_b + gin_mlp::act_index(r, c)) =
            __floats2bfloat162_rn(a0, c + 1 < D ? a1 : 0.f);
      } else {
        act_f[r * D + c] = a0;
        if (c + 1 < D) act_f[r * D + c + 1] = a1;
      }
    }
  }

  if constexpr (kWg) {
    fence_proxy_async();  // act, written here, is read by wgmma
    __syncthreads();
    float o[N2 / 2];
    gin_mlp::run<N2>(o, act_b, ring, 0, gm, b1, b2, D, dm.hid, dm.final_relu != 0, tid);
    gin_mlp::for_each_out<N2>(o, D, tid, [&](int r, int c, float v) {
      if (row0 + r < dm.n) out[(row0 + r) * D + c] = cvt<T>(v);
    });
  } else {
    // MLP over the block's rows: out = relu(act.w1^T + b1).w2^T + b2 (->
    // relu), in chunks of kHC hidden units. Each thread owns kRowsPT x
    // kColsPT outputs in registers across all chunks.
    float* hid_s = reinterpret_cast<float*>(smem + lay.hid);  // [kRows][kHC] a chunk of z
    float* w1c = reinterpret_cast<float*>(smem + lay.w1c);    // [kHC][D+1]
    float* w2c = reinterpret_cast<float*>(smem + lay.w2c);    // [D][kHC+1]
    float* b1c = reinterpret_cast<float*>(smem + lay.b1c);    // [kHC]
    const int tr = tid / kTC, tc = tid % kTC;
    float o[kRowsPT][kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
    for (int j0 = 0; j0 < dm.hid; j0 += kHC) {
      __syncthreads();  // act is written; the previous chunk's readers are done
      for (int i = tid; i < kHC * D; i += kThreads) {
        const int j = i / D, k = i - j * D;
        w1c[j * (D + 1) + k] = j0 + j < dm.hid ? ld(w1 + long(j0 + j) * D + k) : 0.f;
      }
      for (int i = tid; i < D * kHC; i += kThreads) {
        const int c = i / kHC, j = i - c * kHC;
        w2c[c * (kHC + 1) + j] = j0 + j < dm.hid ? ld(w2 + long(c) * dm.hid + j0 + j) : 0.f;
      }
      for (int j = tid; j < kHC; j += kThreads) b1c[j] = j0 + j < dm.hid ? ld(b1 + j0 + j) : 0.f;
      __syncthreads();

      float z[kRowsPT][kHcPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int m = 0; m < kHcPT; ++m) z[i][m] = 0.f;
      for (int k = 0; k < D; ++k) {
        float a[kRowsPT], wv[kHcPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) a[i] = act_f[(tr + kTR * i) * D + k];
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
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      const long row = row0 + tr + kTR * i;
      if (row >= dm.n) continue;
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = tc + kTC * m;
        if (c >= D) continue;
        float v = o[i][m] + ld(b2 + c);
        if (dm.final_relu) v = fmaxf(v, 0.f);
        out[row * D + c] = cvt<T>(v);
      }
    }
  }
}

template <typename T, int N2>
cudaError_t launch(const void* meta, const void* h, const void* m_spill, const void* tab,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* eps1, const void* tiles, void* out, int num_windows,
                   const Dims& dm, cudaStream_t stream) {
  const Smem lay = smem_layout(N2 > 0, dm.d, dm.hid, dm.vocab, dm.stages);
  const size_t bytes = lay.total;
  cudaError_t err = cudaFuncSetAttribute(
      gin_layer_ell_kernel<T, N2>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gin_layer_ell_kernel<T, N2><<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h),
      static_cast<const T*>(m_spill), static_cast<const T*>(tab),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps1), static_cast<const unsigned char*>(tiles),
      static_cast<T*>(out), dm, lay);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gin_layer_ell_max_d() { return kMaxD; }
int gin_layer_ell_rows_per_block() { return kRows; }
int gin_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The bf16 form's weight chunks, as gin_ell_mlp_dims gives them.
void gin_layer_ell_mlp_dims(int d, int hid, int* dims) { gin_mlp::dims(d, hid, dims); }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_layer_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Shared memory (bytes) of one SM, or a negative cudaError_t.
long long gin_layer_ell_smem_per_sm(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs; dtype as in
// gin_layer_ell_launch, stages the bf16 form's weight ring.
long long gin_layer_ell_smem_bytes(int dtype, int d, int hid, int vocab, int stages) {
  return (long long)smem_layout(dtype == 1, d, hid, vocab, stages).total;
}

// dtype: 0 = float32, 1 = bfloat16 (h, m_spill, tab, w1, b1, w2, b2, out).
// meta [num_windows*lanes, 5]: int32; eps1: float32 [1]; m_spill may be null
// (no spill messages); out [n, d]. bfloat16 also takes `tiles`, this layer's
// C weight chunks packed as gin_layer_ell_mlp_dims gives them, and a ring of
// `stages` chunk buffers, at least gin_mlp::min_stages (float32: null and 0).
// window must be 1..kMaxWindowBlocks whole blocks of kRows rows. Returns a
// cudaError_t.
int gin_layer_ell_launch(int dtype, const void* meta, const void* h, const void* m_spill,
                         const void* tab, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* eps1, const void* tiles, void* out,
                         int num_windows, int n, int window, int lanes, int d, int hid,
                         int vocab, int final_relu, int stages, int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      d < 1 || d > kMaxD || hid < 1 || num_windows < 1 || lanes < 0 || vocab < 0 ||
      (dtype == 1 && (tiles == nullptr || stages < gin_mlp::min_stages(d, hid))))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, d, hid, vocab, final_relu, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float, 0>(meta, h, m_spill, tab, w1, b1, w2, b2, eps1, nullptr, out,
                           num_windows, dm, s);
  else if (dtype == 1 && gin_mlp::geom(d, hid).n2 == 104)
    err = launch<__nv_bfloat16, 104>(meta, h, m_spill, tab, w1, b1, w2, b2, eps1, tiles, out,
                                     num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, 112>(meta, h, m_spill, tab, w1, b1, w2, b2, eps1, tiles, out,
                                     num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gin_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
