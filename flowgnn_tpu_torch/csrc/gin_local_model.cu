// GIN / GIN-VN whole-model ELL kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gin_local_model (with its helpers _ell_meta and _pool_epilogue). Same
// function, same output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GIN layers plus the finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch with
// blocked="local_ell", k = 1): node windows of W rows in packed order, each
// owning `block` lanes of `meta` = (u, v, three bond-table rows) per lane,
// both endpoints window-local. Within a window the lanes are sorted by v
// (a stable sort by receiver), so each destination row's lanes are one
// contiguous run; pad lanes carry u = v = W and come last. pool_gl holds
// each row's window-local graph id, GMAX for padding rows.
//
// What bounds it on this card: per 128 rows and layer the update MLP costs
// 2*128*D*H multiply-adds (5.1 M at D=100, H=200) against ~1.5 lanes per
// row of D-wide gathers for the messages; h is read once and GMAX*T floats
// are written per window, so device-memory traffic is small and the kernel
// is bound on chip (arithmetic, shared-memory traffic, latency). What
// bounds the design is shared memory: a window of W = 512 rows holds 204.8
// KB of f32 h and as much again of f32 act, past the 227 KB a block may
// use. So a window runs on a thread-block cluster of W/128 blocks (1 to 8,
// the portable cluster size), each owning 128 rows: their h, act, the MLP's
// working tiles and the VN partials, ~161 KB at D=100, the footprint of the
// one-block W=128 slot kernel. A source row in another block's rows is
// read from that block's shared memory (distributed shared memory,
// cluster.map_shared_rank). Each block finds its rows' lane runs by binary
// search on v and sums each row's lanes in lane order, one warp per row and
// the lanes over D, with no atomics. Per layer the cluster synchronises
// after the layer's h is in place (before any block gathers from it) and
// after the messages (before any block overwrites its h); GIN-VN adds one
// barrier after its per-graph partials. A graph may span blocks (a 400-node
// graph covers four), so the analytic-VN pool and the readout pool are
// per-block partials over the block's rows, reduced across the cluster in
// rank order through distributed shared memory: deterministic, and summed
// in another order than the plain version (one running sum over the
// window's rows), which the f32 comparisons allow for at 1e-4 of the
// output's scale. The MLP runs as register-tiled FMA over 32-unit chunks of
// the hidden layer; wgmma and TMA are later work.
//
// Numerics follow the TPU kernel: activations and weights are float or
// bfloat16 (T); every product and sum is float32; messages, act, the hidden
// layer and the new h are rounded to T where the TPU kernel casts to its
// compute dtype; the VN pool stays float32. A lane whose u lies outside the
// window reads a zero source and one whose v does lands nowhere, as the
// TPU kernel's one-hot gather and scatter give.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the MLP tile
constexpr int kTC = 16;                // thread columns of the MLP tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kHC = 32;                // hidden units per chunk
constexpr int kHcPT = kHC / kTC;       // hidden units per thread per chunk
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows
// Bond vocabulary rows of the (0, 0, 0) attr that every analytic VN star
// edge carries: the feature offsets {0, 5, 11}.
constexpr int kE0Row0 = 0, kE0Row1 = 5, kE0Row2 = 11;

struct Dims {
  int n, window, block, d, hid, layers, vocab, gmax, tout;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t h, act, scratch, part, tab, gl, vn, rows, gstart, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d, int vocab, int gmax, int tout) {
  const size_t D = d;
  const size_t mlp = kRows * kHC + kHC * (D + 1) + D * (kHC + 1) + kHC;
  const size_t vn_part = size_t(gmax) * 2 * D;
  size_t scratch = mlp > vn_part ? mlp : vn_part;
  if (size_t(kRows) * tout > scratch) scratch = size_t(kRows) * tout;  // head outputs
  if (size_t(gmax) > scratch) scratch = gmax;                          // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += kRows * D;
  s.act = o; o += kRows * D;
  s.scratch = o; o += scratch;
  s.part = o; o += size_t(gmax) * tout;
  s.tab = o; o += size_t(vocab) * D;
  s.gl = o; o += kRows;
  s.vn = o; o += kRows;
  s.rows = o; o += kRows;
  s.gstart = o; o += gmax + 1;
  s.lo = o; o += kRows + 1;
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

// The bond-table row `a` in shared memory, or null outside the vocabulary.
__device__ __forceinline__ const float* bond_row(const float* tab_s, int a, int vocab,
                                                 int d) {
  return unsigned(a) < unsigned(vocab) ? tab_s + a * d : nullptr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gin_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h0,
               const int* __restrict__ pool_gl, const T* __restrict__ tab,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2,
               const float* __restrict__ eps, const T* __restrict__ predw,
               const T* __restrict__ vn_col, float* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const Smem lay = smem_layout(dm.d, dm.vocab, dm.gmax, dm.tout);
  float* h_s = smem + lay.h;        // [kRows][D] this block's rows of h
  float* act_s = smem + lay.act;    // [kRows][D] (1+eps)·h + messages
  float* scr = smem + lay.scratch;  // VN partials, MLP chunks or head outputs
  float* part_s = smem + lay.part;  // [gmax][T] readout partials
  float* tab_s = smem + lay.tab;    // [vocab][D] this layer's bond table
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  float* vn_s = smem + lay.vn;                                // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] lane runs

  const int D = dm.d, tid = threadIdx.x;
  const bool has_vn = vn_col != nullptr;
  const long row0 = long(win) * dm.window + long(rank) * kRows;
  const int* meta_w = meta + long(win) * dm.block * kMeta;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    vn_s[r] = has_vn && row0 + r < dm.n ? ld(vn_col + row0 + r) : 0.f;
  }
  // Row r's lanes are [lo_s[r], lo_s[r+1]): the first lane whose v is at
  // least the row's window-local index, by binary search over v.
  for (int r = tid; r <= kRows; r += kThreads) {
    const int key = rank * kRows + r;
    int lo = 0, hi = dm.block;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(meta_w + mid * kMeta + 1) < key) lo = mid + 1; else hi = mid;
    }
    lo_s[r] = lo;
  }
  __syncthreads();
  if (tid == 0) {
    // Group the block's rows by graph (ascending row order within a graph):
    // the pools then sum each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(scr);
    for (int g = 0; g <= dm.gmax; ++g) gstart_s[g] = 0;
    for (int r = 0; r < kRows; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) ++gstart_s[gl_s[r] + 1];
    for (int g = 0; g < dm.gmax; ++g) {
      gstart_s[g + 1] += gstart_s[g];
      cursor[g] = gstart_s[g];
    }
    for (int r = 0; r < kRows; ++r)
      if (unsigned(gl_s[r]) < unsigned(dm.gmax)) rows_s[cursor[gl_s[r]]++] = r;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int tr = tid / kTC, tc = tid % kTC;
  for (int l = 0; l < dm.layers; ++l) {
    // Every block's h is in place, and no block still reads the previous
    // layer's VN partials.
    cluster.sync();
    const T* tab_l = tab + long(l) * dm.vocab * D;
    for (int i = tid; i < dm.vocab * D; i += kThreads) tab_s[i] = ld(tab_l + i);
    __syncthreads();

    // Analytic virtual node: this block's part of each graph's pooled star
    // messages into the VN (real rows' relu(h + e0)) and out of it (the VN
    // row's), e0 being the (0, 0, 0)-attr bond embedding.
    float* vnp = scr;  // [gmax][2D]: real-row sums ‖ VN-row sums
    if (has_vn) {
      for (int i = tid; i < dm.gmax * D; i += kThreads) {
        const int g = i / D, c = i - g * D;
        const float e0 = tab_s[kE0Row0 * D + c] + tab_s[kE0Row1 * D + c] +
                         tab_s[kE0Row2 * D + c];
        float s_real = 0.f, s_vn = 0.f;
        for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) {
          const int r = rows_s[j];
          const float v = rnd<T>(fmaxf(h_s[r * D + c] + e0, 0.f));
          if (vn_s[r] != 0.f) s_vn += v; else s_real += v;
        }
        vnp[g * 2 * D + c] = s_real;
        vnp[g * 2 * D + D + c] = s_vn;
      }
      cluster.sync();  // every block's partials are written
    }

    // Messages, one warp per destination row; lane j of the warp holds
    // columns j, j + 32, ... of the row.
    const float eps_l = eps[l];
    for (int r = warp; r < kRows; r += kWarps) {
      float acc[kLaneD];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
      for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
        const int* m = meta_w + e * kMeta;
        const int u = __ldg(m);
        const float* hu = nullptr;
        if (unsigned(u) < unsigned(dm.window)) {
          const int owner = u / kRows;
          const float* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
          hu = base + (u - owner * kRows) * D;
        }
        const float* e1 = bond_row(tab_s, __ldg(m + 2), dm.vocab, D);
        const float* e2 = bond_row(tab_s, __ldg(m + 3), dm.vocab, D);
        const float* e3 = bond_row(tab_s, __ldg(m + 4), dm.vocab, D);
#pragma unroll
        for (int j = 0; j < kLaneD; ++j) {
          const int c = lane + 32 * j;
          if (c >= D) break;
          float ee = 0.f;
          if (e1) ee += e1[c];
          if (e2) ee += e2[c];
          if (e3) ee += e3[c];
          acc[j] += rnd<T>(fmaxf((hu ? hu[c] : 0.f) + ee, 0.f));
        }
      }
      const int g = gl_s[r];
      const bool vn_in = has_vn && unsigned(g) < unsigned(dm.gmax);
      const int vn_off = g * 2 * D + (vn_s[r] != 0.f ? 0 : D);
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        float a = acc[j];
        if (vn_in) {  // the VN row takes the real rows' pool, a real row the VN's
          float s = 0.f;
          for (int k = 0; k < csize; ++k) s += cluster.map_shared_rank(vnp, k)[vn_off + c];
          a += s;
        }
        act_s[r * D + c] = rnd<T>(__fadd_rn(a, __fmul_rn(eps_l, h_s[r * D + c])));
      }
    }
    // No block reads this block's h or VN partials any more.
    cluster.sync();

    // Update MLP over the block's rows: h = act·w1ᵀ + b1 → relu → ·w2ᵀ + b2
    // (→ relu), in chunks of kHC hidden units. Each thread owns kRowsPT ×
    // kColsPT outputs in registers across all chunks.
    float* hid_s = scr;                    // [kRows][kHC]
    float* w1c = hid_s + kRows * kHC;      // [kHC][D+1]
    float* w2c = w1c + kHC * (D + 1);      // [D][kHC+1]
    float* b1c = w2c + D * (kHC + 1);      // [kHC]
    const T* w1_l = w1 + long(l) * dm.hid * D;
    const T* w2_l = w2 + long(l) * D * dm.hid;
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
        for (int i = 0; i < kRowsPT; ++i) a[i] = act_s[(tr + kTR * i) * D + k];
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
        const int r = tr + kTR * i, c = tc + kTC * m;
        if (c < D) {
          float v = o[i][m] + ld(b2 + long(l) * D + c);
          if (l != dm.layers - 1) v = fmaxf(v, 0.f);
          h_s[r * D + c] = rnd<T>(v);
        }
      }
  }
  __syncthreads();

  // Finalize: per-row head p = h·pred_w, this block's per-graph sums of p,
  // then the cluster's sums, each block writing a share of the outputs.
  float* p_s = scr;  // [kRows][T]
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(h_s[r * D + d], ld(predw + d * dm.tout + t), s);
    p_s[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < dm.gmax * dm.tout; i += kThreads) {
    const int g = i / dm.tout, t = i - g * dm.tout;
    float s = 0.f;
    for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) s += p_s[rows_s[j] * dm.tout + t];
    part_s[i] = s;
  }
  cluster.sync();
  float* out_w = out + long(win) * dm.gmax * dm.tout;
  for (int i = rank * kThreads + tid; i < dm.gmax * dm.tout; i += csize * kThreads) {
    float s = 0.f;
    for (int k = 0; k < csize; ++k) s += cluster.map_shared_rank(part_s, k)[i];
    out_w[i] = s;
  }
  cluster.sync();  // keep this block's shared memory until the cluster has read it
}

template <typename T>
cudaError_t launch(const void* meta, const void* h0, const void* pool_gl,
                   const void* tab, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* eps,
                   const void* predw, const void* vn_col, void* out,
                   int num_windows, const Dims& dm, cudaStream_t stream) {
  const int csize = dm.window / kRows;
  const size_t bytes = smem_layout(dm.d, dm.vocab, dm.gmax, dm.tout).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gin_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_windows * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, gin_ell_kernel<T>, static_cast<const int*>(meta), static_cast<const T*>(h0),
      static_cast<const int*>(pool_gl), static_cast<const T*>(tab),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(eps), static_cast<const T*>(predw),
      static_cast<const T*>(vn_col), static_cast<float*>(out), dm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gin_ell_max_d() { return kMaxD; }
int gin_ell_rows_per_block() { return kRows; }
int gin_ell_max_cluster() { return kMaxCluster; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gin_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block of the cluster needs.
long long gin_ell_smem_bytes(int d, int vocab, int gmax, int tout) {
  return (long long)(smem_layout(d, vocab, gmax, tout).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, tables, weights, biases, pred_w,
// vn_col). meta [num_windows*block, 5], pool_gl: int32; eps: float32 [L];
// out: float32 [num_windows*gmax, tout]. vn_col may be null. window must be
// 1..kMaxCluster whole blocks of kRows rows. Returns a cudaError_t.
int gin_ell_launch(int dtype, const void* meta, const void* h0,
                   const void* pool_gl, const void* tab, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* eps, const void* predw, const void* vn_col,
                   void* out, int num_windows, int n, int window, int block,
                   int d, int hid, int layers, int vocab, int gmax, int tout,
                   int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxCluster ||
      d < 1 || d > kMaxD || num_windows < 1 || block < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, block, d, hid, layers, vocab, gmax, tout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps, predw,
                        vn_col, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h0, pool_gl, tab, w1, b1, w2, b2, eps,
                                predw, vn_col, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gin_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
