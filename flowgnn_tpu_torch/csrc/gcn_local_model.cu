// GCN whole-model ELL kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gcn_local_model (with its helpers _ell_meta and _pool_epilogue). Same
// function, same output: [NW*GMAX, T] float32 per-window pool sums of the
// prediction head, for all L GCN layers after the conv-0 matmul plus the
// finalize, in one launch.
//
// Layout (built by flowgnn_tpu_torch/models/base.py:as_batch with
// blocked="local_ell", k = 1): node windows of W rows in packed order, each
// owning `block` lanes of `meta` = (u, v, three bond-table rows) per lane,
// both endpoints window-local, sorted by v within the window (pad lanes,
// u = v = W, last). pool_gl holds each row's window-local graph id, GMAX for
// padding rows.
//
// Per layer l, for window row v and its lanes u -> v:
//   msg = rnd(dis_u * relu(h_u + ee_l))        ee_l: three bond-table rows
//   acc = sum of msg over v's lanes, in lane order
//   a   = acc * dis_v + relu(h_v + root_l) * dis_v^2
//   x   = alpha_l * a + beta_l                 (BatchNorm folded on the host)
// then h = rnd(rnd(relu(x)) . wn_l + bn_l) between layers, and after the last
// layer the head pools rnd(x) . pred_w (no relu; _pool_epilogue).
//
// What bounds it on this card: per 128 rows and layer the next-conv matmul
// is 128*D*D multiply-adds (1.28 M at D=100) against ~1.5 lanes per row of
// D-wide gathers; device-memory traffic is small, so the kernel is bound on
// chip (arithmetic, shared-memory traffic, latency). What bounds the design
// is shared memory: at W = 512 a window's f32 h and next-conv input take
// 409.6 KB, past the 227 KB of one block. A window therefore runs on a
// thread-block cluster of W/128 blocks (1 to 8), each owning 128 rows (h,
// the conv input, one layer's f32 weights: ~151 KB at D=100). A source in
// another block's rows is read from that block's shared memory
// (cluster.map_shared_rank); dis_u, layer-invariant, is read from device
// memory (L1 / L2). Each block finds its rows' lane runs by binary search on
// v and sums each row's lanes in lane order, one warp per row and the lanes
// over D, with no atomics. The cluster synchronises per layer after the
// layer's h is in place and again after the messages, before any block
// overwrites its h. The readout pool of a graph that spans blocks is a
// per-block partial reduced across the cluster in rank order through
// distributed shared memory: deterministic, and summed in another order than
// the plain version, which the f32 comparisons allow for at 1e-4 of the
// output's scale. The conv runs as register-tiled FMA; wgmma and TMA are
// later work.
//
// Numerics follow the TPU kernel: activations, norms and weights are float
// or bfloat16 (T); every product and sum is float32; messages, the next
// conv's input, the new h and the head's input are rounded to T where the
// TPU kernel casts to its compute dtype. A lane whose u lies outside the
// window has dis_u = 0 (no message) and one whose v does lands nowhere.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block of the cluster
constexpr int kMaxCluster = 8;         // portable cluster size: W up to 1024
constexpr int kTR = 16;                // thread rows of the conv tile
constexpr int kTC = 16;                // thread columns of the conv tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = 7;             // output columns per thread
constexpr int kMaxD = kTC * kColsPT;   // widest D the tile covers (112)
constexpr int kLaneD = (kMaxD + 31) / 32;  // D columns per lane in the messages
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows

struct Dims {
  int n, window, block, d, layers, vocab, gmax, tout;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t h, x, w, part, tab, vec, dis, gl, rows, gstart, lo, total;
};

__host__ __device__ inline Smem smem_layout(int d, int vocab, int gmax, int tout) {
  const size_t D = d;
  size_t wbuf = D * D;                                            // next-conv weights
  if (size_t(kRows) * tout > wbuf) wbuf = size_t(kRows) * tout;  // head outputs
  if (size_t(gmax) > wbuf) wbuf = gmax;                           // CSR cursor
  Smem s;
  size_t o = 0;
  s.h = o; o += kRows * D;
  s.x = o; o += kRows * D;
  s.w = o; o += wbuf;
  s.part = o; o += size_t(gmax) * tout;
  s.tab = o; o += size_t(vocab) * D;
  s.vec = o; o += 3 * D;
  s.dis = o; o += kRows;
  s.gl = o; o += kRows;
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
gcn_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h0,
               const T* __restrict__ dis, const int* __restrict__ pool_gl,
               const T* __restrict__ tab, const T* __restrict__ roots,
               const T* __restrict__ alphas, const T* __restrict__ betas,
               const T* __restrict__ wn, const T* __restrict__ bn,
               const T* __restrict__ predw, float* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int win = blockIdx.x / csize;
  const Smem lay = smem_layout(dm.d, dm.vocab, dm.gmax, dm.tout);
  const int D = dm.d, tid = threadIdx.x;
  float* h_s = smem + lay.h;        // [kRows][D] this block's rows of h
  float* x_s = smem + lay.x;        // [kRows][D] rnd(relu(x)), or rnd(x) after the last layer
  float* w_s = smem + lay.w;        // [D][D] wn_l as [in][out]; head outputs; CSR cursor
  float* part_s = smem + lay.part;  // [gmax][T] readout partials
  float* tab_s = smem + lay.tab;    // [vocab][D] this layer's bond table
  float* root_s = smem + lay.vec;   // [D] root_l, then alpha_l and beta_l
  float* alpha_s = root_s + D;
  float* beta_s = alpha_s + D;
  float* dis_s = smem + lay.dis;                              // [kRows]
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);          // [kRows]
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);      // [kRows] rows by graph
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);  // [gmax+1]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);          // [kRows+1] lane runs

  const long wrow0 = long(win) * dm.window;  // the window's first row
  const long row0 = wrow0 + long(rank) * kRows;
  const int* meta_w = meta + long(win) * dm.block * kMeta;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    h_s[i] = row0 + r < dm.n ? ld(h0 + (row0 + r) * D + (i - r * D)) : 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    gl_s[r] = pool_gl[row0 + r];
    dis_s[r] = row0 + r < dm.n ? ld(dis + row0 + r) : 0.f;
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
    // the readout then sums each graph's rows in a fixed order.
    int* cursor = reinterpret_cast<int*>(w_s);
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
    const bool last = l == dm.layers - 1;
    // Every block's h is in place before any block gathers from it.
    cluster.sync();
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

    // Messages, one warp per destination row; lane j of the warp holds
    // columns j, j + 32, ... of the row.
    for (int r = warp; r < kRows; r += kWarps) {
      float acc[kLaneD];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) acc[j] = 0.f;
      for (int e = lo_s[r]; e < lo_s[r + 1]; ++e) {
        const int* m = meta_w + e * kMeta;
        const int u = __ldg(m);
        if (unsigned(u) >= unsigned(dm.window)) continue;  // dis_u = 0: no message
        const float dis_u = wrow0 + u < dm.n ? ld(dis + wrow0 + u) : 0.f;
        const int owner = u / kRows;
        const float* base = owner == rank ? h_s : cluster.map_shared_rank(h_s, owner);
        const float* hu = base + (u - owner * kRows) * D;
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
          acc[j] += rnd<T>(__fmul_rn(dis_u, fmaxf(hu[c] + ee, 0.f)));
        }
      }
      const float dv = dis_s[r];
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        if (c >= D) break;
        const float root = fmaxf(h_s[r * D + c] + root_s[c], 0.f);
        const float a = __fadd_rn(__fmul_rn(acc[j], dv), __fmul_rn(root, __fmul_rn(dv, dv)));
        const float x = __fadd_rn(__fmul_rn(alpha_s[c], a), beta_s[c]);
        x_s[r * D + c] = last ? rnd<T>(x) : rnd<T>(fmaxf(x, 0.f));
      }
    }
    if (last) break;
    // No block reads this block's h any more.
    cluster.sync();

    // Next conv over the block's rows: h = rnd(x_s . wn_l + bn_l). Each
    // thread owns kRowsPT x kColsPT outputs in registers.
    const T* bn_l = bn + long(l) * D;
    float o[kRowsPT][kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) o[i][m] = 0.f;
    for (int k = 0; k < D; ++k) {
      float a[kRowsPT], wv[kColsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) a[i] = x_s[(tr + kTR * i) * D + k];
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
        const int r = tr + kTR * i, c = tc + kTC * m;
        if (c < D) h_s[r * D + c] = rnd<T>(o[i][m] + ld(bn_l + c));
      }
  }
  __syncthreads();

  // Finalize: per-row head p = rnd(x) . pred_w, this block's per-graph sums
  // of p, then the cluster's sums, each block writing a share of the outputs.
  float* p_s = w_s;  // [kRows][T]
  for (int i = tid; i < kRows * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(x_s[r * D + d], ld(predw + d * dm.tout + t), s);
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
cudaError_t launch(const void* meta, const void* h0, const void* dis,
                   const void* pool_gl, const void* tab, const void* roots,
                   const void* alphas, const void* betas, const void* wn,
                   const void* bn, const void* predw, void* out,
                   int num_windows, const Dims& dm, cudaStream_t stream) {
  const int csize = dm.window / kRows;
  const size_t bytes = smem_layout(dm.d, dm.vocab, dm.gmax, dm.tout).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
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
      &cfg, gcn_ell_kernel<T>, static_cast<const int*>(meta), static_cast<const T*>(h0),
      static_cast<const T*>(dis), static_cast<const int*>(pool_gl),
      static_cast<const T*>(tab), static_cast<const T*>(roots),
      static_cast<const T*>(alphas), static_cast<const T*>(betas),
      static_cast<const T*>(wn), static_cast<const T*>(bn),
      static_cast<const T*>(predw), static_cast<float*>(out), dm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gcn_ell_max_d() { return kMaxD; }
int gcn_ell_rows_per_block() { return kRows; }
int gcn_ell_max_cluster() { return kMaxCluster; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gcn_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block of the cluster needs.
long long gcn_ell_smem_bytes(int d, int vocab, int gmax, int tout) {
  return (long long)(smem_layout(d, vocab, gmax, tout).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h0, dis, tables, roots, alphas, betas,
// wn, bn, pred_w). meta [num_windows*block, 5], pool_gl: int32; out:
// float32 [num_windows*gmax, tout]. window must be 1..kMaxCluster whole
// blocks of kRows rows. Returns a cudaError_t.
int gcn_ell_launch(int dtype, const void* meta, const void* h0,
                   const void* dis, const void* pool_gl, const void* tab,
                   const void* roots, const void* alphas, const void* betas,
                   const void* wn, const void* bn, const void* predw,
                   void* out, int num_windows, int n, int window, int block,
                   int d, int layers, int vocab, int gmax, int tout,
                   int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxCluster ||
      d < 1 || d > kMaxD || num_windows < 1 || layers < 1 || block < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, block, d, layers, vocab, gmax, tout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h0, dis, pool_gl, tab, roots, alphas, betas, wn,
                        bn, predw, out, num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h0, dis, pool_gl, tab, roots, alphas,
                                betas, wn, bn, predw, out, num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gcn_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
