// One whole non-final GAT layer over the ELL layout for Hopper (sm_90a).
//
// Replaces the TPU kernel flowgnn_tpu/ops/pallas/local_layer.py:
// gat_local_layer_ell. Same operands, same output: meta [NW*lanes, 5] = (u,
// v, three bond rows; the bond rows unused) per lane, h [n, H*D] head-major,
// s_src and s_tgt [n, H], prev [n, H*D] the previous layer's features,
// spill_both [n, H*D + H] the spill tail's pre-reduced sums (may be null),
// w_skip and w_proj [H*D, H*D] as [out, in], a_mat [H*D, 2H] the next layer's
// block-diagonal score map; out [n, 2*H*D + 2H] = (h_next | feat | s_src' |
// s_tgt') in h's type. Per window row v, head k and lane u -> v, in lane
// order, as csrc/gat_local_message_ell.cu:
//   score = exp(leaky_0.2(s_src[v][k] + s_tgt[u][k]))       (raw exp, no max)
//   acc[v][k*D:(k+1)*D] += rnd(score * h_u[...]),  acc[v][H*D+k] += rnd(score)
// then, all in f32 with no rounding in between (the TPU kernel's epilogue):
//   tot  = acc + spill_both;  den = tot[H*D + k], 0 -> 1
//   x    = tot[:H*D] / den + prev . w_skip^T
//   feat = x > 0 ? x : exp(min(x, 0)) - 1                   (ELU)
//   h_next = feat . w_proj^T;  scores = h_next . a_mat
// and the output is rounded once. s_tgt comes in h's type (the TPU kernel
// rounds it: it rides h's gather tile); each lane's [score * h_u | score] is
// rounded before the sum, as the TPU kernel casts it for its scatter matmul.
//
// A lane whose v lies outside the window (a sentinel lane) is skipped, not
// multiplied by a mask: the TPU kernel computes exp(raw) * valid on every
// lane, which is 0 * inf = NaN once raw passes f32 exp's overflow (88.7).
// Here a sentinel lane adds nothing, whatever its score.
//
// Design: the message phase of csrc/gat_local_message_ell.cu (one block of
// 256 threads per 128 rows of a window, each row's run of lanes by binary
// search on v, one warp per row, per-head scores shared by warp shuffle),
// its sums kept in shared memory instead of written out; then the epilogue on
// the block's own rows: both weight matrices (64 x 64 at the reference width)
// and the score map sit in shared memory beside the rows' sums and prev, the
// two products are register-tiled FMA (8 rows x 4 columns per thread), feat
// overwrites the sums in place and h_next overwrites prev. ~103 KB of shared
// memory at H*D = 64, so two blocks fit an SM.
//
// What bounds it on this card: the bytes at the reference width. Per row it
// reads h, prev, spill_both and the scores once and writes 2*H*D + 2H values;
// per lane 20 B of meta and an H*D-wide source row (mostly from L2); the
// epilogue is 4*H*D*H*D + 4*H*D*H multiply-adds per row on the CUDA cores,
// which at H*D = 64 is under the time of the memory traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // window rows per block
constexpr int kMaxWindowBlocks = 8;    // W up to 1024
constexpr int kMaxHD = 64;             // widest H*D: kLaneD columns per lane
constexpr int kLaneD = kMaxHD / 32;
constexpr int kMaxHeads = 32;          // one head's score per lane
constexpr int kMeta = 5;               // ints per lane: u, v, three bond rows
constexpr int kTR = 16;                // thread rows of the epilogue tile
constexpr int kTC = 16;                // thread columns of the epilogue tile
constexpr int kRowsPT = kRows / kTR;   // rows per thread (8)
constexpr int kColsPT = kMaxHD / kTC;  // columns per thread (4)

struct Dims {
  int n, window, lanes, hd, heads;
};

// Shared-memory carve-up of one block, in 4-byte words.
struct Smem {
  size_t tot, prev, wsk, wpj, amat, lo, total;
};

__host__ __device__ inline Smem smem_layout(int hd, int heads) {
  const size_t HD = hd, H = heads;
  Smem s;
  size_t o = 0;
  s.tot = o; o += kRows * (HD + H);
  s.prev = o; o += kRows * HD;
  s.wsk = o; o += HD * (HD + 1);
  s.wpj = o; o += HD * (HD + 1);
  s.amat = o; o += HD * 2 * H;
  s.lo = o; o += kRows + 1;
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

__device__ __forceinline__ float leaky_exp(float raw) {
  return expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
}

// acc[i][m] = sum_k x_s[(tr + kTR*i) * ldx + k] * w_s[(tc + kTC*m) * (K+1) + k]
__device__ __forceinline__ void tile_product(const float* x_s, int ldx, const float* w_s, int K,
                                             int tr, int tc, float (&acc)[kRowsPT][kColsPT]) {
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) acc[i][m] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[kRowsPT], wv[kColsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) a[i] = x_s[(tr + kTR * i) * ldx + k];
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      wv[m] = c < K ? w_s[c * (K + 1) + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) acc[i][m] = fmaf(a[i], wv[m], acc[i][m]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_layer_ell_kernel(const int* __restrict__ meta, const T* __restrict__ h,
                     const T* __restrict__ s_src, const T* __restrict__ s_tgt,
                     const T* __restrict__ prev, const T* __restrict__ spill,
                     const T* __restrict__ w_skip, const T* __restrict__ w_proj,
                     const T* __restrict__ a_mat, T* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int per_win = dm.window / kRows;
  const int win = blockIdx.x / per_win, part = blockIdx.x % per_win;
  const int HD = dm.hd, H = dm.heads, dh = dm.hd / dm.heads, tid = threadIdx.x;
  const int TW = HD + H;  // a row of sums: [num | den]
  const Smem lay = smem_layout(HD, H);
  float* tot_s = smem + lay.tot;    // [kRows][HD+H] sums, then feat in [:HD]
  float* prev_s = smem + lay.prev;  // [kRows][HD] prev, then h_next
  float* wsk_s = smem + lay.wsk;    // [HD][HD+1] w_skip as [out][in]
  float* wpj_s = smem + lay.wpj;    // [HD][HD+1] w_proj as [out][in]
  float* amat_s = smem + lay.amat;  // [HD][2H]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);  // [kRows+1] lane runs
  const long wrow0 = long(win) * dm.window;
  const long row0 = wrow0 + long(part) * kRows;
  const int* meta_w = meta + long(win) * dm.lanes * kMeta;

  for (int i = tid; i < HD * HD; i += kThreads) {
    const int c = i / HD, k = i - c * HD;
    wsk_s[c * (HD + 1) + k] = ld(w_skip + i);
    wpj_s[c * (HD + 1) + k] = ld(w_proj + i);
  }
  for (int i = tid; i < HD * 2 * H; i += kThreads) amat_s[i] = ld(a_mat + i);
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const long row = row0 + i / HD;
    prev_s[i] = row < dm.n ? ld(prev + row * HD + (i % HD)) : 0.f;
  }
  // The first lane whose v is at least the row's window-local index, by
  // binary search over v.
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

  // The sums, one warp per destination row.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const long row = row0 + r;
    const bool real = row < dm.n;
    const float ss = real && lane < H ? ld(s_src + row * H + lane) : 0.f;
    float num[kLaneD];
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) num[j] = 0.f;
    float den = 0.f;  // lane k < H: head k's
    const int e1 = real ? lo_s[r + 1] : 0;
    for (int e = lo_s[r]; e < e1; ++e) {
      const int u = __ldg(meta_w + e * kMeta);
      // Outside the window, or a padding row: a zero source and s_tgt.
      const T* hu = unsigned(u) < unsigned(dm.window) && wrow0 + u < dm.n
                        ? h + (wrow0 + u) * HD : nullptr;
      float sc = 0.f;
      if (lane < H) {
        const float st = hu ? ld(s_tgt + (wrow0 + u) * H + lane) : 0.f;
        sc = leaky_exp(__fadd_rn(ss, st));
        den = __fadd_rn(den, rnd<T>(sc));
      }
#pragma unroll
      for (int j = 0; j < kLaneD; ++j) {
        const int c = lane + 32 * j;
        const float sc_c = __shfl_sync(0xffffffffu, sc, c < HD ? c / dh : 0);
        if (c >= HD) continue;
        const float x = hu ? ld(hu + c) : 0.f;
        num[j] = __fadd_rn(num[j], rnd<T>(__fmul_rn(sc_c, x)));
      }
    }
    const T* sp = real && spill != nullptr ? spill + row * TW : nullptr;
#pragma unroll
    for (int j = 0; j < kLaneD; ++j) {
      const int c = lane + 32 * j;
      if (c < HD) tot_s[r * TW + c] = __fadd_rn(num[j], sp ? ld(sp + c) : 0.f);
    }
    if (lane < H) tot_s[r * TW + HD + lane] = __fadd_rn(den, sp ? ld(sp + HD + lane) : 0.f);
  }
  __syncthreads();

  // feat = ELU(tot / den + prev . w_skip^T), written over the sums in place:
  // a thread reads only its own outputs' sums and the den columns.
  const int tr = tid / kTC, tc = tid % kTC;
  float acc[kRowsPT][kColsPT];
  tile_product(prev_s, HD, wsk_s, HD, tr, tc, acc);
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const int r = tr + kTR * i;
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      if (c >= HD) continue;
      float den = tot_s[r * TW + HD + c / dh];
      if (den == 0.f) den = 1.f;
      const float x = __fadd_rn(__fdiv_rn(tot_s[r * TW + c], den), acc[i][m]);
      tot_s[r * TW + c] = x > 0.f ? x : __fsub_rn(expf(fminf(x, 0.f)), 1.f);
    }
  }
  __syncthreads();  // feat is whole; prev's readers are done

  // h_next = feat . w_proj^T, written over prev.
  tile_product(tot_s, TW, wpj_s, HD, tr, tc, acc);
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
    for (int m = 0; m < kColsPT; ++m) {
      const int c = tc + kTC * m;
      if (c < HD) prev_s[(tr + kTR * i) * HD + c] = acc[i][m];
    }
  __syncthreads();

  // out = (h_next | feat | h_next . a_mat), rounded once.
  const int OW = 2 * HD + 2 * H;
  for (int i = tid; i < kRows * OW; i += kThreads) {
    const int r = i / OW, c = i - r * OW;
    const long row = row0 + r;
    if (row >= dm.n) break;  // rows are ascending: the rest are padding too
    float v;
    if (c < HD) {
      v = prev_s[r * HD + c];
    } else if (c < 2 * HD) {
      v = tot_s[r * TW + c - HD];
    } else {
      const int j = c - 2 * HD;
      v = 0.f;
      for (int k = 0; k < HD; ++k) v = fmaf(prev_s[r * HD + k], amat_s[k * 2 * H + j], v);
    }
    out[row * OW + c] = cvt<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* meta, const void* h, const void* s_src, const void* s_tgt,
                   const void* prev, const void* spill, const void* w_skip, const void* w_proj,
                   const void* a_mat, void* out, int num_windows, const Dims& dm,
                   cudaStream_t stream) {
  const size_t bytes = smem_layout(dm.hd, dm.heads).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gat_layer_ell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gat_layer_ell_kernel<T><<<num_windows * (dm.window / kRows), kThreads, bytes, stream>>>(
      static_cast<const int*>(meta), static_cast<const T*>(h), static_cast<const T*>(s_src),
      static_cast<const T*>(s_tgt), static_cast<const T*>(prev), static_cast<const T*>(spill),
      static_cast<const T*>(w_skip), static_cast<const T*>(w_proj),
      static_cast<const T*>(a_mat), static_cast<T*>(out), dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_layer_ell_max_d() { return kMaxHD; }
int gat_layer_ell_max_heads() { return kMaxHeads; }
int gat_layer_ell_rows_per_block() { return kRows; }
int gat_layer_ell_max_window_blocks() { return kMaxWindowBlocks; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gat_layer_ell_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs.
long long gat_layer_ell_smem_bytes(int hd, int heads) {
  return (long long)(smem_layout(hd, heads).total * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (h, s_src, s_tgt, prev, spill, w_skip,
// w_proj, a_mat, out). meta [num_windows*lanes, 5]: int32; spill may be null
// (no spill tail); out [n, 2*hd + 2*heads]. window must be
// 1..kMaxWindowBlocks whole blocks of kRows rows. Returns a cudaError_t.
int gat_layer_ell_launch(int dtype, const void* meta, const void* h, const void* s_src,
                         const void* s_tgt, const void* prev, const void* spill,
                         const void* w_skip, const void* w_proj, const void* a_mat, void* out,
                         int num_windows, int n, int window, int lanes, int hd, int heads,
                         int device, void* stream) {
  if (window % kRows || window / kRows < 1 || window / kRows > kMaxWindowBlocks ||
      hd < 1 || hd > kMaxHD || heads < 1 || heads > kMaxHeads || hd % heads ||
      num_windows < 1 || lanes < 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Dims dm{n, window, lanes, hd, heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(meta, h, s_src, s_tgt, prev, spill, w_skip, w_proj, a_mat, out,
                        num_windows, dm, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(meta, h, s_src, s_tgt, prev, spill, w_skip, w_proj, a_mat, out,
                                num_windows, dm, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gat_layer_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
