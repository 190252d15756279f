// GAT megakernel ablation for Hopper (sm_90a): the four slot-megakernel
// forms of the TPU ablation tool, each with one stage knocked out.
//
// Replaces the TPU kernels of flowgnn_tpu/bench/ablate_gat_mega.py:
// _variant_model (v1, :50, pallas_call :198), _variant_model_v3 (:224 /
// :406), _variant_model_v4 (:428 / :536) and _variant_model_v5 (:558 /
// :688), with their helper _pool_epilogue. Each computes the whole GAT model
// per node window, as row 5 (csrc/gat_local_model_slots.cu) does, but with
// its own operands and rounding points:
//   v1  the full S*W slot stack; layer l's skip = prev . skip_w[l] in the
//       kernel (layer 0 from prev0 too); h = rnd(feat . proj), scores
//       [s_src | s_tgt] = rnd(h . a_next), both rounded to T where row 5
//       keeps them float32;
//   v3  the prefix-compacted stack; one fused glue product per layer, feat .
//       glue_w, whose columns are [h | s_tgt | 0 | skip | s_src] (h, s_tgt
//       and s_src rounded, skip not); skip0 given;
//   v4  v3 with the gather as the product onehot . [h | s_tgt] of an operand
//       tile [sum(c), W]: the function is defined for any tile, so the kernel
//       multiplies and does not search for the one; valid is the tile's row
//       sum, and the score is multiplied by it;
//   v5  v3 with each head's score repeated over its D columns
//       (expand_score_operands): a 2*HD payload [h | s_tgt_exp], glue_wx
//       [h | s_tgt_exp | skip | s_src_exp], no head expand.
// Per layer, for window row v and each lane u -> v of its slots:
//   raw = s_src[v] + s_tgt[u];  score = exp(leaky(raw, 0.2)) * valid
//   msg = rnd(sum score * h_u / sum score)   (zero sum -> 1, per column)
// then feat = rnd(ELU(msg + skip)) and the glue, and on the last layer the
// pooled head rnd(msg + skip) . pred_hd (or, nopool, (msg + skip)[:GMAX, :T]
// per window). The knockouts are bits of a runtime flags argument
// (noexp, nogather, noexpand, noglue, nopool, nodivide, nocast, staticcat,
// addcat, noelu), tested by branches uniform over the block: a knocked-out
// stage costs a predicate, not its work. The variants that compute their
// form's full function (v1 repeat, v3 bf16hu / split / stackexp, v5 split:
// TPU matmul-layout experiments) run the full path. The four forms are a
// template parameter, and with float32 and bfloat16 that makes eight
// instantiations. An empty lane (source >= W; v4: row sum 0) is skipped: it
// adds score * 0 = 0 in the TPU kernels.
//
// What bounds it on this card: as row 5, per window and layer the messages'
// lanes x H*D multiply-adds and lanes x H exps (v4: lanes x W x (H*D + H)
// for the one-hot product) and the glue's W x H*D x (2*H*D + 2*H); the
// operands are read once and GMAX*T floats written per window, so it is
// bound on chip by the dependent layer chain. Design, from row 5: one
// 256-thread block per window; the payload, skip and msg of the window's
// rows in shared memory (f32; v1 also prev, and layer 0's payload for
// staticcat / addcat); one warp per destination row over H*D; the glue
// products register-tiled FMA (8 rows x 8 columns a thread) with the
// weights read through L1. Every sum has a fixed order and no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;               // thread rows of the glue tile
constexpr int kTC = 16;               // thread columns of the glue tile
constexpr int kRowsPT = 8;            // rows per thread
constexpr int kColsPT = 8;            // columns per thread
constexpr int kRB = kTR * kRowsPT;    // rows per glue tile (128)
constexpr int kCB = kTC * kColsPT;    // columns per glue tile (128)
constexpr int kMaxHD = 64;
constexpr int kLaneHD = kMaxHD / 32;  // H*D columns per lane in the messages
constexpr int kMaxHeads = 8;
constexpr int kMaxSlots = 8;
constexpr int kMaxWindow = 128;

enum Flag : int {
  kNoExp = 1, kNoGather = 2, kNoExpand = 4, kNoGlue = 8, kNoPool = 16,
  kNoDivide = 32, kNoCast = 64, kStaticCat = 128, kAddCat = 256, kNoElu = 512,
};

struct Dims {
  int n, window, hd, heads, layers, gmax, tout, slots, lanes, ldg, flags;
};

struct Caps {
  int caps[kMaxSlots];
};

// Shared-memory carve-up, in 4-byte words.
struct Smem {
  size_t px, p0, pv, sk, m, ss, lane, p, gl, rows, gstart, total;
};

__host__ __device__ inline int payload_width(int form, int hd, int heads) {
  return form == 5 ? 2 * hd : hd + heads;
}
__host__ __device__ inline int score_width(int form, int hd, int heads) {
  return form == 5 ? hd : heads;
}
__host__ __device__ inline bool layer0_payload(int form, int flags) {
  return form == 1 && (flags & (kStaticCat | kAddCat));
}

__host__ __device__ inline Smem smem_layout(int form, const Dims& dm) {
  const size_t W = dm.window, HD = dm.hd;
  const size_t PW = payload_width(form, dm.hd, dm.heads);
  size_t p = W * dm.tout;                // head outputs
  if (size_t(dm.gmax) > p) p = dm.gmax;  // CSR cursor
  Smem s;
  size_t o = 0;
  s.px = o; o += W * PW;
  s.p0 = o; if (layer0_payload(form, dm.flags)) o += W * PW;
  s.pv = o; if (form == 1) o += W * HD;
  s.sk = o; o += W * HD;
  s.m = o; o += W * HD;
  s.ss = o; o += W * score_width(form, dm.hd, dm.heads);
  s.lane = o; o += dm.lanes;
  s.p = o; o += p;
  s.gl = o; o += W;
  s.rows = o; o += W;
  s.gstart = o; o += dm.gmax + 1;
  s.total = o;
  return s;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// store(r, c, sum_k a_s[r * lda + k] * w[k * ldw + col(c)]) for r < rows,
// c < nc: each thread 8 rows x 8 columns of a 128 x 128 tile, fmaf in k
// order.
template <typename T, typename Col, typename Store>
__device__ __forceinline__ void gemm(const float* a_s, int lda, int rows, int K, int nc,
                                     const T* __restrict__ w, int ldw, Col col, Store store) {
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  for (int rb = 0; rb < rows; rb += kRB)
    for (int cb = 0; cb < nc; cb += kCB) {
      float acc[kRowsPT][kColsPT];
      int wc[kColsPT];
#pragma unroll
      for (int m = 0; m < kColsPT; ++m) {
        const int c = cb + tc + kTC * m;
        wc[m] = c < nc ? col(c) : -1;
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) acc[i][m] = 0.f;
      }
      for (int k = 0; k < K; ++k) {
        float a[kRowsPT];
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const int r = rb + tr + kTR * i;
          a[i] = r < rows ? a_s[r * lda + k] : 0.f;
        }
        const T* wrow = w + long(k) * ldw;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const float wv = wc[m] >= 0 ? ld(wrow + wc[m]) : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPT; ++i) acc[i][m] = fmaf(a[i], wv, acc[i][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const int r = rb + tr + kTR * i;
        if (r >= rows) continue;
#pragma unroll
        for (int m = 0; m < kColsPT; ++m) {
          const int c = cb + tc + kTC * m;
          if (c < nc) store(r, c, acc[i][m]);
        }
      }
    }
}

template <int FORM, typename T>
__global__ void __launch_bounds__(kThreads)
gma_kernel(const void* __restrict__ stack, const T* __restrict__ h0, const T* __restrict__ x0,
           const T* __restrict__ s0, const T* __restrict__ wg, const T* __restrict__ wp,
           const T* __restrict__ wa, const int* __restrict__ pool_gl,
           const T* __restrict__ pred_hd, float* __restrict__ out, Dims dm, Caps cp) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(FORM, dm);
  const int W = dm.window, HD = dm.hd, H = dm.heads, DH = HD / H, fl = dm.flags;
  const int PW = payload_width(FORM, HD, H), SW = score_width(FORM, HD, H);
  const bool cat0 = layer0_payload(FORM, fl);
  const bool v1_noglue = FORM == 1 && (fl & kNoGlue);
  float* px = smem + lay.px;    // [W][PW] gathered payload [h | s_tgt], rounded
  float* p0 = smem + lay.p0;    // [W][PW] layer 0's payload (v1 staticcat / addcat)
  float* pv = smem + lay.pv;    // [W][HD] prev (v1)
  float* sk = smem + lay.sk;    // [W][HD] skip term
  float* m_s = smem + lay.m;    // [W][HD] msg, then feat or the final sum
  float* ss = smem + lay.ss;    // [W][SW] s_src, rounded
  int* lane_i = reinterpret_cast<int*>(smem + lay.lane);  // [lanes] sources (v1, v3, v5)
  float* lane_f = smem + lay.lane;                        // [lanes] row sums (v4)
  float* p_s = smem + lay.p;                              // [W][T] head outputs; cursor
  int* gl_s = reinterpret_cast<int*>(smem + lay.gl);
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);
  int* gstart_s = reinterpret_cast<int*>(smem + lay.gstart);
  const T* onehot = static_cast<const T*>(stack) + long(blockIdx.x) * dm.lanes * W;

  const int tid = threadIdx.x;
  const long row0 = long(blockIdx.x) * W;
  for (int i = tid; i < W * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    const bool real = row0 + r < dm.n;
    const long at = (row0 + r) * HD + c;
    px[r * PW + c] = real ? ld(h0 + at) : 0.f;
    (FORM == 1 ? pv : sk)[i] = real ? ld(x0 + at) : 0.f;
  }
  // s0's rows are [s_src | s_tgt], SW columns each.
  for (int i = tid; i < W * SW; i += kThreads) {
    const int r = i / SW, c = i - r * SW;
    const bool real = row0 + r < dm.n;
    const long at = (row0 + r) * 2 * SW + c;
    ss[i] = real ? ld(s0 + at) : 0.f;
    px[r * PW + HD + c] = real ? ld(s0 + at + SW) : 0.f;
  }
  for (int i = tid; i < dm.lanes; i += kThreads) {
    if (FORM == 4) {
      float s = 0.f;
      for (int q = 0; q < W; ++q) s = __fadd_rn(s, ld(onehot + long(i) * W + q));
      lane_f[i] = s;
    } else {
      lane_i[i] = static_cast<const int*>(stack)[long(blockIdx.x) * dm.lanes + i];
    }
  }
  for (int r = tid; r < W; r += kThreads) gl_s[r] = pool_gl[row0 + r];
  __syncthreads();
  if (cat0)
    for (int i = tid; i < W * PW; i += kThreads) p0[i] = px[i];
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
  for (int l = 0; l < dm.layers; ++l) {
    const bool last = l == dm.layers - 1;
    __syncthreads();  // the payload, scores, skip and prev of this layer are complete
    if (FORM == 1 && !v1_noglue) {
      // skip = prev . skip_w[l]
      gemm<T>(pv, HD, W, HD, HD, wg + long(l) * HD * HD, HD, [](int c) { return c; },
              [&](int r, int c, float v) { sk[r * HD + c] = v; });
      __syncthreads();
    }
    const float* P = cat0 ? p0 : px;
    const bool addcat = FORM == 1 && (fl & kAddCat);
    const float add = addcat ? rnd<T>(float(double(l) * 1e-7)) : 0.f;

    // Messages, one warp per destination row, lanes over H*D.
    for (int r = warp; r < W; r += kWarps) {
      float num[kLaneHD], den[kLaneHD];
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) { num[j] = 0.f; den[j] = 0.f; }
      int off = 0;
      for (int k = 0; k < dm.slots; off += cp.caps[k], ++k) {
        if (r >= cp.caps[k]) continue;
        const int i = off + r;
        float vf = 1.f;
        int src = i % W;
        bool zero = false;
        if (FORM == 4) {
          vf = lane_f[i];
          if (vf == 0.f) continue;  // empty lane
        } else {
          const int u = lane_i[i];
          if (u >= W) continue;  // empty lane
          if (!(fl & kNoGather)) {
            src = u;
            zero = u < 0;
          }
        }
#pragma unroll
        for (int j = 0; j < kLaneHD; ++j) {
          const int c = lane + 32 * j;
          if (c >= HD) break;
          const int sc = FORM == 5 ? c : ((fl & kNoExpand) ? 0 : c / DH);
          float hu = 0.f, s2 = 0.f;
          if (FORM == 4 && !(fl & kNoGather)) {
            const T* oh = onehot + long(i) * W;
            for (int q = 0; q < W; ++q) {
              const float o = ld(oh + q);
              hu = fmaf(o, P[q * PW + c], hu);
              s2 = fmaf(o, P[q * PW + HD + sc], s2);
            }
          } else if (!zero) {
            hu = P[src * PW + c];
            s2 = P[src * PW + HD + sc];
            if (addcat) {
              hu = rnd<T>(__fadd_rn(hu, add));
              s2 = rnd<T>(__fadd_rn(s2, add));
            }
          }
          const float raw = __fadd_rn(ss[r * SW + sc], s2);
          float score = (fl & kNoExp) ? raw : expf(raw < 0.f ? __fmul_rn(raw, 0.2f) : raw);
          score = __fmul_rn(score, vf);
          num[j] = __fadd_rn(num[j], __fmul_rn(score, hu));
          den[j] = __fadd_rn(den[j], score);
        }
      }
#pragma unroll
      for (int j = 0; j < kLaneHD; ++j) {
        const int c = lane + 32 * j;
        if (c >= HD) break;
        float msg = (fl & kNoDivide) ? num[j] : num[j] / (den[j] == 0.f ? 1.f : den[j]);
        if (!(fl & kNoCast)) msg = rnd<T>(msg);
        m_s[r * HD + c] = msg;
      }
    }
    __syncthreads();  // every row's msg; the payload is no longer read

    if (last) {
      if (!v1_noglue)
        for (int i = tid; i < W * HD; i += kThreads) m_s[i] = __fadd_rn(m_s[i], sk[i]);
      break;
    }
    if (v1_noglue) {
      // h = prev = rnd(msg); the scores stay those of the layer before.
      for (int i = tid; i < W * HD; i += kThreads) {
        const int r = i / HD, c = i - r * HD;
        px[r * PW + c] = pv[i] = rnd<T>(m_s[i]);
      }
      continue;
    }
    const bool elu = !(FORM == 3 && (fl & kNoElu));
    for (int i = tid; i < W * HD; i += kThreads) {
      float x = __fadd_rn(m_s[i], sk[i]);
      if (elu && x <= 0.f) x = __fsub_rn(expf(x), 1.f);
      m_s[i] = rnd<T>(x);
      if (FORM == 1) pv[i] = m_s[i];
    }
    if (FORM == 3 && (fl & kNoGlue)) {
      // h = skip = feat; s_tgt gathers the payload's zero columns.
      for (int i = tid; i < W * HD; i += kThreads) {
        const int r = i / HD, c = i - r * HD;
        px[r * PW + c] = sk[i] = m_s[i];
      }
      for (int i = tid; i < W * H; i += kThreads) px[(i / H) * PW + HD + i % H] = 0.f;
      continue;
    }
    __syncthreads();  // feat complete
    if (FORM == 1) {
      gemm<T>(m_s, HD, W, HD, HD, wp + long(l) * HD * HD, HD, [](int c) { return c; },
              [&](int r, int c, float v) { px[r * PW + c] = rnd<T>(v); });
      __syncthreads();
      gemm<T>(px, PW, W, HD, 2 * H, wa + long(l) * HD * 2 * H, 2 * H, [](int c) { return c; },
              [&](int r, int c, float v) {
                if (c < H) ss[r * SW + c] = rnd<T>(v);
                else px[r * PW + HD + c - H] = rnd<T>(v);
              });
    } else if (FORM == 5) {
      gemm<T>(m_s, HD, W, HD, 4 * HD, wg + long(l) * HD * dm.ldg, dm.ldg,
              [](int c) { return c; }, [&](int r, int c, float v) {
                if (c < 2 * HD) px[r * PW + c] = rnd<T>(v);
                else if (c < 3 * HD) sk[r * HD + c - 2 * HD] = v;
                else ss[r * SW + c - 3 * HD] = rnd<T>(v);
              });
    } else {
      // glue_w columns [h | s_tgt | 0 | skip | s_src], PAY = ldg - HD - H.
      const int pay = dm.ldg - HD - H;
      gemm<T>(m_s, HD, W, HD, 2 * HD + 2 * H, wg + long(l) * HD * dm.ldg, dm.ldg,
              [&](int c) { return c < HD + H ? c : pay + c - HD - H; },
              [&](int r, int c, float v) {
                if (c < HD + H) px[r * PW + c] = rnd<T>(v);
                else if (c < 2 * HD + H) sk[r * HD + c - HD - H] = v;
                else ss[r * SW + c - 2 * HD - H] = rnd<T>(v);
              });
    }
  }
  __syncthreads();

  float* out_w = out + long(blockIdx.x) * dm.gmax * dm.tout;
  if ((fl & kNoPool) && !v1_noglue) {
    for (int i = tid; i < dm.gmax * dm.tout; i += kThreads) {
      const int g = i / dm.tout, t = i - g * dm.tout;
      out_w[i] = m_s[g * HD + t];
    }
    return;
  }
  // Finalize: per-row head p = rnd(final) . pred_hd, then per-graph sums.
  for (int i = tid; i < W * dm.tout; i += kThreads) {
    const int r = i / dm.tout, t = i - r * dm.tout;
    float s = 0.f;
    for (int c = 0; c < HD; ++c)
      s = fmaf(rnd<T>(m_s[r * HD + c]), ld(pred_hd + c * dm.tout + t), s);
    p_s[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < dm.gmax * dm.tout; i += kThreads) {
    const int g = i / dm.tout, t = i - g * dm.tout;
    float s = 0.f;
    for (int j = gstart_s[g]; j < gstart_s[g + 1]; ++j) s += p_s[rows_s[j] * dm.tout + t];
    out_w[i] = s;
  }
}

template <int FORM, typename T>
cudaError_t launch(const void* stack, const void* h0, const void* x0, const void* s0,
                   const void* wg, const void* wp, const void* wa, const void* pool_gl,
                   const void* pred_hd, void* out, int num_windows, const Dims& dm,
                   const Caps& cp, cudaStream_t stream) {
  const size_t bytes = smem_layout(FORM, dm).total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gma_kernel<FORM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  gma_kernel<FORM, T><<<num_windows, kThreads, bytes, stream>>>(
      stack, static_cast<const T*>(h0), static_cast<const T*>(x0), static_cast<const T*>(s0),
      static_cast<const T*>(wg), static_cast<const T*>(wp), static_cast<const T*>(wa),
      static_cast<const int*>(pool_gl), static_cast<const T*>(pred_hd),
      static_cast<float*>(out), dm, cp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(int form, const void* stack, const void* h0, const void* x0,
                        const void* s0, const void* wg, const void* wp, const void* wa,
                        const void* pool_gl, const void* pred_hd, void* out, int num_windows,
                        const Dims& dm, const Caps& cp, cudaStream_t s) {
  switch (form) {
    case 1: return launch<1, T>(stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd, out,
                                num_windows, dm, cp, s);
    case 3: return launch<3, T>(stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd, out,
                                num_windows, dm, cp, s);
    case 4: return launch<4, T>(stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd, out,
                                num_windows, dm, cp, s);
    case 5: return launch<5, T>(stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd, out,
                                num_windows, dm, cp, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int gma_max_d() { return kMaxHD; }
int gma_max_heads() { return kMaxHeads; }
int gma_max_slots() { return kMaxSlots; }
int gma_max_window() { return kMaxWindow; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long gma_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// Dynamic shared memory (bytes) one block needs; lanes is the lanes per
// window (v1 S*W, else sum(caps)).
long long gma_smem_bytes(int form, int window, int hd, int heads, int gmax, int tout, int lanes,
                         int flags) {
  const Dims dm{0, window, hd, heads, 0, gmax, tout, 0, lanes, 0, flags};
  return (long long)(smem_layout(form, dm).total * 4);
}

// form: 1, 3, 4 or 5; dtype: 0 = float32, 1 = bfloat16 (h0, x0, s0, the
// weights, pred_hd, and v4's one-hot stack). stack: int32 sources (v1, v3,
// v5) or the one-hot tiles (v4), num_windows * lanes rows; x0: v1's prev0,
// else skip0; wg: v1's skip_w, else the glue weight with row stride ldg;
// wp, wa: v1's proj_w and a_next (null otherwise). out: float32
// [num_windows * gmax, tout]. Returns a cudaError_t.
int gma_launch(int form, int dtype, const void* stack, const void* h0, const void* x0,
               const void* s0, const void* wg, const void* wp, const void* wa,
               const void* pool_gl, const void* pred_hd, void* out, int num_windows, int n,
               int window, int hd, int heads, int layers, int gmax, int tout, const int* caps,
               int slots, int ldg, int flags, int device, void* stream) {
  if (slots < 1 || slots > kMaxSlots || hd < 1 || hd > kMaxHD || heads < 1 ||
      heads > kMaxHeads || hd % heads || layers < 1 || num_windows < 1 || window < 1 ||
      window > kMaxWindow || ((flags & kNoPool) && (gmax > window || tout > hd)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  Caps cp{};
  int lanes = 0;
  for (int k = 0; k < slots; ++k) {
    cp.caps[k] = form == 1 ? window : caps[k];
    if (cp.caps[k] < 0 || cp.caps[k] > window) return int(cudaErrorInvalidValue);
    lanes += cp.caps[k];
  }
  const Dims dm{n, window, hd, heads, layers, gmax, tout, slots, lanes, ldg, flags};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_form<float>(form, stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd, out,
                             num_windows, dm, cp, s);
  else if (dtype == 1)
    err = launch_form<__nv_bfloat16>(form, stack, h0, x0, s0, wg, wp, wa, pool_gl, pred_hd,
                                     out, num_windows, dm, cp, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

const char* gma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
