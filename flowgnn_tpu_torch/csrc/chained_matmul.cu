// Chained-matmul microbenchmark kernel for Hopper (sm_90a), on the tensor
// cores through wgmma.
//
// Replaces the TPU kernel of flowgnn_tpu/bench/matmul_shapes.py:measure
// (the kernel body at :58-74, its pallas_call at :80). Per row of A (the TPU
// grid tiles A's rows, and rows are independent, so the tiling does not
// change the function), with B [K, N] shared by all rows:
//   acc = 0
//   repeat layers times:
//     prod = a . B                     (f32 for bf16, int32 for int8)
//     acc += float(prod)
//     a = cast(relu(a) + float(prod[:, 0]) * 1e-9)   (bf16: round to nearest
//                                       even; int8: truncate toward zero)
//   out = acc                          (float32 [rows, N])
// The relu keeps the chain nonlinear, so no compiler may fold the layers'
// products into one.
//
// What bounds it on this card: 2*rows*K*N*layers operations over 989 TF/s
// (bf16) or 1979 TOP/s (int8), against A and B read once and the float32
// output written once; every shape of SHAPES is far above the ridge, so the
// bound is the tensor cores.
//
// Design. One block of 288 threads: two consumer warpgroups that issue
// wgmma.mma_async (m64nNk16 bf16 -> f32, m64nNk32 s8 -> s32) with both
// operands in shared memory and the accumulators in registers, and one
// producer warp that feeds B by bulk copy (cp.async.bulk, the TMA unit's
// 1-D form) against mbarriers. A block owns a slab of A's rows that lives in
// shared memory for all layers, loaded once by cp.async, rows past the end
// zero. Both operands sit in wgmma's K-major unswizzled layout (hopper.cuh):
// the slab as [K/16 bytes][rows][16 bytes], B as its transpose packed on
// the host into the same layout (ops/tiles.py) with N padded to the
// wgmma width, so a stage of B is one contiguous bulk copy. The relu update
// rewrites the slab in place, 16 bytes a thread, so it keeps the layout the
// products read.
// - Rows mode (the slab holds 128 rows): each warpgroup owns 64 rows and all
//   of N (wgmma N = 128, 136 or 256), and the two share nothing but B, so
//   they meet at no barrier after the slab is loaded. A warpgroup updates its
//   rows for the next layer stage by stage (all of K when B is resident),
//   just before it issues that stage's products: each thread 16 bytes of each
//   K step (one row, one core matrix), a proxy fence, a named barrier of the
//   warpgroup's 128 threads. Finer steps (an update and a barrier every 2, 4
//   or 8 K steps, to overlap the update with the products before) measured
//   slower on the H100. The bf16 update converts pairs (bf16x2 to float2 and
//   back, the add in f32, rounded to nearest even); int8's converts element
//   by element.
// - Columns mode (64 rows: the slab of 128 rows does not fit, as at K = 1024
//   bf16, or int8 with N > 128): both warpgroups share the 64 rows, each
//   takes 128 of the 256 padded columns; the update is a pass between the
//   layers that waits for both.
// - B stays resident (one bulk copy) where slab + B fit 227 KB; otherwise it
//   streams every layer through a ring of 3-8 stages of 32-128 bytes of K,
//   the producer waiting on each stage's release by both warpgroups, the
//   consumers keeping one wgmma group in flight while they release the
//   previous stage. No cluster multicast: B is read from L2.
// - bf16 accumulates across layers in the wgmma accumulator, and prod[:, 0]
//   is the difference of column 0 between layers (an error of one f32 ulp of
//   the running sum, scaled by 1e-9 before it meets a); the seeded check
//   against the plain version holds at 1e-4 of the largest output, and the
//   all-ones output stays exact. int8 stays exact: a per-layer s32 product
//   (integer sums reach K * 127^2 ~ 2^24 at K = 1024), added as float to the
//   f32 sum in layer order.
// Shared memory: slab 128 * K * es (or 64 *) + B (resident) or the ring,
// + 128 floats of prod[:, 0] + 16 mbarriers; the largest SHAPES rows use
// 192-225 KB, one block per SM. Registers: the accumulator is N/2 f32 a
// thread (bf16, up to 128 at N = 256), int8 adds N/2 s32 (128 + 128 at
// N = 128 in rows mode).

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace hopper;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxN = 256;
constexpr int kMaxStages = 8;
constexpr int kStepBytes = 32;             // bytes of K per wgmma

// How a launch lays out its block: slab rows, wgmma width, B's padded width,
// bytes of K per B stage (all of K when resident) and the stage count.
struct Plan {
  int bm, nw, np, chunk, stages;
  size_t smem;
};

size_t plan_smem(int bm, int kb, int np, int chunk, int stages) {
  return size_t(bm) * kb + size_t(stages) * np * chunk + bm * sizeof(float) +
         2 * kMaxStages * sizeof(uint64_t);
}

// The first layout that fits `optin` bytes: rows mode with B resident, rows
// mode streamed, columns mode resident, columns mode streamed. smem = 0: none.
Plan plan_of(int es, int k, int n, size_t optin) {
  const int kb = k * es;
  int rows_nw = 0;  // the rows-mode wgmma width
  if (n <= 128) rows_nw = 128;
  else if (es == 2 && n <= 136) rows_nw = 136;
  else if (es == 2) rows_nw = 256;
  auto fit = [&](int bm, int nw, int np, Plan& p) {
    if (plan_smem(bm, kb, np, kb, 1) <= optin) {
      p = Plan{bm, nw, np, kb, 1, plan_smem(bm, kb, np, kb, 1)};
      return true;
    }
    for (int chunk = 128; chunk >= kStepBytes; chunk /= 2) {
      if (kb % chunk) continue;
      const size_t fixed = plan_smem(bm, kb, np, chunk, 0);
      if (fixed > optin) return false;
      const int stages = int((optin - fixed) / (size_t(np) * chunk));
      if (stages >= 3) {
        const int s = stages < kMaxStages ? stages : kMaxStages;
        p = Plan{bm, nw, np, chunk, s, plan_smem(bm, kb, np, chunk, s)};
        return true;
      }
    }
    return false;
  };
  Plan p{0, 0, 0, 0, 0, 0};
  if (rows_nw && fit(128, rows_nw, rows_nw, p)) return p;
  if (fit(64, 128, 256, p)) return p;
  return Plan{0, 0, 0, 0, 0, 0};
}

// The relu update of one 16 bytes of a slab row: a = cast(relu(a) + add),
// the add in f32.
template <typename T> __device__ void relu_add(unsigned char* p, float add);
template <> __device__ __forceinline__ void relu_add<__nv_bfloat16>(unsigned char* p, float add) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 f = __bfloat1622float2(e[x]);
    e[x] = __floats2bfloat162_rn(__fadd_rn(fmaxf(f.x, 0.f), add), __fadd_rn(fmaxf(f.y, 0.f), add));
  }
  *reinterpret_cast<uint4*>(p) = v;
}
template <> __device__ __forceinline__ void relu_add<int8_t>(unsigned char* p, float add) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  int8_t* e = reinterpret_cast<int8_t*>(&v);
  // Truncation toward zero, as XLA's convert and torch's .to(int8) do for
  // values in range (relu keeps a in [0, 127 + 0.02]).
#pragma unroll
  for (int x = 0; x < 16; ++x) e[x] = int8_t(int(__fadd_rn(fmaxf(float(e[x]), 0.f), add)));
  *reinterpret_cast<uint4*>(p) = v;
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
cmm_kernel(const T* __restrict__ a, const unsigned char* __restrict__ bt, float* __restrict__ out,
           int rows, int K, int N, int layers, Plan p) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int es = sizeof(T);
  constexpr int R = NW / 2;  // accumulator registers a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int kb = K * es;     // bytes of K per row
  const int kg = kb / 16;    // core matrices along K
  const bool resident = p.stages == 1;
  const int chunks = kb / p.chunk;  // B stages per layer
  const size_t stage_bytes = size_t(p.np) * p.chunk;
  unsigned char* slab = smem;                     // [kg][bm][16]
  unsigned char* bs = slab + size_t(p.bm) * kb;   // stages x [chunk/16][np][16]
  float* p0_s = reinterpret_cast<float*>(bs + p.stages * stage_bytes);  // [bm]
  uint64_t* full = reinterpret_cast<uint64_t*>(p0_s + p.bm);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const long row0 = long(blockIdx.x) * p.bm;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  // The slab, 16 bytes a thread: 8 consecutive threads fill one core matrix
  // (8 rows x 16 bytes), 4 core matrices along K make a warp's 64 bytes of 8
  // rows.
  if (tid < kConsumers) {
    const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
    for (int i = tid; i < p.bm * kg; i += kConsumers) {
      const int r = (i & 7) + 8 * (i / (8 * kg)), g = (i >> 3) % kg;
      const bool ok = row0 + r < rows;
      cp_async16(slab + (size_t(g) * p.bm + r) * 16, ab + (ok ? (row0 + r) * kb + g * 16 : 0),
                 ok ? 16 : 0);
    }
  }
  __syncthreads();  // the mbarriers are initialised

  if (tid >= kConsumers) {  // the producer warp: one thread issues B's copies
    if (tid == kConsumers) {
      if (resident) {
        mbar_arrive_expect_tx(full, uint32_t(stage_bytes));
        bulk_g2s(bs, bt, uint32_t(stage_bytes), full);
      } else {
        int it = 0;
        for (int l = 0; l < layers; ++l)
          for (int c = 0; c < chunks; ++c, ++it) {
            const int s = it % p.stages;
            mbar_wait(empty + s, ((it / p.stages) & 1) ^ 1);
            mbar_arrive_expect_tx(full + s, uint32_t(stage_bytes));
            bulk_g2s(bs + s * stage_bytes, bt + c * stage_bytes, uint32_t(stage_bytes), full + s);
          }
      }
    }
    return;
  }

  cp_async_wait_all();
  fence_proxy_async();
  bar_sync(1, kConsumers);  // the whole slab is in place, visible to wgmma

  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const bool cols = p.bm == 64;
  const int rbase = cols ? 0 : 64 * wg;   // the warpgroup's first slab row
  const int cbase = cols ? NW * wg : 0;   // and first column
  const uint32_t a_lbo = p.bm * 16, b_lbo = p.np * 16;
  // The rows this warpgroup updates between layers, and who shares them.
  const int bar_id = cols ? 1 : 2 + wg, bar_n = cols ? kConsumers : 128;

  float acc[R];
  int prod[kInt8 ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  float prev0 = 0.f, prev8 = 0.f;  // bf16: column 0 of acc after the last layer
  // Rows mode updates a stage's K steps of the warpgroup's rows just before
  // it reads them: each thread its 16 bytes of each step (row t % 64, core
  // matrix t / 64 of the step). `add` is its row's prod[:, 0]·1e-9.
  float add = 0.f;
  unsigned char* unit = slab + (size_t(t >> 6) * p.bm + rbase + (t & 63)) * 16;
  const int nks = p.chunk / kStepBytes;  // K steps per B stage
  if (resident) mbar_wait(full, 0);
  int it = 0;
  for (int l = 0; l < layers; ++l) {
    int prev_s = -1;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = resident ? 0 : it % p.stages;
      if (!resident) mbar_wait(full + s, (it / p.stages) & 1);
      const unsigned char* bstage = bs + s * stage_bytes;
      if (!cols && l > 0) {
        for (int ks = 0; ks < nks; ++ks)
          relu_add<T>(unit + size_t(2 * (c * nks + ks)) * p.bm * 16, add);
        fence_proxy_async();
        bar_sync(bar_id, bar_n);  // the stage's K steps of these rows are updated
      }
      wgmma_fence();
      for (int ks = 0; ks < nks; ++ks) {
        const int kg = 2 * (c * nks + ks);  // the step's first core matrix
        const uint64_t da = desc(slab + (size_t(kg) * p.bm + rbase) * 16, a_lbo, 128);
        const uint64_t db = desc(bstage + (size_t(2 * ks) * p.np + cbase) * 16, b_lbo, 128);
        if constexpr (kInt8)
          mma_s8_ss<NW>(prod, da, db, c > 0 || ks > 0);
        else
          mma_bf16_ss<NW>(acc, da, db, 1);
      }
      wgmma_commit();
      if (!resident) {  // release the previous stage once its products are done
        wgmma_wait<1>();
        if (prev_s >= 0 && t == 0) mbar_arrive(empty + prev_s);
        prev_s = s;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (kInt8) fence_regs(prod);
    if (!resident && t == 0) mbar_arrive(empty + prev_s);

    float p0a, p0b;  // prod[:, 0] of rows g and g + 8 (threads q == 0)
    if constexpr (kInt8) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], float(prod[i]));
      p0a = float(prod[0]);
      p0b = float(prod[2]);
    } else {
      p0a = __fsub_rn(acc[0], prev0);
      p0b = __fsub_rn(acc[2], prev8);
      prev0 = acc[0];
      prev8 = acc[2];
    }
    if (l + 1 == layers) break;
    const int lrow = rbase + 16 * warp + g;
    if (cbase == 0 && q == 0) {
      p0_s[lrow] = p0a;
      p0_s[lrow + 8] = p0b;
    }
    bar_sync(bar_id, bar_n);  // prod[:, 0] published; the slab's readers are done
    if (!cols) {  // the next layer's loop updates the rows
      add = __fmul_rn(p0_s[rbase + (t & 63)], 1e-9f);
      continue;
    }
    // Columns mode: both warpgroups read all 64 rows, so the update is a
    // pass of its own between the layers.
    for (int i = tid; i < 64 * kg; i += kConsumers) {
      const int r = (i & 7) + 8 * (i / (8 * kg)), gk = (i >> 3) % kg;
      relu_add<T>(slab + (size_t(gk) * p.bm + r) * 16, __fmul_rn(p0_s[r], 1e-9f));
    }
    fence_proxy_async();
    bar_sync(bar_id, bar_n);  // the updated rows are visible to the next products
  }

  const long r0 = row0 + rbase + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = cbase + 8 * j + 2 * q;
    if (col >= N) continue;
    if (r0 < rows) *reinterpret_cast<float2*>(out + r0 * N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<float2*>(out + (r0 + 8) * N + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void cmm_empty_kernel() {}

template <typename T, int NW>
cudaError_t launch_nw(const void* a, const void* bt, void* out, int rows, int k, int n,
                      int layers, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(cmm_kernel<T, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + p.bm - 1) / p.bm;
  cmm_kernel<T, NW><<<blocks, kThreads, p.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const unsigned char*>(bt), static_cast<float*>(out),
      rows, k, n, layers, p);
  return cudaGetLastError();
}

size_t optin_bytes(int device, cudaError_t* err) {
  int bytes = 0;
  *err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return size_t(bytes);
}

}  // namespace

extern "C" {

int cmm_max_n() { return kMaxN; }

// The largest dynamic shared memory (bytes) a block may opt in to, or a
// negative cudaError_t.
long long cmm_smem_optin(int device) {
  cudaError_t err;
  const size_t bytes = optin_bytes(device, &err);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// The padded width B must be packed to (ops/tiles.py) for a launch of this
// dtype (as in cmm_launch), K and N on a card whose blocks may opt in to
// `optin` bytes of shared memory; 0 when no layout fits. *smem receives the
// layout's shared memory.
int cmm_padded_n(int dtype, int k, int n, long long optin, long long* smem) {
  const Plan p = plan_of(dtype == 1 ? 1 : 2, k, n, size_t(optin));
  *smem = (long long)p.smem;
  return p.np;
}

// dtype: 0 = bfloat16, 1 = int8. a [rows, k] row-major; bt: B [k, n] packed
// K-major into [k * es / 16][np][16 bytes] with np = cmm_padded_n(...), the
// padding zero; out: float32 [rows, n]. k a multiple of 32, n a multiple of
// 8 up to cmm_max_n. Returns a cudaError_t.
int cmm_launch(int dtype, const void* a, const void* bt, void* out, int rows, int k, int n,
               int np, int layers, int device, void* stream) {
  if (rows < 1 || k < 32 || k % 32 || n < 8 || n > kMaxN || n % 8 || layers < 1 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t optin = optin_bytes(device, &err);
  if (err != cudaSuccess) return int(err);
  const Plan p = plan_of(dtype == 1 ? 1 : 2, k, n, optin);
  if (p.smem == 0 || p.np != np) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return int(launch_nw<int8_t, 128>(a, bt, out, rows, k, n, layers, p, s));
  if (p.nw == 128) return int(launch_nw<__nv_bfloat16, 128>(a, bt, out, rows, k, n, layers, p, s));
  if (p.nw == 136) return int(launch_nw<__nv_bfloat16, 136>(a, bt, out, rows, k, n, layers, p, s));
  return int(launch_nw<__nv_bfloat16, 256>(a, bt, out, rows, k, n, layers, p, s));
}

// One launch of an empty kernel on the stream: the launch floor.
int cmm_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cmm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

const char* cmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
