// W8A8: the int8 encoder layer's two kernels (the `_block_i8` of
// openhush_tpu_torch/models/whisper/model.py).
//
// 1. The per-row quantize, x [R, D] (bf16 or fp32) -> int8 levels [R, D] and
//    fp32 scales [R]:
//      scale = max|x| * float32(1/127), safe = max(scale, 1e-10),
//      level = clamp(rint(x / safe), -127, 127)
//    as `_quantize_rows` computes it; with a layer norm (gamma, beta) it
//    quantizes layer_norm(x) rounded to x's dtype first (the ln1 -> q/k/v
//    and ln2 -> fc1 inputs), as the plain `quantize_rows(x, ln=...)` does.
// 2. The int8 product with its epilogue,
//      y = float(int32 sum_i x8[m, i] q[i, o]) * xs[m] * s[o]   (+ bias[o])
//    folded left to right in fp32, then rounded to the output's dtype, then
//    GELU (fc1) and the residual add (o, fc2), each rounded to the dtype as
//    the separate PyTorch ops round. Without options the output is fp32 (the
//    plain `_mm_i8`). One launch serves up to three products of one x8 (q, k
//    and v of one h8), each member with its own levels, scales, bias and
//    output.
//
// Replaces no TPU kernel: the reference computes both in XLA
// (openhush_tpu/models/whisper/model.py:334 `_quantize_rows`, :354
// `_mm_i8`, :442 `block_i8`), which fuses the quantize into the layer norm
// and GELU around it and folds the scales into the int8 dot. In eager
// PyTorch nothing fuses: the port's plain version makes ~9 passes over an
// activation for a quantize and 5-7 for a product's epilogue, and its
// product (torch._int_mm) is an sm80 mma.sync kernel.
//
// Bounds on an H100 (large-v3, T = 1500 rows a window): the quantize by
// bytes (a [1500, 1280] bf16 row block in, int8 and scales out: 5.8 MB,
// 1.7 us at 3.35 TB/s); the product by operations (fc1 [1500, 1280] x
// [1280, 5120]: 19.7 GOP, 9.9 us at 1,979 int8 TOP/s).
//
// The quantize: one CTA a row, 32-256 threads, each holding up to 3
// vectors of 8 values in registers (rows up to 6144 values: Whisper's
// widest is large-v3's MLP, 5120, at 3; small's and medium's 3072 and 4096
// take 2): the row is read once. Three block
// reductions at most (sum, sum of squared deviations, max), each in a fixed
// order, so two launches give the same bits. Plain mode keeps the plain
// version's arithmetic (rint of an IEEE division, __fdiv_rn; a max that
// keeps a NaN as torch's amax does; a NaN level is 0, as the card's cast
// makes it), so it gives its bits. The layer norm's mean and variance are
// two-pass sums in another order than torch's Welford, and rsqrtf as torch
// uses; its output can move by an ulp and flip a level, so the fused mode
// is held to a tolerance (chip_smoke.py phase 2).
//
// The product: y[M, O] tiles of 128 rows by 128 columns a CTA, two
// warpgroups of 64 rows each, wgmma m64n128k32 (s8 x s8 -> s32, sm_90a)
// with both operands K-major in shared memory, as int8 wgmma requires: x8
// [M, I] row-major and the levels stored column-major (q^T [O, I]
// contiguous, model.quantize_encoder_weights), neither re-laid out. A
// ninth warp streams 128-byte k-slabs of both by TMA (128-byte swizzle, a
// ring of 3 slabs, mbarriers full/empty) and TMA zero-fills past M, I and
// O. Two CTAs an SM, so one CTA's epilogue runs beside the other's
// products. The int32 sums are exact, so the order is free; the
// epilogue's int32 -> fp32 is __int2float_rn (|sum| reaches 127 * 127 *
// 5120 > 2^24, so it rounds, as torch's .float() does) and every fold and
// add is __fmul_rn/__fadd_rn (nvcc would contract an FMA): the product
// with its folds, bias, cast and residual gives the plain version's bits.
// GELU is torch's formula on the card in fp32 on the rounded value (erff,
// or the tanh form whose inner x + kappa x^3 nvcc contracts into an FMA in
// torch's build), then rounded again; held to one ulp of the dtype (it
// gave the plain version's bits on the card).
//
// Where the time goes (an NVIDIA H100 80GB HBM3 at 700 W,
// tools/torch_w8a8_probe.py --variant, builds without parts): at 1500 rows
// the epilogue, not the products or the loads. A build with the epilogue
// alone took 0.0191 of o's 0.0233 ms and 0.0285 of fc1's 0.0461 while
// each residual load waited behind the previous output's store (a load
// that may alias a store is not moved above it). So the tile's column
// scales and bias sit in shared memory, and the residuals of two 8-column
// groups are read before their outputs are written. A deeper ring (6 slabs
// at one CTA an SM, or 64-byte slabs), a release of each slab before the
// next one's products, and the first version's refills from thread 0 were
// no faster or slower. fc1's GELU (erff) is the largest epilogue.
// A persistent grid that overlaps a tile's epilogue with the next tile's
// products is not tried.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAX_DEVICES = 64;

// ---------------------------------------------------------------------------
// The per-row quantize
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;            // at most, a CTA (one row)
constexpr int Q_MAX_NV = 3;               // 8-value vectors a thread at most
constexpr float INV127 = (float)(1.0 / 127.0);

// torch's amax: a NaN anywhere makes the max NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
struct MaxNan {
  __device__ __forceinline__ float operator()(float a, float b) const { return max_nan(a, b); }
};
struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Every thread's v combined over the CTA in a fixed order (lanes by
// butterfly, then the warps in order); every thread gets the result.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                        // red's previous use is read out
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = op(r, red[w]);
  return r;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *(const uint4*)p;
  const __nv_bfloat162* h = (const __nv_bfloat162*)&u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = ((const float4*)p)[0], b = ((const float4*)p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const void* p, int bf16, float (&v)[8]) {
  if (bf16) load8((const __nv_bfloat16*)p, v);
  else load8((const float*)p, v);
}

// v rounded to X's values (a no-op for fp32).
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// One level of v: clamp(rint(v / safe), -127, 127) as the plain version's
// ops give it on the card (a NaN stays NaN through clamp and casts to 0).
__device__ __forceinline__ uint32_t level(float v, float safe) {
  const float r = rintf(__fdiv_rn(v, safe));
  if (r != r) return 0u;
  return (uint32_t)(int)fminf(fmaxf(r, -127.0f), 127.0f) & 0xFFu;
}

// One row a CTA: x [R, D] row-major, D a multiple of 8 with D / 8 <= NV *
// blockDim.x. gamma/beta (the layer norm, ln_bf16 their dtype) or null.
template <typename X, int NV>
__global__ void __launch_bounds__(Q_THREADS)
w8a8_quantize_kernel(const X* __restrict__ x, const void* __restrict__ gamma,
                     const void* __restrict__ beta, int ln_bf16, int8_t* __restrict__ q,
                     float* __restrict__ scale, int D, float eps) {
  __shared__ float red[Q_THREADS / 32];
  const int nvec = D >> 3;
  const size_t base = (size_t)blockIdx.x * D;
  float v[NV][8];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load8(x + base + 8 * i, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[k][e] = 0.0f;
    }
  }
  if (gamma != nullptr) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) s = __fadd_rn(s, v[k][e]);     // pads are 0
    const float mean = __fdiv_rn(block_reduce(s, red, Add()), (float)D);
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (threadIdx.x + k * blockDim.x < nvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(v[k][e], mean);
          ss = __fmaf_rn(d, d, ss);
        }
    const float var = __fdiv_rn(block_reduce(ss, red, Add()), (float)D);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec) {
        float g[8], b[8];
        load8((const unsigned char*)gamma + (size_t)8 * i * (ln_bf16 ? 2 : 4), ln_bf16, g);
        load8((const unsigned char*)beta + (size_t)8 * i * (ln_bf16 ? 2 : 4), ln_bf16, b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[k][e] = round_to(__fmaf_rn(g[e], __fmul_rn(rstd, __fsub_rn(v[k][e], mean)), b[e]),
                             (const X*)nullptr);
      }
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (threadIdx.x + k * blockDim.x < nvec)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = max_nan(fabsf(v[k][e]), m);
  const float amax = block_reduce(m, red, MaxNan());
  const float sc = __fmul_rn(amax, INV127);
  const float safe = sc < 1e-10f ? 1e-10f : sc;           // a NaN stays
  if (threadIdx.x == 0) scale[blockIdx.x] = safe;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      uint2 out;
      out.x = level(v[k][0], safe) | level(v[k][1], safe) << 8 |
              level(v[k][2], safe) << 16 | level(v[k][3], safe) << 24;
      out.y = level(v[k][4], safe) | level(v[k][5], safe) << 8 |
              level(v[k][6], safe) << 16 | level(v[k][7], safe) << 24;
      *(uint2*)(q + base + 8 * i) = out;
    }
  }
}

template <typename X, int NV>
int launch_quantize_nv(const void* x, const void* gamma, const void* beta, int ln_bf16,
                       void* q, void* scale, int R, int D, int threads, float eps,
                       cudaStream_t st) {
  w8a8_quantize_kernel<X, NV><<<R, threads, 0, st>>>(
      (const X*)x, gamma, beta, ln_bf16, (int8_t*)q, (float*)scale, D, eps);
  return (int)cudaGetLastError();
}

template <typename X>
int launch_quantize(const void* x, const void* gamma, const void* beta, int ln_bf16,
                    void* q, void* scale, int R, int D, float eps, cudaStream_t st) {
  const int nvec = D / 8;
  const int threads = nvec >= Q_THREADS ? Q_THREADS : (nvec + 31) / 32 * 32;
  const int nv = (nvec + threads - 1) / threads;
  switch (nv) {
    case 1: return launch_quantize_nv<X, 1>(x, gamma, beta, ln_bf16, q, scale, R, D, threads, eps, st);
    case 2: return launch_quantize_nv<X, 2>(x, gamma, beta, ln_bf16, q, scale, R, D, threads, eps, st);
    case 3: return launch_quantize_nv<X, 3>(x, gamma, beta, ln_bf16, q, scale, R, D, threads, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The int8 product
// ---------------------------------------------------------------------------

constexpr int BM = 128;                   // rows of x8 a CTA (64 a warpgroup)
constexpr int BN = 128;                   // output columns a CTA
constexpr int BK = 128;                   // int8 values a k-slab: a 128-byte row
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int M_THREADS = CONSUMERS + 32; // and the producer warp
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int M_SMEM = STAGES * STAGE + 1024;   // + alignment
constexpr int MAX_MEMBERS = 3;

// One product of a launch: its scales, bias (null or [O], bias_bf16 its
// dtype), residual (null or the output's dtype [M, O]), output and width,
// and the first of its column tiles in the grid (INT_MAX: an unused slot).
struct Member {
  const float* s;
  const void* bias;
  const void* res;
  void* y;
  int O;
  int tile0;
};

struct MmArgs {
  const float* xs;                        // x8's row scales [M]
  Member m[MAX_MEMBERS];
  int n, M, I;
  int out_bf16, bias_bf16, gelu;          // gelu: 0 none, 1 erf, 2 tanh
};

struct MmParams {
  CUtensorMap xmap;                       // x8 [M, I], boxes [128, 128]
  CUtensorMap qmap[MAX_MEMBERS];          // each member's q^T [O, I], boxes [128, 128]
  MmArgs a;
};

// The member whose tiles hold column tile `tile` (selects, no indexing:
// the arguments stay in parameter space), and its index.
__device__ __forceinline__ Member member_of(const MmArgs& a, int tile, int& index) {
  Member mb = a.m[0];
  index = 0;
  if (tile >= a.m[1].tile0) { mb = a.m[1]; index = 1; }
  if (tile >= a.m[2].tile0) { mb = a.m[2]; index = 2; }
  return mb;
}

#define W8A8_R64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define W8A8_R8(d, b)                                                          \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]),  \
      "+r"(d[b + 5]), "+r"(d[b + 6]), "+r"(d[b + 7])
#define W8A8_R64_ARGS(d)                                                       \
  W8A8_R8(d, 0), W8A8_R8(d, 8), W8A8_R8(d, 16), W8A8_R8(d, 24), W8A8_R8(d, 32), \
      W8A8_R8(d, 40), W8A8_R8(d, 48), W8A8_R8(d, 56)

// d[64 x 128] (+)= A[64 x 32] B[32 x 128], int8 in, int32 sums; A and B
// K-major in shared memory. accumulate 0 overwrites d: the sums need no
// zeroing, which would be a non-wgmma definition of the accumulators
// (ptxas then serializes the products).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " W8A8_R64
      ", %64, %65, p;\n}\n"
      : W8A8_R64_ARGS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The producer warp's lane 0: every k-slab of x8 and of the levels into
// its ring slot, once both warpgroups have released the slot's previous
// slab.
__device__ __forceinline__ void produce(int nst, const MmParams& p, const CUtensorMap* qm,
                                        int obase, int mbase, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty) {
  for (int k = 0; k < nst; ++k) {
    const int s = k % STAGES;
    if (k >= STAGES) oh_tma::mbar_wait(&empty[s], (k / STAGES - 1) & 1);
    unsigned char* st = smem + s * STAGE;
    oh_tma::mbar_expect_tx(&full[s], STAGE);
    oh_tma::load_2d(st, &p.xmap, k * BK, mbase, &full[s]);
    oh_tma::load_2d(st + A_BYTES, qm, k * BK, obase, &full[s]);
  }
}

// torch's GELU on the card (ActivationGeluKernel), in fp32 on x.
__device__ __forceinline__ float gelu_erf(float x) {
  const float alpha = (float)M_SQRT1_2;
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(x, alpha))));
}
__device__ __forceinline__ float gelu_tanh(float x) {
  const float beta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
  const float kappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(beta, __fmaf_rn(kappa, cube, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// One output: the int32 sum folded (row scale, column scale, bias), rounded
// to Y, GELU'd and rounded, the residual r added and rounded, as the plain
// ops.
template <typename Y>
__device__ __forceinline__ float finish(int acc, float xs, float s, float b, bool has_bias,
                                        int gelu, bool has_res, float r) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s);
  if (has_bias) v = __fadd_rn(v, b);
  v = round_to(v, (const Y*)nullptr);
  if (gelu == 1) v = round_to(gelu_erf(v), (const Y*)nullptr);
  else if (gelu == 2) v = round_to(gelu_tanh(v), (const Y*)nullptr);
  if (has_res) v = round_to(__fadd_rn(r, v), (const Y*)nullptr);
  return v;
}

// Two adjacent residual values, read-only.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg((const __nv_bfloat162*)p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg((const float2*)p);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(v0, v1);     // exact: v0, v1 are bf16 values
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *(float2*)p = make_float2(v0, v1);
}

__device__ __forceinline__ float bias_at(const void* bias, int bf16, int o) {
  return bf16 ? __bfloat162float(__ldg((const __nv_bfloat16*)bias + o))
              : __ldg((const float*)bias + o);
}

constexpr int JC = 2;                     // 8-column groups whose loads go first (4 spill)

// A CTA: 128 rows of x8 (64 a warpgroup) by 128 output columns of one
// member; a ninth warp keeps the ring full.
template <typename Y>
__global__ void __launch_bounds__(M_THREADS, 2) w8a8_mm_kernel(const __grid_constant__ MmParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float col_s[BN], col_b[BN];  // the tile's column scales and bias
  const MmArgs& a = p.a;
  int mi;
  const Member mb = member_of(a, blockIdx.x, mi);
  const CUtensorMap* qm = mi == 0 ? &p.qmap[0] : mi == 1 ? &p.qmap[1] : &p.qmap[2];
  const int obase = (blockIdx.x - mb.tile0) * BN;
  const int mbase = blockIdx.y * BM;
  const int nst = (a.I + BK - 1) / BK;

  if (threadIdx.x < BN) {
    const int o = obase + threadIdx.x;
    col_s[threadIdx.x] = o < mb.O ? __ldg(mb.s + o) : 0.0f;
    col_b[threadIdx.x] = o < mb.O && mb.bias != nullptr ? bias_at(mb.bias, a.bias_bf16, o)
                                                        : 0.0f;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      oh_tma::mbar_init(&full[s], 1);
      oh_tma::mbar_init(&empty[s], CONSUMERS / 32);   // lane 0 of each consumer warp
    }
    oh_tma::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce(nst, p, qm, obase, mbase, smem, full, empty);
    return;
  }

  const int wg = threadIdx.x >> 7;
  int acc[64];                            // the first product writes them

  for (int j = 0; j < nst; ++j) {
    const int s = j % STAGES;
    oh_tma::mbar_wait(&full[s], (j / STAGES) & 1);
    unsigned char* st = smem + s * STAGE;
    const uint64_t da = oh_tc::sw128_desc(st + wg * (A_BYTES / 2));
    const uint64_t db = oh_tc::sw128_desc(st + A_BYTES);
    oh_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)                // 32 bytes a k-step
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk, j > 0 || kk > 0);
    oh_tc::wgmma_commit();
    wgmma_wait<1>();                      // slab j - 1's products are done
    if (j > 0 && (threadIdx.x & 31) == 0) oh_tma::mbar_arrive(&empty[(j - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4j + 2i + c]: row r0 + 8i, column obase + 8j + 2t + c. The
  // residuals of JC column groups are read before any of their outputs is
  // written: a load behind a store to memory it might alias would wait for
  // it, and each group would pay a round trip to memory.
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = mbase + 64 * wg + 16 * warp + g;
  const float xsr[2] = {r0 < a.M ? __ldg(a.xs + r0) : 0.0f,
                        r0 + 8 < a.M ? __ldg(a.xs + r0 + 8) : 0.0f};
  const bool has_bias = mb.bias != nullptr, has_res = mb.res != nullptr;
  const Y* res = (const Y*)mb.res;
  Y* y = (Y*)mb.y;
#pragma unroll
  for (int jc = 0; jc < BN / 8; jc += JC) {
    float2 r[JC][2];
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const int o = obase + 8 * (jc + jj) + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        r[jj][i] = has_res && o < mb.O && row < a.M ? load_pair(res + (size_t)row * mb.O + o)
                                                     : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const int c = 8 * (jc + jj) + 2 * t, o = obase + c;
      if (o >= mb.O) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= a.M) continue;
        const int k = 4 * (jc + jj) + 2 * i;
        const float v0 = finish<Y>(acc[k], xsr[i], col_s[c], col_b[c], has_bias, a.gelu,
                                   has_res, r[jj][i].x);
        const float v1 = finish<Y>(acc[k + 1], xsr[i], col_s[c + 1], col_b[c + 1], has_bias,
                                   a.gelu, has_res, r[jj][i].y);
        store_pair(y + (size_t)row * mb.O + o, v0, v1);
      }
    }
  }
}

template <typename Y>
int launch_mm_typed(const MmParams& p, int tiles, cudaStream_t st) {
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(w8a8_mm_kernel<Y>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             M_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  const int mblocks = (p.a.M + BM - 1) / BM;
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  w8a8_mm_kernel<Y><<<dim3(tiles, mblocks, 1), M_THREADS, M_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

// A [rows, I] int8 tensor map (I contiguous), boxes of [128, 128].
int int8_map(CUtensorMap* map, const void* base, int rows, int I) {
  const cuuint64_t size[2] = {(cuuint64_t)I, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)I};
  const cuuint32_t box[2] = {BK, 128};
  return oh_tma::encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, size, stride, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

int run_mm(const void* x8, const void* xs, const void* const* q, const void* const* s,
           const void* const* bias, const void* const* res, void* const* y, const int* O,
           int n, int M, int I, int out_bf16, int bias_bf16, int gelu, cudaStream_t st) {
  if (n < 1 || n > MAX_MEMBERS || M < 0 || I <= 0 || I % 32 || gelu < 0 || gelu > 2 ||
      (out_bf16 != 0 && out_bf16 != 1) || (bias_bf16 != 0 && bias_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  MmParams p;
  MmArgs& a = p.a;
  a = {};
  a.xs = (const float*)xs;
  a.n = n;
  a.M = M;
  a.I = I;
  a.out_bf16 = out_bf16;
  a.bias_bf16 = bias_bf16;
  a.gelu = gelu;
  int tiles = 0;
  for (int k = 0; k < MAX_MEMBERS; ++k) {
    if (k >= n) {
      a.m[k] = {nullptr, nullptr, nullptr, nullptr, 0, INT_MAX};
      continue;
    }
    if (O[k] <= 0 || O[k] % 16) return (int)cudaErrorInvalidValue;
    a.m[k] = {(const float*)s[k], bias[k], res[k], y[k], O[k], tiles};
    tiles += (O[k] + BN - 1) / BN;
  }
  if (M == 0) return (int)cudaSuccess;
  int e = int8_map(&p.xmap, x8, M, I);
  if (e) return e;
  for (int k = 0; k < n; ++k) {           // the kernel reads map k < n only
    e = int8_map(&p.qmap[k], q[k], O[k], I);
    if (e) return e;
  }
  return out_bf16 ? launch_mm_typed<__nv_bfloat16>(p, tiles, st)
                  : launch_mm_typed<float>(p, tiles, st);
}

}  // namespace

// x [R, D] (x_bf16: bf16, else fp32) -> q int8 [R, D], scale fp32 [R]; with
// gamma and beta ([D], ln_bf16 their dtype) the row is layer-normed (eps)
// and rounded to x's dtype first. All contiguous and 16-byte aligned; D a
// multiple of 8, at most 6144.
extern "C" int oh_w8a8_quantize(const void* x, const void* gamma, const void* beta, void* q,
                                void* scale, int R, int D, int x_bf16, int ln_bf16, float eps,
                                void* stream) {
  if (R < 0 || D <= 0 || D % 8 || D > Q_MAX_NV * Q_THREADS * 8 || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  return x_bf16 ? launch_quantize<__nv_bfloat16>(x, gamma, beta, ln_bf16, q, scale, R, D, eps, st)
                : launch_quantize<float>(x, gamma, beta, ln_bf16, q, scale, R, D, eps, st);
}

// n (1-3) products of one x8 [M, I] (int8, row scales xs fp32 [M]): member
// k's levels qk are q^T [Ok, I] int8 contiguous (the column-major [I, Ok]),
// scales sk fp32 [Ok], bias bk ([Ok], bias_bf16 its dtype) or null,
// residual rk (the output's dtype [M, Ok]) or null, output yk [M, Ok]
// (out_bf16: bf16, else fp32). gelu: 0 none, 1 erf, 2 tanh. I a multiple
// of 32, each Ok of 16; x8 and the levels 16-byte aligned. The slots past
// n are ignored.
extern "C" int oh_w8a8_mm(const void* x8, const void* xs, const void* q0, const void* s0,
                          const void* b0, const void* r0, void* y0, int O0, const void* q1,
                          const void* s1, const void* b1, const void* r1, void* y1, int O1,
                          const void* q2, const void* s2, const void* b2, const void* r2,
                          void* y2, int O2, int n, int M, int I, int out_bf16, int bias_bf16,
                          int gelu, void* stream) {
  const void* const q[MAX_MEMBERS] = {q0, q1, q2};
  const void* const s[MAX_MEMBERS] = {s0, s1, s2};
  const void* const b[MAX_MEMBERS] = {b0, b1, b2};
  const void* const r[MAX_MEMBERS] = {r0, r1, r2};
  void* const y[MAX_MEMBERS] = {y0, y1, y2};
  const int O[MAX_MEMBERS] = {O0, O1, O2};
  return run_mm(x8, xs, q, s, b, r, y, O, n, M, I, out_bf16, bias_bf16, gelu,
                (cudaStream_t)stream);
}
