// dK and dV of the encoder's non-causal attention on the Hopper tensor
// cores at fp32 accuracy: kernel K6.
//
// Replaces the TPU kernel that the Pallas library's flash attention runs
// under its custom_vjp when the encoder is differentiated in training
// (openhush_tpu/models/whisper/model.py:_attend_full_flash under
// openhush_tpu/training/train.py:train_step): _flash_attention_bwd_dkv in
// jax/experimental/pallas/ops/tpu/flash_attention.py (pallas_call :1121).
// With S = q k^T * Dh^-0.5, P = exp(S - lse) (lse from K2's residual mode)
// and D = rowsum(o * dO) (computed by the caller, as the TPU path computes
// `di` in XLA), one CTA per (b, h, 128-key tile) loops over the query tiles:
//   S^T = k q^T;  dP^T = v dO^T;  P^T = exp(S^T * Dh^-0.5 - lse);
//   dS^T = P^T * (dP^T - D);  dV += P^T dO;  dK += dS^T q * Dh^-0.5
// Each CTA writes only its own keys' rows: no atomics, the same gradients
// on every run. Keys at or past Tk are masked by length (their rows are
// never written); query rows at or past Tq contribute exactly nothing:
// their lse is taken as +inf (P = 0), and TMA reads their q and dO as zeros.
//
// Bound on an H100: operations. At the fine-tune's shape (B=2, 20 heads,
// T=1500, Dh=64) the four T x T x Dh products are 46 GFLOP against 92 MB of
// fp32 inputs and outputs: 0.69 ms on the fp32 CUDA cores at their 67
// TFLOP/s peak, which the first, CUDA-core version ran at 41% of. Only
// the tensor cores go under that, and they take fp32 only
// as TF32 (10-bit mantissa, ~1e-3 relative a product: not the reference's
// fp32). So each fp32 operand is split into three bf16 parts, x = x1 + x2 +
// x3 (each part the bf16 rounding of what the earlier parts leave, exact in
// fp32), and a product takes the six partial products whose parts sum to
// at most the third (x1y1, x1y2, x2y1, x1y3, x2y2, x3y1, smallest first)
// with fp32 sums: the way XLA computes Precision.HIGHEST on the TPU's bf16
// matrix unit. 6 x 46 GFLOP at the 989 TFLOP/s bf16 peak is 0.28 ms. bf16
// inputs are one part already, so their products take one (s x s) or three
// (registers x s) partial products. P and dS stay fp32 on the CUDA cores
// and are split in registers.
//
// Design, after FA3's backward:
//   - a split pass (split_planes_kernel) first writes the three bf16 parts
//     of q, k, v and dO as contiguous planes into a scratch buffer (bf16
//     inputs skip it and are read in place, through their own strides);
//   - one warp of a producer warpgroup loads the CTA's k and v planes once
//     and keeps a 2-stage TMA ring of query tiles (q and dO planes, 128-byte
//     swizzle) ahead of the consumers, with lse and D beside them;
//   - two consumer warpgroups own 64 keys each: S^T and dP^T are wgmma
//     m64n64k16 bf16 -> fp32 with keys as M, so P^T and dS^T come out in the
//     accumulator layout; split into three bf16 parts in registers they are
//     the A operands of dV += P^T dO and dK += dS^T q, with q and dO read as
//     MN-major B operands (the descriptor's transpose bit);
//   - dK and dV accumulate in registers over every query tile.
// Shared memory: 48 KB each for k's and v's planes, 48 KB a stage: 192 KB,
// one CTA an SM. Registers: a CTA of three warpgroups starts at 168 a
// thread (65536 / 384); dK, dV, S^T, dP^T and the split fragments of P^T
// and dS^T need more, so the producer warpgroup gives its registers up
// (setmaxnreg.dec to 40) and the consumers take them (setmaxnreg.inc to
// 232). With 168 for all, ptxas spilled 64 bytes; with 24 and 240 the
// producer spilled 8; with 40 and 232 nothing spills (the build log).
// The tensor cores' fp32 sums of the partial products are not IEEE fp32
// sums in any one order: against the plain version the gradients differ
// by about 1e-5 of their peak at T = 1500 (PERF.md), inside K6's 1e-4.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using oh_tma::mbar_arrive;
using oh_tma::mbar_expect_tx;
using oh_tma::mbar_init;
using oh_tma::mbar_wait;
using namespace oh_tc;

constexpr int BK = 128;                       // keys per CTA
constexpr int BQ = 64;                        // queries per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 128;      // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;             // setmaxnreg: the producer's
constexpr int CONSUMER_REGS = 232;            // registers go to the consumers
constexpr int PLANE_Q = BQ * DH * 2;          // one bf16 plane of a q or dO tile
constexpr int PLANE_K = BK * DH * 2;          // one bf16 plane of a k or v tile

// Dynamic shared memory for NP planes an operand: k's planes, v's, then
// STAGES stages of q's planes and dO's.
template <int NP> struct Layout {
  static constexpr int V = NP * PLANE_K;
  static constexpr int RING = 2 * NP * PLANE_K;
  static constexpr int STAGE = 2 * NP * PLANE_Q;
  static constexpr int BYTES = RING + STAGES * STAGE + 1024;   // + alignment
};

// The partial products of an A of NA parts and a B of NB parts (3 or 1),
// smallest first: every pair whose parts sum to at most the third. Pair i
// is (part_a, part_b); 3 x 3: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0);
// 3 x 1: (2,0) (1,0) (0,0); 1 x 1: (0,0).
__host__ __device__ constexpr int n_pairs(int na, int nb) {
  return na == 3 ? 3 * nb - 3 * (nb == 3) : 1;
}
__host__ __device__ constexpr int part_a(int na, int nb, int i) {
  return na == 1 ? 0 : nb == 1 ? 2 - i : i < 3 ? 2 - i : i == 3 ? 1 : 0;
}
__host__ __device__ constexpr int part_b(int nb, int i) {
  return nb == 1 ? 0 : i < 3 ? i : i == 4 ? 1 : 0;
}

// x = hi + mid + lo, each the bf16 rounding of what the earlier parts leave
// (each remainder is exact in fp32).
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// A [64 x 64] accumulator's three bf16 parts as wgmma A fragments.
__device__ __forceinline__ void split_fragment(const float (&d)[32], uint32_t (&a)[3][16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_bfloat162 part[3];
    split3(d[2 * i], part[0].x, part[1].x, part[2].x);
    split3(d[2 * i + 1], part[0].y, part[1].y, part[2].y);
#pragma unroll
    for (int p = 0; p < 3; ++p) a[p][i] = *reinterpret_cast<const uint32_t*>(&part[p]);
  }
}

// d = sum of the partial products of A [64 x 64] (NP planes, K-major, at
// da[p]) and B^T (NP planes, K-major rows of B, at db[p]): 4 k-steps each.
template <int NP>
__device__ __forceinline__ void product_ss(float (&d)[32], const uint64_t (&da)[NP],
                                           const uint64_t (&db)[NP]) {
#pragma unroll
  for (int i = 0; i < n_pairs(NP, NP); ++i)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(d, da[part_a(NP, NP, i)] + 2 * kk, db[part_b(NP, i)] + 2 * kk, i + kk);
}

// d += sum of the partial products of A (three parts in registers) and B
// (NP planes, MN-major, at db[p]) over the 64 queries: 4 k-steps each.
template <int NP>
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[3][16],
                                           const uint64_t (&db)[NP]) {
#pragma unroll
  for (int i = 0; i < n_pairs(3, NP); ++i)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(d, a[part_a(3, NP, i)] + 4 * kk, db[part_b(NP, i)] + 128 * kk);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float x, float y);
template <> __device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                                  float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// Plane p of batch row b is batch row b + p * B of each tensor map (B = 0
// for bf16 inputs, read in place).
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o, Slots sq, Slots sk,
                        Slots sv, Slots so, int plane_b, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, long long dkb, long long dkh, long long dkt,
                        long long dvb, long long dvh, long long dvt, int Tq, int Tk,
                        float scale) {
  using L = Layout<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = smem;                          // [NP][BK][DH], swizzled
  unsigned char* Vs = smem + L::V;                   // [NP][BK][DH]
  unsigned char* ring = smem + L::RING;              // [STAGES][q, dO][NP][BQ][DH]
  __shared__ float lse_s[STAGES][BQ], d_s[STAGES][BQ];
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Tq + BQ - 1) / BQ;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;   // lse, D of (b, h)
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                       // every producer lane
      mbar_init(&empty[s], CONSUMERS / 32);          // lane 0 of each warp
    }
    oh_tma::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= CONSUMERS + 32) return;       // one warp of it loads
    const int lane = threadIdx.x - CONSUMERS;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * NP * PLANE_K);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(Ks + p * PLANE_K, &map_k, sk, k0, h, b + p * plane_b, &kv_full);
        tma_load(Vs + p * PLANE_K, &map_v, sv, k0, h, b + p * plane_b, &kv_full);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, q0 = j * BQ;
      if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
      // Each lane's lse and D stores are released by its own arrival.
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < Tq;
        lse_s[s][i] = in ? lse[rows + q0 + i] : INFINITY;
        d_s[s][i] = in ? delta[rows + q0 + i] : 0.f;
      }
      if (lane == 0) {
        unsigned char* st = ring + s * L::STAGE;
        mbar_expect_tx(&full[s], 2 * NP * PLANE_Q);  // (this lane's arrival)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(st + p * PLANE_Q, &map_q, sq, q0, h, b + p * plane_b, &full[s]);
          tma_load(st + (NP + p) * PLANE_Q, &map_o, so, q0, h, b + p * plane_b, &full[s]);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int cq = 2 * (lane % 4);
  float dK[32], dV[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dK[i] = dV[i] = 0.f;
  uint64_t desc_k[NP], desc_v[NP];                   // this warpgroup's 64 keys
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    desc_k[p] = sw128_desc(Ks + p * PLANE_K + wg * (PLANE_K / 2));
    desc_v[p] = sw128_desc(Vs + p * PLANE_K + wg * (PLANE_K / 2));
  }
  mbar_wait(&kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* st = ring + s * L::STAGE;
    uint64_t desc_q[NP], desc_o[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      desc_q[p] = sw128_desc(st + p * PLANE_Q);
      desc_o[p] = sw128_desc(st + (NP + p) * PLANE_Q);
    }

    // S^T = k q^T and dP^T = v dO^T over the 64 dims, keys as rows.
    float S[32], dP[32];
    fence_regs(S);
    fence_regs(dP);
    wgmma_fence();
    product_ss<NP>(S, desc_k, desc_q);
    product_ss<NP>(dP, desc_v, desc_o);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(S);
    fence_regs(dP);

    // P^T and dS^T in fp32: element 4*jj + 2*i + c is query 8*jj + cq + c.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = 8 * jj + cq + c;
        const float l = lse_s[s][qi], dd = d_s[s][qi];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * jj + 2 * i + c;
          const float p = expf(S[e] * scale - l);
          S[e] = p;
          dP[e] = p * (dP[e] - dd);
        }
      }
    uint32_t Pa[3][16], dSa[3][16];
    split_fragment(S, Pa);
    split_fragment(dP, dSa);

    // dV += P^T dO and dK += dS^T q over the tile's 64 queries.
    fence_regs(dV);
    fence_regs(dK);
    wgmma_fence();
    product_rs<NP>(dV, Pa, desc_o);
    product_rs<NP>(dK, dSa, desc_q);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dV);
    fence_regs(dK);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);           // this warp is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wg * 64 + 16 * warp + lane / 4 + 8 * i;
    if (row < Tk) {
      T* kp = dk + b * dkb + h * dkh + (long long)row * dkt + cq;
      T* vp = dv + b * dvb + h * dvh + (long long)row * dvt + cq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        store2(kp + 8 * jj, dK[4 * jj + 2 * i] * scale, dK[4 * jj + 2 * i + 1] * scale);
        store2(vp + 8 * jj, dV[4 * jj + 2 * i], dV[4 * jj + 2 * i + 1]);
      }
    }
  }
}

// The three bf16 parts of four fp32 [B, H, T, 64] tensors (q, k, v, dO,
// read through their (b, h, t) strides) as contiguous [3 * B, H, T, 64]
// planes: part p of batch row b is row b + p * B. Four values a thread step.
struct SplitArgs {
  const float* src[4];
  long long sb[4], sh[4], st[4];
  int T[4];
  __nv_bfloat16* dst[4];
};

__global__ void split_planes_kernel(SplitArgs a, int B, int H) {
  const int w = blockIdx.y;
  const int T = a.T[w];
  const long long n = (long long)B * H * T * (DH / 4);
  const long long plane = (long long)B * H * T * DH;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i % (DH / 4));
    const long long r = i / (DH / 4);
    const int t = (int)(r % T);
    const int hh = (int)((r / T) % H), bb = (int)(r / ((long long)T * H));
    const float4 x = *reinterpret_cast<const float4*>(
        a.src[w] + bb * a.sb[w] + hh * a.sh[w] + t * a.st[w] + 4 * g);
    __nv_bfloat162 part[3][2];
    split3(x.x, part[0][0].x, part[1][0].x, part[2][0].x);
    split3(x.y, part[0][0].y, part[1][0].y, part[2][0].y);
    split3(x.z, part[0][1].x, part[1][1].x, part[2][1].x);
    split3(x.w, part[0][1].y, part[1][1].y, part[2][1].y);
    __nv_bfloat16* out = a.dst[w] + r * DH + 4 * g;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(out + p * plane) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&part[p][0]),
                     *reinterpret_cast<const uint32_t*>(&part[p][1]));
  }
}

template <typename T, int NP>
int launch_dkv(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const CUtensorMap& mo, const Slots* sl, int plane_b, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
               const long long* s, float scale, cudaStream_t stream) {
  const auto kernel = flash_bwd_dkv_tc_kernel<T, NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<NP>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tk + BK - 1) / BK, H, B);
  kernel<<<grid, THREADS, Layout<NP>::BYTES, stream>>>(
      mq, mk, mv, mo, sl[0], sl[1], sl[2], sl[3], plane_b, lse, delta, (T*)dk, (T*)dv, s[15],
      s[16], s[17], s[18], s[19], s[20], Tq, Tk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. q [B,H,Tq,64], k and v [B,H,Tk,64], dout [B,H,Tq,64], dk and dv in
// k's and v's shapes, all of one dtype, fp32 (dtype 0) or bf16 (1),
// addressed through `strides` in elements: (b, h, t) for q, k, v, dout, dq,
// dk, dv in that order (21 values; dq's are not read); the last dim is
// contiguous, and every row starts on a 16-byte boundary. lse and delta are
// contiguous fp32 [B, H, Tq]. `planes`: for fp32, bf16 scratch of
// 6 * B * H * 64 * (Tq + Tk) elements that takes the three parts of q, k, v
// and dO; null for bf16.
extern "C" int oh_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* planes, int B, int H,
    int Tq, int Tk, const long long* strides, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B > 65535 || H > 65535 || dtype < 0 ||
      dtype > 1 || (dtype == 0 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)lse;
  const float* d = (const float*)delta;
  const void* src[4] = {q, k, v, dout};
  const int T[4] = {Tq, Tk, Tk, Tq};
  const int box[4] = {BQ, BK, BK, BQ};
  CUtensorMap maps[4];
  Slots sl[4];
  if (dtype == 1) {                                  // bf16: one part, in place
    for (int w = 0; w < 4; ++w) {
      const int err = make_map(&maps[w], &sl[w], src[w], B, H, T[w], strides + 3 * w, box[w]);
      if (err) return err;
    }
    return launch_dkv<__nv_bfloat16, 1>(maps[0], maps[1], maps[2], maps[3], sl, 0, l, d, dk,
                                        dv, B, H, Tq, Tk, strides, scale, st);
  }
  SplitArgs a;
  __nv_bfloat16* next = (__nv_bfloat16*)planes;
  for (int w = 0; w < 4; ++w) {
    a.src[w] = (const float*)src[w];
    a.sb[w] = strides[3 * w];
    a.sh[w] = strides[3 * w + 1];
    a.st[w] = strides[3 * w + 2];
    a.T[w] = T[w];
    a.dst[w] = next;
    next += 3LL * B * H * T[w] * DH;
    const long long contiguous[3] = {(long long)H * T[w] * DH, (long long)T[w] * DH, DH};
    const int err = make_map(&maps[w], &sl[w], a.dst[w], 3 * B, H, T[w], contiguous, box[w]);
    if (err) return err;
  }
  const long long most = (long long)B * H * (Tq > Tk ? Tq : Tk) * (DH / 4);
  const int blocks = (int)((most + 255) / 256 < 132 * 8 ? (most + 255) / 256 : 132 * 8);
  split_planes_kernel<<<dim3(blocks, 4), 256, 0, st>>>(a, B, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dkv<float, 3>(maps[0], maps[1], maps[2], maps[3], sl, B, l, d, dk, dv, B, H,
                              Tq, Tk, strides, scale, st);
}
