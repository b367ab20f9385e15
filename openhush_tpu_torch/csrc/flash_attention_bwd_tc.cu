// The backward of the encoder's non-causal attention on the Hopper tensor
// cores at fp32 accuracy: kernel K6 (dK and dV) and kernel K7 (dQ).
//
// Replaces the two TPU kernels that the Pallas library's flash attention
// runs under its custom_vjp when the encoder is differentiated in training
// (openhush_tpu/models/whisper/model.py:_attend_full_flash under
// openhush_tpu/training/train.py:train_step): _flash_attention_bwd_dkv
// (pallas_call :1121) and _flash_attention_bwd_dq (pallas_call :1456) in
// jax/experimental/pallas/ops/tpu/flash_attention.py. With S = q k^T *
// Dh^-0.5, P = exp(S - lse) (lse from K2's residual mode) and D =
// rowsum(o * dO) (computed by the caller, as the TPU path computes `di` in
// XLA):
//   K6, one CTA per (b, h, 128-key tile), looping over the query tiles:
//     S^T = k q^T;  dP^T = v dO^T;  P^T = exp(S^T * Dh^-0.5 - lse);
//     dS^T = P^T * (dP^T - D);  dV += P^T dO;  dK += dS^T q * Dh^-0.5
//   K7, one CTA per (b, h, 128-query tile), looping over the key tiles:
//     S = q k^T;  dP = dO v^T;  P = exp(S * Dh^-0.5 - lse);
//     dS = P * (dP - D);  dQ += dS k * Dh^-0.5
// As on the TPU, dQ and dK/dV are two kernels, so that each CTA writes only
// its own rows: no atomics, the same gradients on every run. Keys at or
// past Tk are masked by length (K6 never writes their rows; K7 takes their
// P as 0); query rows at or past Tq contribute exactly nothing to K6 (their
// lse is taken as +inf, P = 0, and TMA reads their q and dO as zeros) and
// are not written by K7.
//
// Bound on an H100: operations. At the fine-tune's shape (B=2, 20 heads,
// T=1500, Dh=64) K6's four T x T x Dh products are 46 GFLOP (against 92 MB
// of fp32 inputs and outputs), K7's three 35 GFLOP: 0.69 and 0.52 ms on
// the fp32 CUDA cores at their 67 TFLOP/s peak, which the first, CUDA-core
// versions ran at 41% and 39% of. Only the tensor cores go under that; each
// fp32 product is six bf16 partial products of the operands' three bf16
// parts (bf16x3, split.cuh), so 6 x 46 and 6 x 35 GFLOP at the 989 TFLOP/s
// bf16 peak: 0.28 and 0.21 ms. bf16 inputs are one part already, so their
// products take one (s x s) or three (registers x s) partial products. P
// and dS stay fp32 on the CUDA cores and are split in registers.
//
// Design, after FA3's backward:
//   - the split pass (flash_split.cu) first writes the three bf16 parts of
//     q, k, v and dO as contiguous planes into a scratch buffer, once for
//     K6 and K7 together (bf16 inputs skip it and are read in place,
//     through their own strides);
//   - K6: one warp of a producer warpgroup loads the CTA's k and v planes
//     once and keeps a 2-stage TMA ring of query tiles (q and dO planes,
//     128-byte swizzle) ahead of the consumers, with lse and D beside them;
//     two consumer warpgroups own 64 keys each: S^T and dP^T are wgmma
//     m64n64k16 bf16 -> fp32 with keys as M, so P^T and dS^T come out in
//     the accumulator layout; split into three bf16 parts in registers they
//     are the A operands of dV += P^T dO and dK += dS^T q, with q and dO
//     read as MN-major B operands (the descriptor's transpose bit); dK and
//     dV accumulate in registers over every query tile;
//   - K7 is the same with the axes swapped: one thread of a producer
//     warpgroup loads the CTA's q and dO planes once and keeps a 2-stage
//     ring of 64-key tiles (k and v planes); two consumer warpgroups own 64
//     queries each, as wgmma's M: S and dP come out in the accumulator
//     layout, dS split in registers is the A operand of dQ += dS k, with k
//     read as an MN-major B operand (as K2 reads v); dQ accumulates in
//     registers over every key tile.
// Shared memory: K6 48 KB each for k's and v's planes and 48 KB a stage:
// 192 KB; K7 48 KB each for q's and dO's planes and 48 KB a stage: 192 KB;
// one CTA an SM. Registers: a CTA of three warpgroups starts at 168 a
// thread (65536 / 384; a producer of one warp counts as a warpgroup all the
// same); K6's dK, dV, S^T, dP^T and the split fragments of P^T and dS^T
// need more, and so do K7's dQ, S, dP and dS's fragments, so the producer
// warpgroup gives its registers up (setmaxnreg.dec to 40) and the
// consumers take them (setmaxnreg.inc to 232). With 168 for all, ptxas
// spilled 64 bytes in K6 and 100 in K7; with 24 and 240 K6's producer
// spilled 8; with 40 and 232 nothing spills (the build log).
// The tensor cores' fp32 sums of the partial products are not IEEE fp32
// sums in any one order: against the plain version the gradients differ
// by about 1e-5 of their peak at T = 1500 (PERF.md), inside the 1e-4 check.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split.cuh"
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
    product_rs<3, NP>(dV, Pa, desc_o);
    product_rs<3, NP>(dK, dSa, desc_q);
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

// K7: dQ of 128 queries over every key tile. Queries are wgmma's M, so
// q's and dO's planes stay put and k's and v's stream through the ring.
constexpr int DQ_BQ = 128;                    // queries per CTA
constexpr int DQ_BK = 64;                     // keys per tile
constexpr int DQ_PLANE_Q = DQ_BQ * DH * 2;    // one bf16 plane of the q or dO tile
constexpr int DQ_PLANE_K = DQ_BK * DH * 2;    // one bf16 plane of a k or v tile

// Dynamic shared memory for NP planes an operand: q's planes, dO's, then
// STAGES stages of k's planes and v's.
template <int NP> struct DqLayout {
  static constexpr int O = NP * DQ_PLANE_Q;
  static constexpr int RING = 2 * NP * DQ_PLANE_Q;
  static constexpr int STAGE = 2 * NP * DQ_PLANE_K;
  static constexpr int BYTES = RING + STAGES * STAGE + 1024;   // + alignment
};

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o, Slots sq, Slots sk,
                       Slots sv, Slots so, int plane_b, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq, long long dqb,
                       long long dqh, long long dqt, int Tq, int Tk, float scale) {
  using L = DqLayout<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                          // [NP][DQ_BQ][DH], swizzled
  unsigned char* Os = smem + L::O;                   // [NP][DQ_BQ][DH]
  unsigned char* ring = smem + L::RING;              // [STAGES][k, v][NP][DQ_BK][DH]
  __shared__ __align__(8) uint64_t qo_full, full[STAGES], empty[STAGES];

  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Tk + DQ_BK - 1) / DQ_BK;
  if (threadIdx.x == 0) {
    mbar_init(&qo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);          // lane 0 of each warp
    }
    oh_tma::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {                  // one thread of it loads
      mbar_expect_tx(&qo_full, 2 * NP * DQ_PLANE_Q);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(Qs + p * DQ_PLANE_Q, &map_q, sq, q0, h, b + p * plane_b, &qo_full);
        tma_load(Os + p * DQ_PLANE_Q, &map_o, so, q0, h, b + p * plane_b, &qo_full);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        unsigned char* st = ring + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(st + p * DQ_PLANE_K, &map_k, sk, j * DQ_BK, h, b + p * plane_b, &full[s]);
          tma_load(st + (NP + p) * DQ_PLANE_K, &map_v, sv, j * DQ_BK, h, b + p * plane_b,
                   &full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + wg * 64 + 16 * warp + lane / 4;    // and row0 + 8
  const long long rows = ((long long)b * gridDim.y + h) * Tq;   // lse, D of (b, h)
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < Tq;
    lse_r[i] = in ? lse[rows + row0 + 8 * i] : INFINITY;
    d_r[i] = in ? delta[rows + row0 + 8 * i] : 0.f;
  }
  float dQ[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dQ[i] = 0.f;
  uint64_t desc_q[NP], desc_o[NP];                   // this warpgroup's 64 queries
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    desc_q[p] = sw128_desc(Qs + p * DQ_PLANE_Q + wg * (DQ_PLANE_Q / 2));
    desc_o[p] = sw128_desc(Os + p * DQ_PLANE_Q + wg * (DQ_PLANE_Q / 2));
  }
  mbar_wait(&qo_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* st = ring + s * L::STAGE;
    uint64_t desc_k[NP], desc_v[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      desc_k[p] = sw128_desc(st + p * DQ_PLANE_K);
      desc_v[p] = sw128_desc(st + (NP + p) * DQ_PLANE_K);
    }

    // S = q k^T and dP = dO v^T over the 64 dims, queries as rows.
    float S[32], dP[32];
    fence_regs(S);
    fence_regs(dP);
    wgmma_fence();
    product_ss<NP>(S, desc_q, desc_k);
    product_ss<NP>(dP, desc_o, desc_v);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(S);
    fence_regs(dP);

    // dS = P * (dP - D) in fp32, into S: element 4*jj + 2*i + c is key
    // j*DQ_BK + 8*jj + cq + c of row row0 + 8*i; keys past Tk get P = 0.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = j * DQ_BK + 8 * jj + cq + c < Tk;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * jj + 2 * i + c;
          const float p = in ? expf(S[e] * scale - lse_r[i]) : 0.f;
          S[e] = p * (dP[e] - d_r[i]);
        }
      }
    uint32_t dSa[3][16];
    split_fragment(S, dSa);

    // dQ += dS k over the tile's 64 keys, k's planes as MN-major B.
    fence_regs(dQ);
    wgmma_fence();
    product_rs<3, NP>(dQ, dSa, desc_k);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dQ);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);           // this warp is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < Tq) {
      T* qp = dq + b * dqb + h * dqh + (long long)row * dqt + cq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store2(qp + 8 * jj, dQ[4 * jj + 2 * i] * scale, dQ[4 * jj + 2 * i + 1] * scale);
    }
  }
}

template <typename T, int NP>
int launch_dq(const CUtensorMap* maps, const Slots* sl, int plane_b, const float* lse,
              const float* delta, void* dq, int B, int H, int Tq, int Tk,
              const long long* s, float scale, cudaStream_t stream) {
  const auto kernel = flash_bwd_dq_tc_kernel<T, NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqLayout<NP>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tq + DQ_BQ - 1) / DQ_BQ, H, B);
  kernel<<<grid, THREADS, DqLayout<NP>::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], sl[0], sl[1], sl[2], sl[3], plane_b, lse, delta,
      (T*)dq, s[12], s[13], s[14], Tq, Tk, scale);
  return (int)cudaGetLastError();
}

// The tensor maps of q, k, v and dO, boxes of `box` rows: over the inputs
// themselves for bf16 (dtype 1), over the split pass's planes for fp32.
int make_maps(CUtensorMap* maps, Slots* sl, const void* const* src, const void* planes,
              int B, int H, int Tq, int Tk, const long long* strides, const int* box,
              int dtype) {
  for (int w = 0; w < 4; ++w) {
    const int err =
        dtype == 1 ? make_map(&maps[w], &sl[w], src[w], B, H, (w == 0 || w == 3) ? Tq : Tk,
                              strides + 3 * w, box[w])
                   : plane_map(&maps[w], &sl[w], planes, w, B, H, Tq, Tk, box[w]);
    if (err) return err;
  }
  return 0;
}

bool bad_args(int B, int H, int Tq, int Tk, int dtype, const void* planes) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B > 65535 || H > 65535 || dtype < 0 ||
         dtype > 1 || (dtype == 0 && planes == nullptr);
}

}  // namespace

// The two entry points below take q [B,H,Tq,64], k and v [B,H,Tk,64], dout
// [B,H,Tq,64] and the gradients of q, k, v in their shapes, all of one
// dtype, fp32 (dtype 0) or bf16 (1), addressed through `strides` in
// elements: (b, h, t) for q, k, v, dout, dq, dk, dv in that order (21
// values); the last dim is contiguous, and every row starts on a 16-byte
// boundary. lse and delta are contiguous fp32 [B, H, Tq]. `planes`: for
// fp32, the split pass's buffer of q, k, v and dout
// (oh_flash_attention_split), which the kernels read instead of the
// inputs; null for bf16, which is read in place.

// K6: dk and dv (dq's strides are not read).
extern "C" int oh_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* planes, int B,
    int H, int Tq, int Tk, const long long* strides, float scale, int dtype, void* stream) {
  if (bad_args(B, H, Tq, Tk, dtype, planes)) return (int)cudaErrorInvalidValue;
  const void* src[4] = {q, k, v, dout};
  const int box[4] = {BQ, BK, BK, BQ};
  CUtensorMap maps[4];
  Slots sl[4];
  const int err = make_maps(maps, sl, src, planes, B, H, Tq, Tk, strides, box, dtype);
  if (err) return err;
  const float* l = (const float*)lse;
  const float* d = (const float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16, 1>(maps[0], maps[1], maps[2], maps[3], sl, 0, l, d, dk,
                                        dv, B, H, Tq, Tk, strides, scale, st);
  return launch_dkv<float, 3>(maps[0], maps[1], maps[2], maps[3], sl, B, l, d, dk, dv, B, H,
                              Tq, Tk, strides, scale, st);
}

// K7: dq (dk's and dv's strides are not read).
extern "C" int oh_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* planes, int B, int H,
    int Tq, int Tk, const long long* strides, float scale, int dtype, void* stream) {
  if (bad_args(B, H, Tq, Tk, dtype, planes)) return (int)cudaErrorInvalidValue;
  const void* src[4] = {q, k, v, dout};
  const int box[4] = {DQ_BQ, DQ_BK, DQ_BK, DQ_BQ};
  CUtensorMap maps[4];
  Slots sl[4];
  const int err = make_maps(maps, sl, src, planes, B, H, Tq, Tk, strides, box, dtype);
  if (err) return err;
  const float* l = (const float*)lse;
  const float* d = (const float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_dq<__nv_bfloat16, 1>(maps, sl, 0, l, d, dq, B, H, Tq, Tk, strides, scale,
                                       st);
  return launch_dq<float, 3>(maps, sl, B, l, d, dq, B, H, Tq, Tk, strides, scale, st);
}
