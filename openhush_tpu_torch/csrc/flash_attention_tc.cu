// Non-causal multi-head attention for the Whisper encoder on the Hopper
// tensor cores: kernel K2, in bf16 (inference) and in fp32 (training and
// fp32 inference), with its entry point oh_flash_attention.
//
// Replaces the TPU kernel that openhush_tpu/models/whisper/model.py:158
// _attend_full_flash calls (jax.experimental.pallas.ops.tpu.flash_attention,
// flash_attention.py:589, pallas_call :758). Same function as model._attend:
// softmax(q k^T * Dh^-0.5) v with an fp32 softmax, for Dh = 64. Keys at or
// past Tk are masked by length.
//
// Bound on an H100: operations. At large-v3 (B=1, 20 heads, T=1500) a bf16
// call is 4*T*T*Dh*H = 11.5 GFLOP against 15 MB of q, k, v and output:
// 0.0116 ms at the 989 TFLOP/s bf16 peak, 0.0046 ms of bytes. So the [T, T]
// scores never reach memory and both products run on the tensor cores:
//   - one CTA per (batch, head, 128-query tile); two consumer warpgroups own
//     64 query rows each, one producer warp issues the loads;
//   - TMA copies the q tile once and each 64-key tile of k and v into a
//     ring in shared memory (128-byte swizzle), with full/empty mbarriers,
//     so loads run ahead of the products; rows past T come in as zeros. The
//     tensor maps are 4-D (d, h, t, b) over the tensors' own strides, so the
//     [B, T, H*Dh] projections need no split-heads copy;
//   - S = q k^T is wgmma.m64n64k16 bf16 -> fp32, q and k both K-major from
//     shared memory; the online softmax (running max and sum per row, fp32,
//     exp2 of scores pre-scaled by Dh^-0.5 * log2 e) runs on S's registers;
//   - P, unnormalised, is wgmma's A operand from registers for O += P v,
//     with v read as an MN-major B operand (the descriptor's transpose
//     bit): P never goes to shared memory;
//   - at the end O / l is stored through the output's strides.
//
// fp32 inputs (NP = 3) take the same kernel at fp32 accuracy (bf16x3,
// split.cuh; plain TF32 would miss the reference's fp32 by ~1e-3): the
// split pass (flash_split.cu) first writes q's, k's and v's three bf16
// parts as planes, which TMA loads as it loads bf16 inputs; S is six
// partial products, P is split in registers into three A fragments, and
// O += P v is six more. Six times the operations: 0.140 ms at the bf16
// peak at the fine-tune's B=2, against 0.344 ms for the same function on
// the fp32 CUDA cores. The q planes of a tile take 48 KB and a stage of k
// and v planes 48 KB, so two stages make 144 KB, one CTA an SM; bf16
// keeps three 16 KB stages and two CTAs an SM.
//
// Numerics against the reference: in bf16 the reference rounds the
// normalised probabilities to bf16 before the value product; here the
// unnormalised ones are rounded (relative to the running max of their key
// tile) and the 1/l comes after the fp32 sum: the same relative rounding,
// 2^-9. In fp32 the six partial products leave out terms of about 2^-24
// of each product, and the tensor cores' fp32 sums are not IEEE sums in
// one order (~1e-6 of the output's scale).
//
// Residual mode (training): given an `lse` pointer, each query row's
// log-sum-exp of the scaled scores, m + log l (natural log), is written as
// fp32 [B, H, Tq], which K6 and K7 (flash_attention_bwd_tc.cu) read.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using oh_tma::mbar_arrive;
using oh_tma::mbar_expect_tx;
using oh_tma::mbar_init;
using oh_tma::mbar_wait;
using namespace oh_tc;

constexpr int BQ = 128;                       // queries per CTA
constexpr int BK = 64;                        // keys per tile
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int Q_PLANE = BQ * DH * 2;          // one bf16 plane of the q tile
constexpr int KV_PLANE = BK * DH * 2;         // one bf16 plane of a k or v tile

// NP bf16 planes an operand: 1 for bf16 inputs (read in place), 3 for fp32
// (the split pass's parts). Shared memory: q's planes, then STAGES stages
// of k's planes, then STAGES of v's.
template <int NP> struct Fwd {
  using T = std::conditional_t<NP == 1, __nv_bfloat16, float>;
  static constexpr int STAGES = NP == 1 ? 3 : 2;
  static constexpr int CTAS = NP == 1 ? 2 : 1;          // per SM
  static constexpr int Q_BYTES = NP * Q_PLANE;
  static constexpr int KV_BYTES = NP * KV_PLANE;        // k (or v) of a stage
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment
};

// Plane p of batch row b is batch row b + p * plane_b of each tensor map.
// S's accumulator registers become P's A fragment (wgmma.cuh has the layout).
template <int NP>
__global__ void __launch_bounds__(THREADS, Fwd<NP>::CTAS)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, Slots sq,
                          Slots sk, Slots sv, int plane_b,
                          typename Fwd<NP>::T* __restrict__ o, long long ob,
                          long long oh, long long ot, float* __restrict__ lse, int Tq,
                          int Tk, float scale_log2) {
  using F = Fwd<NP>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                          // [NP][BQ][DH], swizzled
  unsigned char* Ks = smem + F::Q_BYTES;             // [STAGES][NP][BK][DH]
  unsigned char* Vs = Ks + STAGES * F::KV_BYTES;     // [STAGES][NP][BK][DH]
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Tk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);          // lane 0 of each warp
    }
    oh_tma::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                    // the producer warp
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&q_full, F::Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(Qs + p * Q_PLANE, &map_q, sq, q0, h, b + p * plane_b, &q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * F::KV_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(Ks + s * F::KV_BYTES + p * KV_PLANE, &map_k, sk, j * BK, h,
                   b + p * plane_b, &full[s]);
          tma_load(Vs + s * F::KV_BYTES + p * KV_PLANE, &map_v, sv, j * BK, h,
                   b + p * plane_b, &full[s]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int cq = 2 * (lane % 4);
  float S[32], O[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) O[i] = 0.f;
  uint64_t dq[NP];                                   // this warpgroup's 64 queries
#pragma unroll
  for (int p = 0; p < NP; ++p) dq[p] = sw128_desc(Qs + p * Q_PLANE + wg * (Q_PLANE / 2));
  mbar_wait(&q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    uint64_t dk[NP], dv[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      dk[p] = sw128_desc(Ks + s * F::KV_BYTES + p * KV_PLANE);
      dv[p] = sw128_desc(Vs + s * F::KV_BYTES + p * KV_PLANE);
    }

    // S = q k^T over the 64 dims: 4 k-steps of 32 bytes inside the swizzle,
    // for each partial product.
    fence_regs(S);
    wgmma_fence();
    product_ss<NP>(S, dq, dk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(S);

    // Online softmax on the registers: each row's 64 keys lie on 4 lanes.
    const int kbase = j * BK + cq;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = S[4 * jj + 2 * i + c];
          x = (kbase + 8 * jj + c < Tk) ? x * scale_log2 : -INFINITY;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // Every key tile holds key j*BK < Tk, so the new max is finite.
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];                              // this lane's part of l
    }
    uint32_t P[NP][16];                              // bf16: P rounded; fp32: split
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(S[4 * jj + 2 * i] - m[i]);
        const float p1 = exp2f(S[4 * jj + 2 * i + 1] - m[i]);
        l[i] += p0 + p1;
        if constexpr (NP == 1) {
          P[0][2 * jj + i] = pack_bf16(p0, p1);
        } else {
          S[4 * jj + 2 * i] = p0;
          S[4 * jj + 2 * i + 1] = p1;
        }
        O[4 * jj + 2 * i] *= alpha[i];
        O[4 * jj + 2 * i + 1] *= alpha[i];
      }
    if constexpr (NP == 3) split_fragment(S, P);

    // O += P v over the 64 keys: 4 k-steps of 16 keys (2048 B of a v plane
    // each), for each partial product.
    fence_regs(O);
    wgmma_fence();
    product_rs<NP, NP>(O, P, dv);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(O);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);           // this warp is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + wg * 64 + 16 * warp + lane / 4 + 8 * i;
    if (row < Tq) {
      const float inv = 1.f / l[i];
      typename F::T* op = o + b * ob + h * oh + (long long)row * ot + cq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store2(op + 8 * jj, O[4 * jj + 2 * i] * inv, O[4 * jj + 2 * i + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * gridDim.y + h) * Tq + row] =
            (m[i] + log2f(l[i])) * 0.69314718055994531f;
    }
  }
}

template <int NP>
int launch(const CUtensorMap* maps, const Slots* sl, int plane_b, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* s, float scale,
           cudaStream_t stream) {
  const auto kernel = flash_attention_tc_kernel<NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<NP>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, Fwd<NP>::BYTES, stream>>>(
      maps[0], maps[1], maps[2], sl[0], sl[1], sl[2], plane_b,
      (typename Fwd<NP>::T*)o, s[9], s[10], s[11], lse, Tq, Tk,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Tq,64], k and v [B,H,Tk,64], o [B,H,Tq,64], all of one dtype, fp32
// (dtype 0) or bf16 (dtype 1), addressed through `strides` in elements: (b,
// h, t) for q, k, v, o in that order; the last dim is contiguous, and every
// row starts on a 16-byte boundary. `lse` is null, or a contiguous fp32
// [B, H, Tq] buffer for the per-row log-sum-exp (residual mode). `planes`:
// for fp32, the split pass's buffer of q, k and v (oh_flash_attention_split
// with dout null), which the kernel reads instead of q, k, v; null for
// bf16, which is read in place.
extern "C" int oh_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* planes, int B, int H, int Tq,
                                  int Tk, const long long* strides, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B > 65535 || H > 65535 || dtype < 0 ||
      dtype > 1 || (dtype == 0 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* src[3] = {q, k, v};
  const int box[3] = {BQ, BK, BK};
  CUtensorMap maps[3];
  Slots sl[3];
  for (int w = 0; w < 3; ++w) {
    const int err =
        dtype == 1 ? make_map(&maps[w], &sl[w], src[w], B, H, w == 0 ? Tq : Tk,
                              strides + 3 * w, box[w])
                   : plane_map(&maps[w], &sl[w], planes, w, B, H, Tq, Tk, box[w]);
    if (err) return err;
  }
  if (dtype == 1)
    return launch<1>(maps, sl, 0, o, (float*)lse, B, H, Tq, Tk, strides, scale, st);
  return launch<3>(maps, sl, B, o, (float*)lse, B, H, Tq, Tk, strides, scale, st);
}
