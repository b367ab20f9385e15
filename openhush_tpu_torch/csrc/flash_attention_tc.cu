// Non-causal multi-head attention for the Whisper encoder in bf16, on the
// Hopper tensor cores: the bf16 path of kernel K2 (oh_flash_attention in
// flash_attention.cu dispatches bf16 inputs here).
//
// Replaces the TPU kernel that openhush_tpu/models/whisper/model.py:158
// _attend_full_flash calls (jax.experimental.pallas.ops.tpu.flash_attention,
// flash_attention.py:589, pallas_call :758). Same function as model._attend:
// softmax(q k^T * Dh^-0.5) v with an fp32 softmax, for Dh = 64. Keys at or
// past Tk are masked by length.
//
// Bound on an H100: bf16 operations. At large-v3 (B=1, 20 heads, T=1500) a
// call is 4*T*T*Dh*H = 11.5 GFLOP against 15 MB of q, k, v and output:
// 0.0116 ms at the 989 TFLOP/s bf16 peak, 0.0046 ms of bytes. So the [T, T]
// scores never reach memory and both products run on the tensor cores:
//   - one CTA per (batch, head, 128-query tile); two consumer warpgroups own
//     64 query rows each, one producer warp issues the loads;
//   - TMA copies the q tile once and each 64-key tile of k and v into a
//     3-stage ring in shared memory (128-byte swizzle), with full/empty
//     mbarriers, so loads run ahead of the products; rows past T come in as
//     zeros. The tensor maps are 4-D (d, h, t, b) over the tensors' own
//     strides, so the [B, T, H*Dh] projections need no split-heads copy;
//   - S = q k^T is wgmma.m64n64k16 bf16 -> fp32, q and k both K-major from
//     shared memory; the online softmax (running max and sum per row, fp32,
//     exp2 of scores pre-scaled by Dh^-0.5 * log2 e) runs on S's registers;
//   - P, unnormalised and rounded to bf16 in registers, is wgmma's A
//     operand for O += P v, with v read as an MN-major B operand (the
//     descriptor's transpose bit): P never goes to shared memory;
//   - at the end O / l is stored as bf16 through the output's strides.
// Numerics against the reference: the reference rounds the normalised
// probabilities to bf16 before the value product; here the unnormalised
// ones are rounded (relative to the running max of their key tile) and
// the 1/l comes after the fp32 sum: the same relative rounding, 2^-9.
//
// Residual mode (training): given an `lse` pointer, each query row's
// log-sum-exp of the scaled scores, m + log l, is written as fp32 [B, H, Tq].
//
// The fp32 path of K2 stays on the CUDA-core kernel in flash_attention.cu on
// purpose: the tensor cores would take fp32 only as TF32, and whether TF32
// is acceptable against the reference's fp32 training is an open question.

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

constexpr int BQ = 128;                       // queries per CTA
constexpr int BK = 64;                        // keys per tile
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int Q_BYTES = BQ * DH * 2;
constexpr int KV_BYTES = BK * DH * 2;
constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment

// S's accumulator registers become P's A fragment (wgmma.cuh has the layout).
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, Slots sq,
                          Slots sk, Slots sv, __nv_bfloat16* __restrict__ o,
                          long long ob, long long oh, long long ot,
                          float* __restrict__ lse, int Tq, int Tk, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                          // [BQ][DH], swizzled
  unsigned char* Ks = smem + Q_BYTES;                // [STAGES][BK][DH]
  unsigned char* Vs = Ks + STAGES * KV_BYTES;        // [STAGES][BK][DH]
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
      mbar_expect_tx(&q_full, Q_BYTES);
      tma_load(Qs, &map_q, sq, q0, h, b, &q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        tma_load(Ks + s * KV_BYTES, &map_k, sk, j * BK, h, b, &full[s]);
        tma_load(Vs + s * KV_BYTES, &map_v, sv, j * BK, h, b, &full[s]);
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
  const uint64_t dq = sw128_desc(Qs + wg * (Q_BYTES / 2));
  mbar_wait(&q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const uint64_t dk = sw128_desc(Ks + s * KV_BYTES);
    const uint64_t dv = sw128_desc(Vs + s * KV_BYTES);

    // S = q k^T over the 64 dims: 4 k-steps of 32 bytes inside the swizzle.
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(S, dq + 2 * kk, dk + 2 * kk, kk);
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
    uint32_t P[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(S[4 * jj + 2 * i] - m[i]);
        const float p1 = exp2f(S[4 * jj + 2 * i + 1] - m[i]);
        l[i] += p0 + p1;
        P[2 * jj + i] = pack_bf16(p0, p1);
        O[4 * jj + 2 * i] *= alpha[i];
        O[4 * jj + 2 * i + 1] *= alpha[i];
      }

    // O += P v over the 64 keys: 4 k-steps of 16 keys (2048 B of v each).
    fence_regs(O);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(O, P + 4 * kk, dv + 128 * kk);
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
      __nv_bfloat16* op = o + b * ob + h * oh + (long long)row * ot + cq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(op + 8 * jj) =
            pack_bf16(O[4 * jj + 2 * i] * inv, O[4 * jj + 2 * i + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * gridDim.y + h) * Tq + row] =
            (m[i] + log2f(l[i])) * 0.69314718055994531f;
    }
  }
}

}  // namespace

// The bf16 launch of oh_flash_attention (flash_attention.cu), same
// arguments: strides (b, h, t) of q, k, v, o in elements; rows 16-byte
// aligned; `lse` null or fp32 [B, H, Tq].
int flash_attention_bf16_tc(const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int Tq, int Tk,
                            const long long* s, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  Slots sq, sk, sv;
  int err = make_map(&mq, &sq, q, B, H, Tq, s, BQ);
  if (!err) err = make_map(&mk, &sk, k, B, H, Tk, s + 3, BK);
  if (!err) err = make_map(&mv, &sv, v, B, H, Tk, s + 6, BK);
  if (err) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_tc_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      mq, mk, mv, sq, sk, sv, (__nv_bfloat16*)o, s[9], s[10], s[11], lse, Tq, Tk,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
