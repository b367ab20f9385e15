// Backward of the encoder's non-causal attention, flash style: K7 (dQ) on
// the CUDA cores. K6 (dK, dV) is flash_attention_bwd_tc.cu, on the tensor
// cores.
//
// Replaces _flash_attention_bwd_dq in jax/experimental/pallas/ops/tpu/
// flash_attention.py, which the Pallas library's flash attention runs under
// its custom_vjp when the encoder is differentiated in training
// (openhush_tpu/models/whisper/model.py:_attend_full_flash under
// openhush_tpu/training/train.py:train_step). As there, dQ and dK/dV are
// two kernels, so that no gradient is summed across CTAs: each output row is
// owned by one CTA, with no atomics, and the gradients are the same from
// run to run.
//
// With S = q k^T * Dh^-0.5, P = exp(S - lse) (lse from the forward's
// residual mode, flash_attention.cu) and D = rowsum(o * dO) (computed by the
// caller, as the TPU path computes `di` in XLA), one CTA per (b, h, 64-query
// tile) loops over the key tiles:
//       dP = dO v^T;  dS = P * (dP - D);  dQ += dS k * Dh^-0.5
// Keys at or past Tk are masked by length (the TPU path pads T to 1536 and
// masks with SegmentIds); query rows at or past Tq are not written.
//
// Bound on an H100: operations. At the fine-tune's shape (B=2, 20 heads,
// T=1500, Dh=64) K7 does three T x T x Dh products (S, dP, dQ: 35 GFLOP)
// against 77 MB of fp32 inputs and outputs. This first version runs on the
// fp32 CUDA cores (67 TFLOP/s at most), with the same tiling as the
// forward: 256 threads, each owning a 4x4 block of every 64x64 product,
// every 16-byte shared-memory load feeding four FMAs. It keeps q, dO, the
// key tile's k and v, and dS in shared memory (85 KB), above the 48 KB
// default, so the launch raises the dynamic shared-memory limit. Inputs and
// outputs are read and written through strides, so the [B, T, H*Dh]
// projections and their gradients need no split-heads copy; every sum is
// fp32 whatever the input dtype (fp32 or bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

// Elements between consecutive (b, h, t) of each tensor.
struct BwdStrides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // q, k, v, dO
  long long dqb, dqh, dqt, dkb, dkh, dkt, dvb, dvh, dvt;     // dq, dk, dv
};

constexpr size_t DQ_SMEM = (5 * TILE_FLOATS + 2 * TILE) * sizeof(float);

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// lse and D of query rows [q0, q0+64) into shared memory; rows at or past
// Tq get lse +inf (so P = 0) and D 0, and their lse is never read.
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const float* lse, const float* delta,
                                          long long base, int q0, int Tq) {
  if (threadIdx.x < TILE) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Tq ? lse[base + row] : INFINITY;
    d_s[threadIdx.x] = row < Tq ? delta[base + row] : 0.f;
  }
}

// K7: dQ of 64 queries.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, BwdStrides st, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [query][LD], resident
  float* Os = Qs + TILE_FLOATS;                 // dO, [query][LD], resident
  float* Ks = Os + TILE_FLOATS;                 // [key][LD]
  float* Vs = Ks + TILE_FLOATS;                 // [key][LD]
  float* Ss = Vs + TILE_FLOATS;                 // dS, [query][key]
  float* lse_s = Ss + TILE_FLOATS;              // [query]
  float* d_s = lse_s + TILE;                    // [query]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                      // queries 4*ty..4*ty+3
  const int tx = tid & 15;                      // keys tx+16*j / dims 4*tx..
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  load_tile(Qs, q + b * st.qb + h * st.qh, st.qt, q0, Tq);
  load_tile(Os, dout + b * st.ob + h * st.oh, st.ot, q0, Tq);
  load_rows(lse_s, d_s, lse, delta, ((long long)b * gridDim.y + h) * Tq, q0,
            Tq);

  float dq_acc[4][4];
  zero(dq_acc);

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    load_tile(Ks, kp, st.kt, k0, Tk);
    load_tile(Vs, vp, st.vt, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_dot(s, Qs, Ks, ty, tx);
    tile_dot(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = tx + 16 * j;
        const int qi = 4 * ty + i;
        const float p =
            k0 + ki < Tk ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
        Ss[qi * LD + ki] = p * (dp[i][j] - d_s[qi]);
      }
    __syncthreads();

    tile_matmul(dq_acc, Ss, Ks, ty, tx);        // dQ += dS k
    __syncthreads();                            // before the next tile load
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < Tq) {
      T* dqp = dq + b * st.dqb + h * st.dqh + (long long)row * st.dqt + 4 * tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) store(dqp + c, dq_acc[i][c] * scale);
    }
  }
}

BwdStrides strides_of(const long long* s) {
  return {s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],
          s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13],
          s[14], s[15], s[16], s[17], s[18], s[19], s[20]};
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, const long long* s, float scale,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + TILE - 1) / TILE, H, B);
  flash_bwd_dq_kernel<T><<<grid, THREADS, DQ_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Tq, Tk, strides_of(s), scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Tq,64], k and v [B,H,Tk,64], dout [B,H,Tq,64] and the gradients of
// q, k, v in their shapes, all of one dtype, fp32 (dtype 0) or bf16 (dtype
// 1), addressed through `strides` in elements: (b, h, t) for q, k, v, dout,
// dq, dk, dv in that order (21 values); the last dim is contiguous, and
// every row starts on a 16-byte boundary. lse and delta are contiguous fp32
// [B, H, Tq]. K7 writes dq (dk's and dv's strides are not read).
extern "C" int oh_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Tq,
    int Tk, const long long* strides, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* d = (const float*)delta;
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, l, d, dq, B, H, Tq, Tk, strides,
                            scale, st);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, B, H, Tq, Tk,
                                    strides, scale, st);
  return (int)cudaErrorInvalidValue;
}
