// Backward of the encoder's non-causal attention, flash style: K6 (dK, dV)
// and K7 (dQ).
//
// Replaces the two TPU kernels that the Pallas library's flash attention
// runs under its custom_vjp when the encoder is differentiated in training
// (openhush_tpu/models/whisper/model.py:_attend_full_flash under
// openhush_tpu/training/train.py:train_step): _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq in jax/experimental/pallas/ops/tpu/
// flash_attention.py. As there, the work is split in two kernels, so that no
// gradient is summed across CTAs: each output row is owned by one CTA, with
// no atomics, and the gradients are the same from run to run.
//
// With S = q k^T * Dh^-0.5, P = exp(S - lse) (lse from the forward's
// residual mode, flash_attention.cu) and D = rowsum(o * dO) (computed by the
// caller, as the TPU path computes `di` in XLA):
//   K6, one CTA per (b, h, 64-key tile), looping over the query tiles:
//       dV += P^T dO;  dP = dO v^T;  dS = P * (dP - D);  dK += dS^T q * Dh^-0.5
//   K7, one CTA per (b, h, 64-query tile), looping over the key tiles:
//       dQ += dS k * Dh^-0.5
// Keys at or past Tk are masked by length (the TPU path pads T to 1536 and
// masks with SegmentIds); query rows at or past Tq contribute nothing: their
// lse is not read but taken as +inf, so their P is exactly 0.
//
// Bound on an H100: operations. At large-v3 (B=1, 20 heads, T=1500, Dh=64)
// K6 does four T x T x Dh products (S, dP, dV, dK: 8*T*T*Dh*H = 23 GFLOP) and
// K7 three (S, dP, dQ: 17 GFLOP) against 31 MB of fp32 inputs and outputs.
// This first version runs on the fp32 CUDA cores (67 TFLOP/s at most), with
// the same tiling as the forward: 256 threads, each owning a 4x4 block of
// every 64x64 product, every 16-byte shared-memory load feeding four FMAs.
// K6 keeps its k and v tiles, the query tile's q and dO, and P and dS for
// the tile in shared memory (102 KB); K7 keeps q, dO, the key tile's k and v,
// and dS (85 KB): both above the 48 KB default, so the launch raises the
// dynamic shared-memory limit. Tensor cores are later work. Inputs and
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

constexpr size_t DKV_SMEM = (6 * TILE_FLOATS + 2 * TILE) * sizeof(float);
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

// K6: dK and dV of 64 keys.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, BwdStrides st,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [key][LD], resident
  float* Vs = Ks + TILE_FLOATS;                 // [key][LD], resident
  float* Qs = Vs + TILE_FLOATS;                 // [query][LD]
  float* Os = Qs + TILE_FLOATS;                 // dO, [query][LD]
  float* Ps = Os + TILE_FLOATS;                 // P, [key][query]
  float* Ss = Ps + TILE_FLOATS;                 // dS, [key][query]
  float* lse_s = Ss + TILE_FLOATS;              // [query]
  float* d_s = lse_s + TILE;                    // [query]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                      // keys 4*ty..4*ty+3
  const int tx = tid & 15;                      // queries tx+16*j / dims 4*tx..
  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* op = dout + b * st.ob + h * st.oh;
  const long long base = ((long long)b * gridDim.y + h) * Tq;

  load_tile(Ks, k + b * st.kb + h * st.kh, st.kt, k0, Tk);
  load_tile(Vs, v + b * st.vb + h * st.vh, st.vt, k0, Tk);

  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < Tq; q0 += TILE) {
    load_tile(Qs, qp, st.qt, q0, Tq);
    load_tile(Os, op, st.ot, q0, Tq);
    load_rows(lse_s, d_s, lse, delta, base, q0, Tq);
    __syncthreads();

    // S^T and dP^T for this thread's 4 keys x 4 queries. Keys past Tk read
    // as zero rows; their P is not zero, but it only reaches their own dK
    // and dV rows, which are never written.
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_dot(s, Ks, Qs, ty, tx);
    tile_dot(dp, Vs, Os, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float p = expf(s[i][j] * scale - lse_s[qi]);
        Ps[(4 * ty + i) * LD + qi] = p;
        Ss[(4 * ty + i) * LD + qi] = p * (dp[i][j] - d_s[qi]);
      }
    __syncthreads();

    tile_matmul(dv_acc, Ps, Os, ty, tx);        // dV += P^T dO
    tile_matmul(dk_acc, Ss, Qs, ty, tx);        // dK += dS^T q
    __syncthreads();                            // before the next tile load
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row < Tk) {
      T* dkp = dk + b * st.dkb + h * st.dkh + (long long)row * st.dkt + 4 * tx;
      T* dvp = dv + b * st.dvb + h * st.dvh + (long long)row * st.dvt + 4 * tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store(dkp + c, dk_acc[i][c] * scale);
        store(dvp + c, dv_acc[i][c]);
      }
    }
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
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, const long long* s, float scale,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + TILE - 1) / TILE, H, B);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, DKV_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Tq, Tk, strides_of(s), scale);
  return (int)cudaGetLastError();
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
// [B, H, Tq]. K6 writes dk and dv; K7 writes dq.
extern "C" int oh_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Tq, int Tk, const long long* strides, float scale, int dtype,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* d = (const float*)delta;
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, l, d, dk, dv, B, H, Tq, Tk,
                             strides, scale, st);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, B, H, Tq,
                                     Tk, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}

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
