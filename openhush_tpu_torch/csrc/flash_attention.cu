// Non-causal multi-head attention for the Whisper encoder, flash style:
// kernel K2. This file holds its fp32 path, on the CUDA cores, and the
// entry point, which sends bf16 inputs to the tensor-core kernel in
// flash_attention_tc.cu. The fp32 path stays on the CUDA cores on purpose:
// the tensor cores take fp32 only as TF32, and whether TF32 is acceptable
// against the reference's fp32 training is an open question.
//
// Replaces the TPU kernel that openhush_tpu/models/whisper/model.py:
// _attend_full_flash calls (jax.experimental.pallas.ops.tpu.flash_attention,
// full-row blocks from _flash_block). Same function as model._attend:
// softmax(q k^T * Dh^-0.5) v with an fp32 softmax, for Dh = 64 (every
// Whisper size). Keys at or past Tk are masked by length; the TPU kernel
// padded T to a multiple of 128 and masked the pad with SegmentIds instead.
//
// Bound on an H100: operations. At large-v3 (B=1, 20 heads, T=1500) one call
// is 4*T*T*Dh*H = 11.5 GFLOP against 15 MB of q, k, v and output, so the
// [T, T] scores must never reach device memory and the rate to beat is the
// bf16 tensor-core peak (the bf16 kernel's aim). This fp32 kernel keeps the
// scores on chip and computes on the fp32 CUDA cores (67 TFLOP/s, a 0.17 ms
// floor at that size). Design: one CTA per (batch, head,
// 64-query tile); q for the tile and each 64-key tile of k and v are staged
// in shared memory as fp32; the loop over key tiles keeps an online softmax
// (running max and sum per row) in registers. Each of the 256 threads owns a
// 4x4 block of scores (queries 4*ty.., keys tx+16*j) and a 4x4 block of the
// output (queries 4*ty.., dims 4*tx..), so every 16-byte shared-memory load
// feeds four FMAs. The probabilities reuse the key tile's shared memory.
// q, k, v and o are read and written through strides, so the [B, T, H*Dh]
// projections need no split-heads copy.
//
// Residual mode (training): given an `lse` pointer, the kernel also writes
// each query row's log-sum-exp of the scaled scores, m + log l, as fp32
// [B, H, Tq], which the backward kernels (flash_attention_bwd.cu) read.
// This is the counterpart of the TPU kernel's save_residuals mode, which
// keeps m and l apart. Without the pointer nothing else is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

constexpr int BQ = TILE;                      // queries per CTA
constexpr int BK = TILE;                      // keys per tile
constexpr size_t SMEM_BYTES = 3 * TILE_FLOATS * sizeof(float);

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Tq, int Tk, Strides st,
                       float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                     // [BK][LD], then probs [BQ][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;                      // query group: rows 4*ty..4*ty+3
  const int tx = tid & 15;                      // keys tx+16*j / dims 4*tx..
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  load_tile(Qs, qp, st.qt, q0, Tq);

  float m_i[4], l_i[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(Ks, kp, st.kt, k0, Tk);
    load_tile(Vs, vp, st.vt, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_dot(s, Qs, Ks, ty, tx);

    // Every key tile holds key k0 < Tk, so each row max below is finite.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Tk) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 lanes sharing ty
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                            // done reading the key tile
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * LD + tx + 16 * j] = s[i][j];
    __syncthreads();

    tile_matmul(acc, Ps, Vs, ty, tx);
    __syncthreads();                            // before the next tile load
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < Tq) {
      const float inv = 1.f / l_i[i];
      T* op = o + b * st.ob + h * st.oh + (long long)row * st.ot + 4 * tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) store(op + c, acc[i][c] * inv);
      // The 16 lanes of a row hold the same m and l after the shuffles.
      if (lse != nullptr && tx == 0)
        lse[((long long)b * gridDim.y + h) * Tq + row] = m_i[i] + logf(l_i[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* s, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const Strides st = {s[0], s[1], s[2], s[3], s[4], s[5],
                      s[6], s[7], s[8], s[9], s[10], s[11]};
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Tq, Tk, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_attention_bf16_tc(const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int H, int Tq, int Tk,
                            const long long* s, float scale, cudaStream_t stream);

// q [B,H,Tq,64], k and v [B,H,Tk,64], o [B,H,Tq,64], all of one dtype, fp32
// (dtype 0: the CUDA-core kernel here) or bf16 (dtype 1: the tensor-core
// kernel of flash_attention_tc.cu), addressed through `strides` in elements:
// (b, h, t) for q, k, v, o in that order; the last dim is contiguous, and
// every row starts on a 16-byte boundary. `lse` is null, or a contiguous
// fp32 [B, H, Tq] buffer for the per-row log-sum-exp (residual mode).
extern "C" int oh_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Tq,
                                  int Tk, const long long* strides,
                                  float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return launch<float>(q, k, v, o, l, B, H, Tq, Tk, strides, scale, st);
  if (dtype == 1)
    return flash_attention_bf16_tc(q, k, v, o, l, B, H, Tq, Tk, strides, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
