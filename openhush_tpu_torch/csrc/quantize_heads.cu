// Per-(row, head) symmetric int8 quantization of a [rows, H*Dh] activation.
//
// Replaces the TPU kernel openhush_tpu/ops/quantize_pallas.py:
// quantize_heads_pallas (body _kernel), which the JAX model reaches through
// models/whisper/model.py:_quantize_heads for the int8 cross-KV cache.
// Same arithmetic, step for step, as the reference's XLA formulation:
//   scale = max|x_h| * (float)(1/127)     (a reciprocal multiply, not a divide)
//   safe  = max(scale, 1e-10)
//   q     = clip(round_half_even(x / safe), -127, 127)   (IEEE divide)
// Built without --use_fast_math, so `/` is the IEEE divide and rintf rounds
// half to even like jnp.round; roundf (half away from zero) would be wrong.
//
// Bound on an H100: bytes. A large-v3 cross-KV tensor [1500, 1280] bf16 reads
// 3.84 MB and writes 1.92 MB of int8 plus 120 KB of scales; the arithmetic is
// a few operations per byte. Design: one warp per (row, head) group, which is
// a contiguous run of Dh values, so a warp's load is one coalesced 128-byte
// line at Dh=64 bf16. The abs-max is a warp shuffle reduction; nothing goes
// through shared memory, and the scales are written unpadded as [rows, H].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_PER_LANE = 4;               // head_dim <= 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
quantize_heads_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s, long long n_groups, int head_dim) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= n_groups) return;                  // whole warp leaves together
  const T* xg = x + g * head_dim;
  float v[MAX_PER_LANE];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < head_dim ? to_f32(xg[d]) : 0.f;
    m = fmaxf(m, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = m * (float)(1.0 / 127.0);
  const float safe = fmaxf(scale, 1e-10f);
  int8_t* qg = q + g * head_dim;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < head_dim) {
      const float r = rintf(v[i] / safe);
      qg[d] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
    }
  }
  if (lane == 0) s[g] = safe;
}

}  // namespace

// x: [n_groups * head_dim] contiguous, fp32 (dtype 0) or bf16 (dtype 1);
// q: int8, same size; s: fp32 [n_groups]. Requires head_dim <= 128.
extern "C" int oh_quantize_heads(const void* x, void* q, void* s,
                                 long long n_groups, int head_dim, int dtype,
                                 void* stream) {
  const unsigned blocks = (unsigned)((n_groups + WARPS - 1) / WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    quantize_heads_kernel<float><<<blocks, WARPS * 32, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)s, n_groups, head_dim);
  else if (dtype == 1)
    quantize_heads_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, n_groups, head_dim);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
