// Per-(row, head) symmetric int8 quantization of [rows, H*Dh] activations,
// one tensor or a layer's cross-attention K and V in one launch.
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
// Bound on an H100: bytes. A large-v3 layer's cross K and V, [1500, 1280]
// bf16 each, read 7.68 MB and write 3.84 MB of int8 plus 240 KB of scales;
// the arithmetic is a few operations per byte. At that size the launch ramp
// and the latency of one memory trip weigh as much as the bytes, so the
// design puts as many bytes in flight as it can and launches once a layer:
// - each lane loads 16 bytes (8 bf16 or 4 fp32), so LPG = Dh * size / 16
//   lanes hold one (row, head) group, padded to P, the next power of two,
//   and a warp covers 32 / P groups a trip (Dh 64 bf16: 8 lanes, 4 groups);
//   the abs-max is log2(P) shuffles inside the group, each lane
//   stores its int8 as one 8- or 4-byte word and the group's first lane the
//   scale;
// - one warp a trip of 32 / P groups, over both tensors: a grid of
//   n_trips / 8 CTAs of 8 warps, each warp one 512-byte load. (A persistent
//   grid of four CTAs an SM, each warp holding four trips and asking for
//   the next four before it reduced these, measured slower: 0.0085 against
//   0.0067 ms a K+V launch on an H100; the IEEE divides and the launch
//   weigh more than the memory trip, and they overlap best spread over
//   more warps);
// - the outputs are written where the caller says: for the cross-KV cache,
//   slice l of the stacked [L, ...] buffers, so nothing is copied after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ void unpack(const uint4& w, float (&v)[4], float) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8],
                                       __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {               // bf16 -> f32 is a 16-bit shift
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t level(float x, float safe) {
  const float r = fminf(fmaxf(rintf(x / safe), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)r;
}

__device__ __forceinline__ void store(int8_t* q, const float (&v)[4],
                                      float safe) {
  *reinterpret_cast<uint32_t*>(q) =
      level(v[0], safe) | level(v[1], safe) << 8 | level(v[2], safe) << 16 |
      level(v[3], safe) << 24;
}

__device__ __forceinline__ void store(int8_t* q, const float (&v)[8],
                                      float safe) {
  uint2 w;
  w.x = level(v[0], safe) | level(v[1], safe) << 8 | level(v[2], safe) << 16 |
        level(v[3], safe) << 24;
  w.y = level(v[4], safe) | level(v[5], safe) << 8 | level(v[6], safe) << 16 |
        level(v[7], safe) << 24;
  *reinterpret_cast<uint2*>(q) = w;
}

struct Pair {                                 // up to two tensors, one launch
  const void *x0, *x1;
  int8_t *q0, *q1;
  float *s0, *s1;
  int n_tensors;
};

// A group is lpg lanes (lpg <= P, P a power of two) of P; each lane loads
// VPL = 16 / sizeof(T) values, the group's last P - lpg lanes none. Warp w
// of the grid takes trip w: groups GPW * (w % trips) onward of tensor
// w / trips.
template <typename T, int P>
__global__ void __launch_bounds__(WARPS * 32)
quantize_heads_kernel(Pair p, long long n_groups, long long trips, int lpg) {
  constexpr int VPL = 16 / sizeof(T);
  constexpr int GPW = 32 / P;                 // groups a warp
  const int head_dim = lpg * VPL;
  const int lane = threadIdx.x & 31;
  const int sub = lane % P;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int which = w >= trips;               // 0: x0, 1: x1
  // Selected, not indexed: an indexed parameter array goes to the stack.
  const T* x = static_cast<const T*>(which ? p.x1 : p.x0);
  const long long g = (w - which * trips) * GPW + lane / P;
  const bool real = which < p.n_tensors && g < n_groups && sub < lpg;

  uint4 word = make_uint4(0, 0, 0, 0);
  if (real)
    word = __ldg(reinterpret_cast<const uint4*>(x + g * head_dim + sub * VPL));
  float v[VPL];
  unpack(word, v, T());
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) m = fmaxf(m, fabsf(v[i]));
  // Every lane takes part (a masked lane with 0); a group's P lanes are
  // aligned, so the xor stays inside the group.
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!real) return;
  const float scale = m * (float)(1.0 / 127.0);
  const float safe = fmaxf(scale, 1e-10f);
  store((which ? p.q1 : p.q0) + g * head_dim + sub * VPL, v, safe);
  if (sub == 0) (which ? p.s1 : p.s0)[g] = safe;
}

template <typename T, int P>
int launch(const Pair& p, long long n_groups, int lpg, cudaStream_t st) {
  constexpr int GPW = 32 / P;
  const long long trips = (n_groups + GPW - 1) / GPW;
  const long long blocks = (trips * p.n_tensors + WARPS - 1) / WARPS;
  if (blocks == 0) return (int)cudaSuccess;
  quantize_heads_kernel<T, P><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
      p, n_groups, trips, lpg);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Pair& p, long long n_groups, int head_dim,
             cudaStream_t st) {
  const int lpg = head_dim / (16 / sizeof(T));
  if (lpg <= 1) return launch<T, 1>(p, n_groups, lpg, st);
  if (lpg <= 2) return launch<T, 2>(p, n_groups, lpg, st);
  if (lpg <= 4) return launch<T, 4>(p, n_groups, lpg, st);
  if (lpg <= 8) return launch<T, 8>(p, n_groups, lpg, st);
  if (lpg <= 16) return launch<T, 16>(p, n_groups, lpg, st);
  if (lpg <= 32) return launch<T, 32>(p, n_groups, lpg, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x0 (and x1 unless null): [n_groups * head_dim] contiguous, fp32 (dtype 0)
// or bf16 (dtype 1), 16-byte aligned; q0/q1: int8 of the same size, aligned
// to one lane's store (8 bytes for bf16, 4 for fp32); s0/s1: fp32
// [n_groups]. head_dim * sizeof(element) must be a multiple of 16 bytes,
// at most 512 (bf16: head_dim a multiple of 8 up to 256; fp32: of 4 up to
// 128).
extern "C" int oh_quantize_heads_kv(const void* x0, const void* x1, void* q0,
                                    void* s0, void* q1, void* s1,
                                    long long n_groups, int head_dim,
                                    int dtype, void* stream) {
  const Pair p = {x0, x1, (int8_t*)q0, (int8_t*)q1, (float*)s0, (float*)s1,
                  x1 ? 2 : 1};
  const int size = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || head_dim <= 0 || (head_dim * size) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(p, n_groups, head_dim, st)
                    : dispatch<__nv_bfloat16>(p, n_groups, head_dim, st);
}
