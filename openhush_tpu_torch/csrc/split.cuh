// fp32 accuracy on the bf16 tensor cores (bf16x3), shared by K2's fp32
// path (flash_attention_tc.cu), K6 and K7 (flash_attention_bwd_tc.cu).
//
// An fp32 value is split into three bf16 parts, x = x1 + x2 + x3, each the
// bf16 rounding of what the earlier parts leave (each remainder is exact in
// fp32), and a product takes the six partial products whose parts sum to
// at most the third (x1y1, x1y2, x2y1, x1y3, x2y2, x3y1), smallest first,
// with fp32 sums: the way XLA computes Precision.HIGHEST on the TPU's bf16
// matrix unit. Plain TF32 (10-bit mantissa, ~1e-3 relative a product)
// would miss the kernels' 1e-4 checks against the reference's fp32, so the
// fp32 kernels never use it. bf16 inputs are one part already.
//
// The split pass (flash_split.cu) writes the parts of fp32 operands as
// contiguous bf16 planes, which TMA loads as it loads bf16 inputs; the
// probabilities and score gradients, computed in fp32 in registers, are
// split there (split_fragment) into wgmma A fragments.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace oh_tc {

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

// x = hi + mid + lo, each the bf16 rounding of what the earlier parts leave.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// A [64 x 64] accumulator's three bf16 parts as wgmma A fragments (the
// accumulator layout is the A layout: wgmma.cuh).
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
// da[p]) and B^T (NP planes, K-major rows of B, at db[p]) over the 64
// columns: 4 k-steps each. The first product overwrites d.
template <int NP>
__device__ __forceinline__ void product_ss(float (&d)[32], const uint64_t (&da)[NP],
                                           const uint64_t (&db)[NP]) {
#pragma unroll
  for (int i = 0; i < n_pairs(NP, NP); ++i)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(d, da[part_a(NP, NP, i)] + 2 * kk, db[part_b(NP, i)] + 2 * kk, i + kk);
}

// d += sum of the partial products of A (NA parts in registers) and B (NB
// planes of 64 rows, MN-major, at db[p]) over the 64 rows: 4 k-steps each.
template <int NA, int NB>
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[NA][16],
                                           const uint64_t (&db)[NB]) {
#pragma unroll
  for (int i = 0; i < n_pairs(NA, NB); ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, a[part_a(NA, NB, i)] + 4 * kk, db[part_b(NB, i)] + 128 * kk);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float x, float y);
template <> __device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                                  float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// The split pass's buffer (oh_flash_attention_split): the three parts of
// q as contiguous [3 * B, H, Tq, 64] planes (part p of batch row b is row
// b + p * B), then k's and v's [3 * B, H, Tk, 64], then dO's [3 * B, H,
// Tq, 64] where there is one. Operand w (0 q, 1 k, 2 v, 3 dO) starts at
// element plane_offset(w).
inline long long plane_offset(int w, int B, int H, int Tq, int Tk) {
  const long long per_t = 3LL * B * H * DH;
  return per_t * (w == 0 ? 0 : w == 1 ? Tq : w == 2 ? Tq + Tk : Tq + 2LL * Tk);
}

// A tensor map over operand w's planes in the split pass's buffer, boxes
// of `box_t` rows of one head; its batch rows are 3 * B.
inline int plane_map(CUtensorMap* map, Slots* sl, const void* planes, int w, int B, int H,
                     int Tq, int Tk, int box_t) {
  const int T = (w == 0 || w == 3) ? Tq : Tk;
  const long long contiguous[3] = {(long long)H * T * DH, (long long)T * DH, DH};
  return make_map(map, sl,
                  (const __nv_bfloat16*)planes + plane_offset(w, B, H, Tq, Tk),
                  3 * B, H, T, contiguous, box_t);
}

}  // namespace oh_tc
