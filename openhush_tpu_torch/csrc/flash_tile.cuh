// Tile helpers shared by the encoder flash-attention kernels: the forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu).
//
// A tile is 64 rows of a strided [rows, 64] matrix (one head of q, k, v, or
// the output gradient), staged in shared memory as fp32 with rows padded to
// LD floats, so that the 16-byte loads of threads reading consecutive rows
// at one column fall in distinct banks. Every kernel here runs 256 threads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                      // rows (queries or keys) per tile
constexpr int DH = 64;                        // head dim
constexpr int LD = DH + 4;                    // padded smem row (floats)
constexpr int THREADS = 256;
constexpr int TILE_FLOATS = TILE * LD;

__device__ __forceinline__ void unpack16(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float* out, __nv_bfloat16) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {                // element 2i sits in the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [row0, row0+64) x DH of a strided [rows, DH] matrix -> dst [64][LD]
// fp32; rows at or past n_rows read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DH / VEC;               // 16-byte chunks per row
  for (int c = threadIdx.x; c < TILE * CPR; c += THREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * VEC;
    float vals[VEC];
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + col);
      unpack16(raw, vals, T());
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + col + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// s[i][j] += a[4*ty+i] . b[tx+16*j] over the DH columns of two staged tiles:
// the 4x4 block of a 64x64 product of row-major tiles that thread (ty, tx)
// owns. Every 16-byte shared-memory load feeds four FMAs.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][c] += sum_r p[4*ty+i][r] * m[r][4*tx+c] over the 64 rows r: the
// product of a staged [64][64] matrix (probabilities or their gradient) and a
// staged tile, for the 4x4 output block that thread (ty, tx) owns.
__device__ __forceinline__ void tile_matmul(float (&acc)[4][4], const float* p,
                                            const float* m, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < TILE; r += 4) {
    float4 pv[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (4 * ty + i) * LD + r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mv[c] = *reinterpret_cast<const float4*>(m + (r + c) * LD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][0] = fmaf(pr[c], mv[c].x, acc[i][0]);
        acc[i][1] = fmaf(pr[c], mv[c].y, acc[i][1]);
        acc[i][2] = fmaf(pr[c], mv[c].z, acc[i][2]);
        acc[i][3] = fmaf(pr[c], mv[c].w, acc[i][3]);
      }
    }
  }
}

}  // namespace
