// Building blocks of the tensor-core kernels (K2's bf16 path in
// flash_attention_tc.cu, K6 in flash_attention_bwd_tc.cu): 4-D bf16 tensor
// maps over [B, H, T, 64] operands given by their strides, TMA tile loads,
// wgmma shared-memory descriptors in the 128-byte swizzle, and the
// m64n64k16 bf16 -> fp32 warpgroup products.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace oh_tc {

using oh_tma::smem_u32;

constexpr int DH = 64;                        // head dim: a row is 128 B of bf16

// The tensor map's coordinate slot (1..3) of the h, t and b dimensions.
struct Slots { int h, t, b; };

// A [box] tile of one head's rows t.. of a tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, Slots sl,
                                         int t, int h, int b, uint64_t* bar) {
  const auto at = [&](int slot) { return sl.t == slot ? t : sl.h == slot ? h : b; };
  oh_tma::load_4d(dst, map, 0, at(1), at(2), at(3), bar);
}

// wgmma shared-memory descriptor of a 1024-byte-aligned tile of rows of 64
// bf16 (128 B) in the TMA's 128-byte swizzle: 8-row groups 1024 B apart
// (SBO), the leading offset unused for this swizzle, layout 1 = 128B swizzle.
// The same fields serve the K-major q and k tiles and the MN-major v tile.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define OH_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define OH_D32_ARGS(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64x64] (+)= A[64x16] B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OH_D32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : OH_D32_ARGS(d)
               : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] B[16x64], A in registers (bf16 pairs), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OH_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : OH_D32_ARGS(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of wgmma m64n64 (f32), for thread `lane` of warp w of
// the warpgroup: d[4*j + 2*i + c] is row 16*w + lane/4 + 8*i, column
// 8*j + 2*(lane%4) + c, for j < 8, i, c < 2. The A-operand fragment of a
// k-step of 16 columns is the same pairs (P[2*j + i] packs d[4*j + 2*i] and
// d[4*j + 2*i + 1]; k-step kk takes P[4*kk .. 4*kk + 3]), so a product's
// registers become the next product's A operand.

// A 4-D bf16 tensor map over one [B, H, T, 64] operand with (b, h, t)
// strides `st` in elements, boxes of `box_t` rows of one head. The three
// outer dimensions go in order of their strides; `sl` says where each is.
inline int make_map(CUtensorMap* map, Slots* sl, const void* base, int B, int H, int T,
                    const long long* st, int box_t) {
  const long long stride[3] = {st[1], st[2], st[0]};          // h, t, b
  const int size[3] = {H, T, B}, box[3] = {1, box_t, 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t gdim[4] = {DH, 0, 0, 0}, gstride[3];
  cuuint32_t gbox[4] = {DH, 0, 0, 0};
  int slot[3];
  for (int p = 0; p < 3; ++p) {
    gdim[p + 1] = (cuuint64_t)size[order[p]];
    gstride[p] = (cuuint64_t)stride[order[p]] * 2;
    gbox[p + 1] = (cuuint32_t)box[order[p]];
    slot[order[p]] = p + 1;
  }
  *sl = Slots{slot[0], slot[1], slot[2]};
  return oh_tma::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, gdim, gstride, gbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace oh_tc
