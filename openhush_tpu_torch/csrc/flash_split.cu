// The split pass of the fp32 flash kernels (K2's fp32 path, K6, K7): the
// three bf16 parts of fp32 q, k, v and, for the backward, dO (split.cuh has
// the arithmetic), written as contiguous planes that the kernels' tensor
// maps read as they read bf16 inputs.
//
// Bound on an H100: bytes. At the fine-tune's shape (B=2, 20 heads,
// T=1500) a backward's four operands are 61 MB of fp32 in and 92 MB of
// bf16 planes out, 0.046 ms at 3.35 TB/s; the forward's three are 3/4 of
// that. One thread a 16-byte group of four values: each warp reads two
// 256-byte rows and writes six 128-byte plane rows, all coalesced. A
// backward fills the planes once for K6 and K7 together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split.cuh"

namespace {

using oh_tc::DH;
using oh_tc::split3;

// Up to four fp32 [B, H, T, 64] operands, read through their (b, h, t)
// strides, each to its three planes at dst (part p of row r at dst + p *
// plane + r * 64).
struct SplitArgs {
  const float* src[4];
  long long sb[4], sh[4], st[4];
  int T[4];
  __nv_bfloat16* dst[4];
};

constexpr int GROUPS = DH / 4;                // 16-byte groups a row

__global__ void split_planes_kernel(SplitArgs a, int B, int H) {
  const int w = blockIdx.y;
  const int T = a.T[w];
  const int n_rows = B * H * T;
  const long long plane = (long long)n_rows * DH;
  const int g = threadIdx.x % GROUPS;
  for (int r = blockIdx.x * (blockDim.x / GROUPS) + threadIdx.x / GROUPS; r < n_rows;
       r += gridDim.x * (blockDim.x / GROUPS)) {
    const int t = r % T, bh = r / T;
    const int hh = bh % H, bb = bh / H;
    const float4 x = *reinterpret_cast<const float4*>(
        a.src[w] + bb * a.sb[w] + hh * a.sh[w] + t * a.st[w] + 4 * g);
    __nv_bfloat162 part[3][2];
    split3(x.x, part[0][0].x, part[1][0].x, part[2][0].x);
    split3(x.y, part[0][0].y, part[1][0].y, part[2][0].y);
    split3(x.z, part[0][1].x, part[1][1].x, part[2][1].x);
    split3(x.w, part[0][1].y, part[1][1].y, part[2][1].y);
    __nv_bfloat16* out = a.dst[w] + (long long)r * DH + 4 * g;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(out + p * plane) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&part[p][0]),
                     *reinterpret_cast<const uint32_t*>(&part[p][1]));
  }
}

}  // namespace

// Fills `planes` (bf16, 3 * B * H * 64 * (2 * Tq + 2 * Tk) elements with
// dout, 3 * B * H * 64 * (Tq + 2 * Tk) without) with the three parts of
// fp32 q [B,H,Tq,64], k and v [B,H,Tk,64] and, unless it is null, dout
// [B,H,Tq,64], laid out as split.cuh's plane_offset says. `strides`: (b, h,
// t) in elements of q, k, v, dout (12 values; dout's not read when it is
// null); the last dim is contiguous and rows start on 16-byte boundaries.
extern "C" int oh_flash_attention_split(const void* q, const void* k, const void* v,
                                        const void* dout, void* planes, int B, int H,
                                        int Tq, int Tk, const long long* strides,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || planes == nullptr ||
      (long long)B * H * (Tq > Tk ? Tq : Tk) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n = dout == nullptr ? 3 : 4;
  const void* src[4] = {q, k, v, dout};
  SplitArgs a;
  for (int w = 0; w < n; ++w) {
    a.src[w] = (const float*)src[w];
    a.sb[w] = strides[3 * w];
    a.sh[w] = strides[3 * w + 1];
    a.st[w] = strides[3 * w + 2];
    a.T[w] = (w == 0 || w == 3) ? Tq : Tk;
    a.dst[w] = (__nv_bfloat16*)planes + oh_tc::plane_offset(w, B, H, Tq, Tk);
  }
  const long long rows = (long long)B * H * (Tq > Tk ? Tq : Tk);
  const long long need = (rows + 255 / GROUPS) / (256 / GROUPS);
  const int blocks = (int)(need < 132 * 8 ? need : 132 * 8);
  split_planes_kernel<<<dim3(blocks, n), 256, 0, (cudaStream_t)stream>>>(a, B, H);
  return (int)cudaGetLastError();
}
