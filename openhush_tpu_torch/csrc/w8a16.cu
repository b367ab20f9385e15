// W8A16: the product of activations with the int8 decoder weights,
//   y[M, O] = to_x_dtype((sum_i x[m, i] * q[i, o]) * s[o])   (+ bias[o], rounded again)
// x bf16 or fp32 [M, I] row-major, q int8 levels [I, O] row-major (as
// quantize_decoder_weights stores them), s fp32 per-output-channel scales
// [O], the sum in fp32. With a bias the rounded product gets bias[o] added
// and is rounded once more, which is what the plain code's `_mm(x, w) + b`
// does in x's dtype; the fold saves that add's launch. I and O are multiples
// of 16. One launch serves up to three products that share x (a group: the
// decoder's q, k and v of one h, or the cross-KV's xk and xv of the audio
// features): each member brings its own levels, scales, bias (or none) and
// output, and the grid's 128-column tiles run over the members in turn.
//
// Replaces no TPU kernel: the reference computes this product in XLA
// (openhush_tpu/models/whisper/model.py:274 `_mm`, a dot whose operand
// convert XLA fuses), as it does the recurrences of csrc/dsp.cu. Without a
// kernel the port cast the levels to bf16 in memory on every call (a 2-byte
// copy written and read back beside the 1-byte read), and tripled the read
// that int8 weights exist to halve.
//
// Bound on an H100: at the decode shapes (M = 1-32 rows) bytes, the levels
// read once: a large-v3 [1280, 1280] product 1.64 MB, 0.00049 ms at 3.35
// TB/s, so a launch is mostly its ramp and one memory trip. At the
// cross-KV's M = B*1500 the operations (2*M*I*O) bound it. Two modes:
//
// Decode mode (bf16 x where takes_tile declines the tile mode; fp32 x at
// every M), on the tensor cores:
// - Each warp owns 128 output columns of one k-range. Its lane (g, t) =
//   (lane / 4, lane % 4) copies, for each k-step of 16 rows, the 16 bytes at
//   columns 16g..16g+15 of rows 2t, 2t+1, 2t+8 and 2t+9 (cp.async, 16 bytes
//   a copy, a ring of STAGES k-steps in shared memory that only the copying
//   thread reads back, so no barrier guards it): each row's 128 bytes are
//   one coalesced line, and the levels leave device memory once, as int8.
// - The product is mma.sync m16n8k16 (bf16 in, fp32 sums) with the weights
//   as the A operand (16 output columns a tile, 8 tiles a warp) and x as B
//   (8 rows of x a tile, NT tiles): M = 1-8 pads to 8 rows, not 16. The
//   fragment's output slots are mapped to columns so that a lane's 16 bytes
//   feed all 8 tiles: slot g of tile j is column 16g + 2j, slot g + 8 column
//   16g + 2j + 1; its k slots are the rows it copied. Two byte-permutes put
//   rows 2t and 2t+1 side by side, and each level widens to bf16 in
//   registers: (byte ^ 0x80) under the exponent of 2^23 is 2^23 + 128 + q
//   as fp32, less 2^23 + 128 is q exactly, and its high half is q in bf16
//   (|q| <= 127 has 7 significant bits). The products are exact; only the
//   order of the fp32 sums differs from the plain version's.
// - A CTA is 4 warps over interleaved k-steps of its range; a thread-block
//   cluster of up to 8 CTAs along I splits the range further, doubled while
//   the grid (every member's tiles) stays within one wave of resident CTAs
//   (the kernel's occupancy times the SM count) and each rank keeps 2
//   k-steps a warp: a [1280, 1280] product at M = 1 is 80 CTAs and not 10,
//   a q/k/v group 240. The partial sums meet in a fixed order: the 4 warps
//   through shared memory, then the cluster's ranks, each pushing its sums
//   to the rank that owns them (one-sided stores to distributed shared
//   memory, one cluster barrier), which adds them in rank order. No
//   atomics: two launches give the same bits, and a group's member gives
//   its single launch's bits whenever the two grids take one cluster size
//   (oh_w8a16_cluster says which).
// - Rows of x above 8 (16) take 32-row blocks in the grid's y, each
//   re-reading the weights' tile from L2; a thread stores its two adjacent
//   columns at once when one CTA holds the whole sum.
// - fp32 x (the tests' tiny model) takes the same kernel with fp32 pairs of
//   x split into three bf16 parts, x = x1 + x2 + x3 (split.cuh: all 24
//   bits of a normal fp32), and three products a tile, smallest part
//   first, into the same fp32 sums: the levels are exact in bf16, so only
//   x needs parts. Never TF32. 16-row blocks at most (the parts' registers).
//
// Tile mode (bf16 x at large M; takes_tile says where): the product
// transposed, y^T[O, M] = q^T[O, I] x^T[I, M], on wgmma m64nBNk16 (bf16
// in, fp32 sums, sm_90a). A CTA is 128 output columns by BN = 64, 128 or
// 256 rows of x (tile_bn), two warpgroups of 64 columns each:
// - Thread 0 streams each 64-row k-slab through a ring of ~200 KB by TMA
//   (mbarriers full/empty): x's [BN, 64] box, K-major in the 128-byte
//   swizzle, which is wgmma's B operand as it lies, and the levels' [64,
//   128] int8 box, swizzled too; TMA zero-fills past M, I and O. The levels
//   leave L2 once a tile of columns and block of BN rows (not once per 32
//   rows). Thread 0 refills a slot once both warpgroups have released it,
//   and waits only for the slab read next. There is no producer warp: a
//   ninth warp leaves one scheduler three warps' registers (168 a thread),
//   too few for m64n256's 128 accumulators.
// - Each warpgroup holds its 64 columns of levels in wgmma's A operand
//   from registers. Thread (warp w, g, t) owns columns c and c + 1, c = 64
//   wg + 2 (8w + g): A rows 16w + g and 16w + g + 8. A slab is 16 2-byte
//   shared loads (rows 16kk + 2t, 2t+1, 2t+8, 2t+9; under the swizzle a
//   warp's loads take distinct banks or share a word), a byte-permute a
//   pair of rows and the exact widening above: each level is widened once
//   in the CTA and multiplies BN rows of x. The next slab widens into a
//   second register set while the current slab's 4 products run
//   (wgmma.wait_group 1).
// - Each output's sum runs over the slabs in order on one CTA (no split
//   along I), so a group's member gives its single launch's bits.
// - The epilogue is the decode mode's arithmetic; a thread stores two
//   adjacent columns of a row at once.
// On an H100 the mode is bound by the bytes its slabs move from L2 to the
// SMs: 40 KB for a 4.2 MFLOP slab at BN = 256. At M = 12000 on [1280,
// 1280], a build without the products took 0.0697 ms of the whole
// kernel's 0.0978, the cast-plus-mm pair 0.0748. A TMA multicast of x
// across a cluster of 2-4 column tiles measured slower at every shape,
// and a 64-row slab costs a lone CTA ~0.8 us whatever BN, so at I = 5120 a
// grid under one wave walks its 80 slabs in turn (PERF.md §6;
// tools/torch_w8a16_probe.py --variant, --crossover).
//
// Both modes' epilogue multiplies the fp32 sum by s[o] (one rounding, as
// the plain `y * s`), rounds once to x's dtype, then adds the bias and
// rounds again if there is one (__fmul_rn/__fadd_rn: nvcc would contract
// them).
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/torch_w8a16_probe.py, 64 MB
// of levels rotated, so each launch reads them from device memory): a
// [1280, 1280] product at M = 1 takes 0.0064 ms in the decode mode; in one
// run beside it, a build that returns at entry took 0.0019, one that only
// loads its levels 0.0042 and one that loads and multiplies 0.0046, so the
// reduction takes the last ~0.0018. Launch- and latency-bound: ~13x the
// byte bound of 0.00049 ms. A q/k/v group at M = 1 takes 0.0087 ms
// against 0.0193 for three single launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "split.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WARPS = 4;                  // a CTA's warps, over its k-range
constexpr int THREADS = WARPS * 32;
constexpr int OT = 128;                   // output columns a CTA (and a warp)
constexpr int KS = 16;                    // rows of q a k-step: one mma's depth
constexpr int STAGES = 4;                 // k-steps in flight a warp
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_MEMBERS = 3;

// One product of a group: its levels, scales, bias (x's dtype [O], or
// null), output and width, and the first of its 128-column tiles in the
// grid (INT_MAX for an unused slot).
struct Member {
  const int8_t* q;
  const float* s;
  const void* bias;
  void* y;
  int O;
  int tile0;
};

struct Args {
  const void* x;
  Member m[MAX_MEMBERS];
  int n;                                  // members
  int M, I;
  int steps_per_cta;                      // k-steps of a cluster rank's range
};

// The member whose tiles hold column tile `tile` (selects, no indexing:
// the arguments stay in parameter space), and its index.
__device__ __forceinline__ Member member_of(const Args& a, int tile, int& index) {
  Member mb = a.m[0];
  index = 0;
  if (tile >= a.m[1].tile0) { mb = a.m[1]; index = 1; }
  if (tile >= a.m[2].tile0) { mb = a.m[2]; index = 2; }
  return mb;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// src_bytes 0 writes zeros and reads nothing (a column tile past O, a row
// of x past M).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait for all but the `ahead` most recent groups (ahead <= STAGES - 1).
__device__ __forceinline__ void cp_wait_ahead(int ahead) {
  static_assert(STAGES == 4, "cp_wait_ahead covers 0..3 groups ahead");
  if (ahead >= 3) cp_wait<3>();
  else if (ahead == 2) cp_wait<2>();
  else if (ahead == 1) cp_wait<1>();
  else cp_wait<0>();
}

// Four biased levels (byte ^ 0x80) -> the levels as fp32, exactly.
__device__ __forceinline__ float level(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.0f;
}

// Four signed levels -> two bf16 pairs (bytes 0, 1 -> lo; bytes 2, 3 -> hi),
// lower byte in the lower half. Exact.
__device__ __forceinline__ void widen(uint32_t u, uint32_t& lo, uint32_t& hi) {
  const uint32_t b = u ^ 0x80808080u;
  const float f0 = level(b, 0x7650), f1 = level(b, 0x7651);
  const float f2 = level(b, 0x7652), f3 = level(b, 0x7653);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k-step's copies into ring slot st: this lane's 16 bytes of rows kb +
// 2t, 2t+1, 2t+8, 2t+9 and its two bf16 pairs of each x tile. (A plain
// function: a [&] lambda starting cp.async copies in a loop once compiled
// to copies that never happened.)
template <int NT, typename X>
__device__ __forceinline__ void copy_step(uint32_t wslot, uint32_t xslot,
                                          const int8_t* qcol, int o_bytes,
                                          const X* const (&xrow)[NT],
                                          const int (&x_bytes)[NT], int O,
                                          int t, int kb, int st) {
  constexpr int XB = 2 * sizeof(X);       // a pair of x
  const int krow[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    cp16(wslot + ((st * 4 + c) * 32) * 16, qcol + (size_t)(kb + krow[c]) * O,
         o_bytes);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t dst = xslot + (((st * NT + nt) * 2 + h) * 32) * XB;
      if constexpr (XB == 8)
        cp8(dst, xrow[nt] + kb + 8 * h, x_bytes[nt]);
      else
        cp4(dst, xrow[nt] + kb + 8 * h, x_bytes[nt]);
    }
  cp_commit();
}

// The number of CTAs in this CTA's cluster.
__device__ __forceinline__ int cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// The cluster barrier's halves (barrier.cluster: every thread of every
// rank arrives once a phase).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// v into rank `rank`'s copy of the shared float at `local`.
__device__ __forceinline__ void st_rank(const float* local, int rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// The partial sums of a CTA's threads, NREG a thread in the same order in
// every warp (element E = reg * 32 + lane of a warp), added in a fixed
// order: the CTA's warps in order through shared memory (`red`, over the
// finished ring), then the cluster's ranks in order.
// - One CTA (csize 1): each thread adds the warps' partials of a unit,
//   elements E and E + P (E / P even), and calls out2(E, sum of E, sum of
//   E + P): one store of a pair.
// - A cluster (csize a power of two): element E belongs to rank E % csize.
//   Each rank pushes its sums into slot [its rank][E / csize] of the
//   owner's `recv` (one-sided stores), one cluster barrier makes them
//   visible, and the owner adds its slots in rank order and calls out1(E,
//   sum). A rank arrives at the barrier's first phase on entry
//   (cluster_arrive_relaxed at the kernel's start) and waits before it
//   pushes, so no store reaches a rank that has not started.
template <int NREG, int P, typename Out1, typename Out2>
__device__ __forceinline__ void reduce(const float (&acc)[NREG], float* red,
                                       float* recv, int rank, int csize,
                                       Out1 out1, Out2 out2) {
  static_assert(NREG * 32 % (2 * P) == 0, "units tile the elements");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                        // the ring is read out
#pragma unroll
  for (int r = 0; r < NREG; ++r) red[(warp * NREG + r) * 32 + lane] = acc[r];
  __syncthreads();
  cluster_wait();                         // every rank has started
  if (csize == 1) {
    for (int u = threadIdx.x; u < NREG * 16; u += THREADS) {
      const int e = u / P * 2 * P + u % P;
      float v0 = red[e], v1 = red[e + P];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        v0 += red[w * NREG * 32 + e];
        v1 += red[w * NREG * 32 + e + P];
      }
      out2(e, v0, v1);
    }
    return;
  }
  const int lc = __ffs(csize) - 1;        // log2(csize)
  const int per = NREG * 32 >> lc;        // elements a rank owns
  for (int r = warp; r < NREG; r += WARPS) {
    float v = red[r * 32 + lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[(w * NREG + r) * 32 + lane];
    const int e = r * 32 + lane;
    st_rank(recv + rank * per + (e >> lc), e & (csize - 1), v);
  }
  cluster_arrive();
  cluster_wait();                         // every rank's pushes have landed
  for (int i = threadIdx.x; i < per; i += THREADS) {
    float v = recv[i];
    for (int c = 1; c < csize; ++c) v += recv[c * per + i];
    out1((i << lc) + rank, v);
  }
}

// XB: the bytes of a pair of x (4 bf16, 8 fp32).
template <int NT, int XB>
__host__ __device__ constexpr int pipe_bytes() {
  return WARPS * STAGES * (4 * 32 * 16 + NT * 2 * 32 * XB);
}
template <int NREG>
__host__ __device__ constexpr int red_bytes() {
  return WARPS * NREG * 32 * 4;
}
template <int NT, int XB>
__host__ __device__ constexpr int smem_bytes() {  // max(ring, red) + recv
  return (pipe_bytes<NT, XB>() > red_bytes<NT * 32>() ? pipe_bytes<NT, XB>()
                                                      : red_bytes<NT * 32>()) +
         NT * 32 * 32 * 4;
}

// The epilogue's value of one output: the sum times the scale, rounded to
// x's dtype, plus the bias rounded again.
__device__ __forceinline__ __nv_bfloat16 out_x(float v, float s, const __nv_bfloat16* bias,
                                               int o) {
  const __nv_bfloat16 yv = __float2bfloat16_rn(__fmul_rn(v, s));
  return bias ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(yv),
                                              __bfloat162float(bias[o])))
              : yv;
}
__device__ __forceinline__ float out_x(float v, float s, const float* bias, int o) {
  const float yv = __fmul_rn(v, s);
  return bias ? __fadd_rn(yv, bias[o]) : yv;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 v0,
                                           __nv_bfloat16 v1) {
  *(__nv_bfloat162*)p = __halves2bfloat162(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *(float2*)p = make_float2(v0, v1);
}

// One CTA = (cluster rank: a k-range, 128 output columns, 8*NT rows of
// x). Accumulator acc[(nt * 8 + j) * 4 + d], d = 2h + e: output column
// 16g + 2j + h of row 8nt + 2t + e. X = float takes fp32 x as three bf16
// parts (split.cuh's split3; the levels are exact in bf16), their three
// products smallest first into the same fp32 sums.
template <int NT, typename X>
__global__ void __launch_bounds__(THREADS) w8a16_mma_kernel(const Args a) {
  constexpr bool F32 = sizeof(X) == 4;
  constexpr int XB = 2 * sizeof(X);
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_arrive_relaxed();
  const int rank = cluster_ctarank();
  const int csize = cluster_nctarank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / csize;
  int mi;
  const Member mb = member_of(a, tile, mi);
  const int obase = (tile - mb.tile0) * OT;
  const int mbase = blockIdx.y * 8 * NT;
  const int nk = a.I / KS;
  const int k_begin = rank * a.steps_per_cta;
  const int k_end = min(nk, k_begin + a.steps_per_cta);
  const int first = k_begin + warp;
  const int nsteps = first < k_end ? (k_end - first + WARPS - 1) / WARPS : 0;

  const int ocol = obase + 16 * g;
  const int o_bytes = ocol < mb.O ? 16 : 0;
  const int8_t* qcol = mb.q + (o_bytes ? ocol : 0);
  const X* xrow[NT];
  int x_bytes[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = mbase + 8 * nt + g;
    x_bytes[nt] = m < a.M ? XB : 0;
    xrow[nt] = (const X*)a.x + (size_t)(m < a.M ? m : 0) * a.I + 2 * t;
  }
  const uint32_t wslot = smem_u32(smem) + (warp * STAGES * 4 * 32 + lane) * 16;
  const uint32_t xslot = smem_u32(smem) + WARPS * STAGES * 4 * 32 * 16 +
                         (warp * STAGES * NT * 2 * 32 + lane) * XB;

  constexpr int NREG = NT * 32;
  float acc[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) acc[r] = 0.0f;

  for (int s = 0; s < STAGES && s < nsteps; ++s)
    copy_step<NT>(wslot, xslot, qcol, o_bytes, xrow, x_bytes, mb.O, t,
              (first + WARPS * s) * KS, s);
  for (int s = 0; s < nsteps; ++s) {
    const int st = s % STAGES;
    cp_wait_ahead(min(STAGES - 1, nsteps - 1 - s));
    uint32_t w[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[c][0]), "=r"(w[c][1]), "=r"(w[c][2]), "=r"(w[c][3])
                   : "r"(wslot + ((st * 4 + c) * 32) * 16));
    uint32_t b[F32 ? 3 : 1][NT][2];       // [part][tile][pair]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t src = xslot + (((st * NT + nt) * 2 + h) * 32) * XB;
        if constexpr (F32) {
          float v0, v1;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(v0), "=f"(v1) : "r"(src));
          __nv_bfloat162 part[3];
          oh_tc::split3(v0, part[0].x, part[1].x, part[2].x);
          oh_tc::split3(v1, part[0].y, part[1].y, part[2].y);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            b[p][nt][h] = *reinterpret_cast<const uint32_t*>(&part[p]);
        } else {
          asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(b[0][nt][h]) : "r"(src));
        }
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {         // 4-byte word c: tiles 2c and 2c+1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t sel = half ? 0x7362u : 0x5140u;
        uint32_t a0, a1, a2, a3;
        widen(__byte_perm(w[0][c], w[1][c], sel), a0, a1);   // rows 2t, 2t+1
        widen(__byte_perm(w[2][c], w[3][c], sel), a2, a3);   // rows 2t+8, 2t+9
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* d = acc + (nt * 8 + 2 * c + half) * 4;
#pragma unroll
          for (int p = F32 ? 2 : 0; p >= 0; --p)
            mma_bf16(d[0], d[1], d[2], d[3], a0, a1, a2, a3, b[p][nt][0], b[p][nt][1]);
        }
      }
    }
    if (s + STAGES < nsteps)
      copy_step<NT>(wslot, xslot, qcol, o_bytes, xrow, x_bytes, mb.O, t,
                (first + WARPS * (s + STAGES)) * KS, st);
  }

  const X* bias = (const X*)mb.bias;
  X* y = (X*)mb.y;
  const int O = mb.O;
  // Element e: register r = e / 32 = (nt * 8 + j) * 4 + 2h + e', lane e %
  // 32. A unit pairs h = 0 and 1 (registers r and r + 2): columns o, o + 1.
  auto where = [&](int e, int& row, int& o) {
    const int ul = e & 31, r = e >> 5, blk = r >> 2;
    row = mbase + 8 * (blk >> 3) + 2 * (ul & 3) + (r & 1);
    o = obase + 16 * (ul >> 2) + 2 * (blk & 7) + ((r >> 1) & 1);
  };
  reduce<NREG, 64>(acc, (float*)smem,
                   (float*)(smem + smem_bytes<NT, XB>()) - NREG * 32, rank, csize,
                   [&](int e, float v) {
    int row, o;
    where(e, row, o);
    if (row < a.M && o < O) y[(size_t)row * O + o] = out_x(v, mb.s[o], bias, o);
  }, [&](int e, float v0, float v1) {
    int row, o;
    where(e, row, o);
    if (row < a.M && o < O) store_pair(y + (size_t)row * O + o, out_x(v0, mb.s[o], bias, o),
                                       out_x(v1, mb.s[o + 1], bias, o + 1));
  });
}

// ---------------------------------------------------------------------------
// Tile mode: wgmma with the levels widened into the A operand's registers.
// ---------------------------------------------------------------------------

constexpr int TBO = 128;                  // output columns a CTA
constexpr int TBK = 64;                   // rows of q a stage (128 B of x a row)
constexpr int TTHREADS = 256;             // two warpgroups, 64 columns each

// The ring holds ~200 KB of slabs an SM: 5 stages at BN = 256, 8 at 128,
// 6 in each of two CTAs at 64.
template <int BN>
struct TileCfg {
  static constexpr int X_BYTES = BN * TBK * 2;    // [BN, 64] bf16
  static constexpr int Q_BYTES = TBK * TBO;       // [64, 128] int8
  static constexpr int STAGE = X_BYTES + Q_BYTES;
  static constexpr int STAGES = BN == 256 ? 5 : BN == 128 ? 8 : 6;
  static constexpr int CTAS = BN == 64 ? 2 : 1;   // an SM
  static constexpr int SMEM = STAGES * STAGE + 1024;    // + alignment
};

struct TileParams {
  CUtensorMap xmap;                       // x [M, I] bf16, boxes [BN, 64]
  CUtensorMap qmap[MAX_MEMBERS];          // each member's q [I, O], boxes [64, 128]
  Args a;
};

#define W8_D64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define W8_D64_ARGS(d)                                                          \
  OH_D32_ARGS(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define W8_D128                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "      \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "      \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "      \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "      \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "      \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "      \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "    \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "    \
  "%124, %125, %126, %127}"
#define W8_D128_ARGS(d)                                                         \
  W8_D64_ARGS(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),            \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),          \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),          \
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]),          \
      "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),          \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),          \
      "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),          \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),       \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),     \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),     \
      "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),     \
      "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),     \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d[64 x BN] += A[64 x 16] B[16 x BN]: A in registers (bf16 pairs), B
// K-major in shared memory (no transpose).
template <int BN> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OH_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : OH_D32_ARGS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " W8_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : W8_D64_ARGS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " W8_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : W8_D128_ARGS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A slab (64 rows at `qs`) of this thread's levels as its A fragments for
// the 4 k-steps: rows 16kk + 2t, 2t+1 (a[kk][0..1]) and 16kk + 2t+8, 2t+9
// (a[kk][2..3]) of its two adjacent columns. off0/off1: the swizzled byte
// offsets of its 2-byte word in rows 2t and 2t+1 (rows 8 further share
// their swizzle phase). All 16 loads first, then the widening: the chains
// run side by side.
__device__ __forceinline__ void widen_slab(const unsigned char* qs, int off0, int off1,
                                           uint32_t (&a)[TBK / 16][4]) {
  uint32_t h[TBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < TBK / 16; ++kk) {
    const unsigned char* p = qs + kk * 16 * TBO;
    h[kk][0] = *(const uint16_t*)(p + off0);
    h[kk][1] = *(const uint16_t*)(p + off1);
    h[kk][2] = *(const uint16_t*)(p + off0 + 8 * TBO);
    h[kk][3] = *(const uint16_t*)(p + off1 + 8 * TBO);
  }
#pragma unroll
  for (int kk = 0; kk < TBK / 16; ++kk) {
    widen(__byte_perm(h[kk][0], h[kk][1], 0x5140u), a[kk][0], a[kk][1]);
    widen(__byte_perm(h[kk][2], h[kk][3], 0x5140u), a[kk][2], a[kk][3]);
  }
}

// Thread 0's loads: slab `next` and on into their ring slots, each once
// both warpgroups have released the slot's previous slab; it waits only
// for slab `need` (the next one the warpgroups read), and leaves later
// slabs whose slots are still busy for its next call.
template <int BN>
__device__ __forceinline__ void refill(int& next, int need, int nst, const TileParams& p,
                                       const CUtensorMap* qm, int obase, int mbase,
                                       unsigned char* smem, uint64_t* full, uint64_t* empty) {
  using C = TileCfg<BN>;
  for (; next < nst; ++next) {
    const int s = next % C::STAGES;
    if (next >= C::STAGES) {
      const int parity = (next / C::STAGES - 1) & 1;
      if (next > need) {
        if (!oh_tma::mbar_test(&empty[s], parity)) return;
      } else {
        oh_tma::mbar_wait(&empty[s], parity);
      }
    }
    unsigned char* st = smem + s * C::STAGE;
    oh_tma::mbar_expect_tx(&full[s], C::STAGE);
    oh_tma::load_2d(st, &p.xmap, next * TBK, mbase, &full[s]);
    oh_tma::load_2d(st + C::X_BYTES, qm, obase, next * TBK, &full[s]);
  }
}

// Stage j of a warpgroup's main loop on register set B: its 4 products
// issued as one group; once the previous stage's group is done, stage j -
// 1's slot is released (and thread 0 refills the ring), and stage j + 1's
// slab is widened into the other set while stage j's products run (and
// the other warpgroup's).
template <int BN, int B>
__device__ __forceinline__ void tile_stage(int j, int nst, const TileParams& p,
                                           const CUtensorMap* qm, int obase, int mbase,
                                           int& next, unsigned char* smem, uint64_t* full,
                                           uint64_t* empty, int off0, int off1,
                                           float (&acc)[BN / 2], uint32_t (&A)[2][TBK / 16][4]) {
  using C = TileCfg<BN>;
  const uint64_t dx = oh_tc::sw128_desc(smem + (j % C::STAGES) * C::STAGE);
  fence_acc(acc);
  oh_tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TBK / 16; ++kk)
    Wgmma<BN>::rs(acc, A[B][kk], dx + 2 * kk);          // 32 bytes a k-step
  oh_tc::wgmma_commit();
  wgmma_wait<1>();                        // stage j - 1's products are done
  if (j > 0 && (threadIdx.x & 31) == 0) oh_tma::mbar_arrive(&empty[(j - 1) % C::STAGES]);
  if (threadIdx.x == 0)
    refill<BN>(next, j + 1, nst, p, qm, obase, mbase, smem, full, empty);
  __syncwarp();
  if (j + 1 < nst) {
    const int s1 = (j + 1) % C::STAGES;
    oh_tma::mbar_wait(&full[s1], ((j + 1) / C::STAGES) & 1);
    widen_slab(smem + s1 * C::STAGE + C::X_BYTES, off0, off1, A[B ^ 1]);
  }
}

// A CTA: 128 output columns (64 a warpgroup) by BN rows of x. No producer
// warp: a ninth warp would leave one scheduler three warps' registers
// (168 a thread), too few for m64n256's 128 accumulators.
template <int BN>
__global__ void __launch_bounds__(TTHREADS, TileCfg<BN>::CTAS)
w8a16_tile_kernel(const __grid_constant__ TileParams p) {
  using C = TileCfg<BN>;
  constexpr int NACC = BN / 2;            // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  const Args& a = p.a;
  int mi;
  const Member mb = member_of(a, blockIdx.x, mi);
  const CUtensorMap* qm = mi == 0 ? &p.qmap[0] : mi == 1 ? &p.qmap[1] : &p.qmap[2];
  const int obase = (blockIdx.x - mb.tile0) * TBO;
  const int mbase = blockIdx.y * BN;
  const int nst = (a.I + TBK - 1) / TBK;

  int next = 0;                           // thread 0: the next slab to load
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      oh_tma::mbar_init(&full[s], 1);
      oh_tma::mbar_init(&empty[s], TTHREADS / 32);     // lane 0 of each warp
    }
    oh_tma::mbar_init_fence();
    refill<BN>(next, 0, nst, p, qm, obase, mbase, smem, full, empty);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // This thread's columns: c and c + 1 of the tile (A rows 16 warp + g and
  // + 8 of its warpgroup's m64 tile).
  const int c = 64 * wg + 2 * (8 * warp + g);
  // Byte offsets of the 2-byte word in rows 2t and 2t+1 of a [64, 128] slab
  // under the 128-byte swizzle (16-byte chunk k of row r lies at chunk k ^
  // (r % 8)).
  const int off0 = 2 * t * TBO + (((c >> 4) ^ (2 * t)) << 4) + (c & 15);
  const int off1 = (2 * t + 1) * TBO + (((c >> 4) ^ (2 * t + 1)) << 4) + (c & 15);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  uint32_t A[2][TBK / 16][4];             // [set][k-step][register]

  oh_tma::mbar_wait(&full[0], 0);
  widen_slab(smem + C::X_BYTES, off0, off1, A[0]);
  for (int j = 0; j < nst; j += 2) {
    tile_stage<BN, 0>(j, nst, p, qm, obase, mbase, next, smem, full, empty, off0, off1,
                      acc, A);
    if (j + 1 < nst)
      tile_stage<BN, 1>(j + 1, nst, p, qm, obase, mbase, next, smem, full, empty, off0,
                        off1, acc, A);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4j + 2i + e]: column obase + c + i of row mbase + 8j + 2t + e.
  const int o = obase + c;
  if (o >= mb.O) return;
  const __nv_bfloat16* bias = (const __nv_bfloat16*)mb.bias;
  __nv_bfloat16* y = (__nv_bfloat16*)mb.y;
  const float s0 = mb.s[o], s1 = mb.s[o + 1];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = mbase + 8 * j + 2 * t + e;
      if (row < a.M)
        *(__nv_bfloat162*)(y + (size_t)row * mb.O + o) = __halves2bfloat162(
            out_x(acc[4 * j + e], s0, bias, o), out_x(acc[4 * j + 2 + e], s1, bias, o + 1));
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The cluster size along I for a grid of `base` CTAs over nk k-steps:
// doubled while the grid stays within one wave (`capacity` CTAs resident
// at once) and each rank keeps at least 2 k-steps a warp.
int cluster_size(int base, int nk, int capacity) {
  int c = 1;
  while (c < MAX_CLUSTER && base * 2 * c <= capacity &&
         nk / (2 * c) >= 2 * WARPS)
    c *= 2;
  return c;
}

int device_sms(int& sms) {
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && cache[dev]) {
    sms = cache[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) cache[dev] = sms;
  return 0;
}

// Per device: the CTAs of `kernel` resident on the card at once (its
// occupancy times the SM count), after raising its shared-memory limit to
// `smem`; computed at a kernel's first launch on the device.
template <typename Kernel>
int capacity(Kernel kernel, int smem, int threads, int (&cache)[MAX_DEVICES], int& out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && cache[dev]) {
    out = cache[dev];
    return 0;
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const int err = device_sms(sms);
  if (err) return err;
  out = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < MAX_DEVICES) cache[dev] = out;
  return 0;
}

// A decode-mode kernel for M rows: its rows a block, shared memory and
// resident capacity.
struct Plan {
  void (*kernel)(const Args);
  int rows, smem, cap;
};

template <int NT, typename X>
int mma_plan(Plan& pl) {
  static int cache[MAX_DEVICES];
  constexpr int smem = smem_bytes<NT, 2 * sizeof(X)>();
  pl = {w8a16_mma_kernel<NT, X>, 8 * NT, smem, 0};
  return capacity(w8a16_mma_kernel<NT, X>, smem, THREADS, cache, pl.cap);
}

// fp32 x stops at 16-row blocks: its three parts a pair cost registers.
int decode_plan(int M, int dtype, Plan& pl) {
  if (dtype == 0) return M <= 8 ? mma_plan<1, float>(pl) : mma_plan<2, float>(pl);
  if (M <= 8) return mma_plan<1, __nv_bfloat16>(pl);
  if (M <= 16) return mma_plan<2, __nv_bfloat16>(pl);
  return mma_plan<4, __nv_bfloat16>(pl);
}

// A decode-mode launch over `tiles` 128-column tiles (every member's) x
// blocks of pl.rows rows of x, with a cluster along I sized by
// cluster_size.
int launch_decode(const Args& a0, int tiles, const Plan& pl, cudaStream_t st) {
  Args a = a0;
  const int mblocks = (a.M + pl.rows - 1) / pl.rows;
  const int nk = a.I / KS;
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  const int csize = cluster_size(tiles * mblocks, nk, pl.cap);
  a.steps_per_cta = (nk + csize - 1) / csize;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * csize, mblocks, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, pl.kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// BN rows of x a tile-mode CTA: the one of 64, 128 and 256 whose grid
// takes the least time by the stage times measured on an H100 (PERF.md §6,
// tools/torch_w8a16_probe.py --crossover): a slab takes a CTA ~0.8 us at
// BN = 64 and 128 while fewer CTAs than the card holds leave it latency-
// bound, ~1.1 us at 256 (the products' share of the SM), and the grid runs
// in waves of one CTA an SM (two at 64). The larger on a tie (each
// widened level multiplies more rows).
int tile_bn(int M, int tiles, int& bn) {
  int sms = 0;
  const int e = device_sms(sms);
  if (e) return e;
  long long best = -1;
  for (int b = 256; b >= 64; b /= 2) {
    const int per_sm = b == 64 ? 2 : 1;
    const long long ctas = (long long)tiles * ((M + b - 1) / b);
    const long long waves = (ctas + (long long)sms * per_sm - 1) / ((long long)sms * per_sm);
    const long long stage = b == 256 ? 11 : 8;      // tenths of a microsecond
    if (best < 0 || waves * stage < best) {
      best = waves * stage;
      bn = b;
    }
  }
  return 0;
}

template <int BN>
int launch_tile_bn(const TileParams& p, int tiles, cudaStream_t st) {
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(w8a16_tile_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, TileCfg<BN>::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  const int mblocks = (p.a.M + BN - 1) / BN;
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  w8a16_tile_kernel<BN><<<dim3(tiles, mblocks, 1), TTHREADS, TileCfg<BN>::SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_tile(const Args& a, int tiles, cudaStream_t st) {
  int bn = 0;
  int e = tile_bn(a.M, tiles, bn);
  if (e) return e;
  TileParams p;
  p.a = a;
  {
    const cuuint64_t size[2] = {(cuuint64_t)a.I, (cuuint64_t)a.M};
    const cuuint64_t stride[1] = {(cuuint64_t)a.I * 2};
    const cuuint32_t box[2] = {TBK, (cuuint32_t)bn};
    e = oh_tma::encode(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, size, stride,
                       box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  for (int k = 0; k < a.n; ++k) {         // the kernel reads map k < n only
    const Member& m = a.m[k];
    const cuuint64_t size[2] = {(cuuint64_t)m.O, (cuuint64_t)a.I};
    const cuuint64_t stride[1] = {(cuuint64_t)m.O};
    const cuuint32_t box[2] = {TBO, TBK};
    e = oh_tma::encode(&p.qmap[k], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, m.q, size, stride,
                       box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  return bn == 256 ? launch_tile_bn<256>(p, tiles, st)
         : bn == 128 ? launch_tile_bn<128>(p, tiles, st)
                     : launch_tile_bn<64>(p, tiles, st);
}

// The tile mode for bf16 x where it beat the decode mode in
// tools/torch_w8a16_probe.py --crossover on an H100 (PERF.md §6): from M x
// O = 2^18 (all members' columns; 205 rows on [1280, 1280], 51 on a q/k/v
// group) while I <= 2560, from twice that at I = 5120, whose 80 slabs a
// tile-mode CTA walks in turn. Never at 32 rows or fewer.
bool takes_tile(int M, int I, int tiles, int dtype) {
  if (dtype != 1) return false;
  const long long cols = (long long)tiles * OT;
  return M > 32 && (long long)M * cols >= (1LL << 18) * (I > 2560 ? I / 2560 : 1);
}

// Fills a's members from the entry's arrays; returns the grid's column
// tiles, or -1 for an argument the kernel does not take.
int members(Args& a, int n, const void* const* q, const void* const* s,
            const void* const* bias, void* const* y, const int* O) {
  if (n < 1 || n > MAX_MEMBERS) return -1;
  int tiles = 0;
  for (int k = 0; k < MAX_MEMBERS; ++k) {
    if (k >= n) {
      a.m[k] = {nullptr, nullptr, nullptr, nullptr, 0, INT_MAX};
      continue;
    }
    if (O[k] <= 0 || O[k] % 16) return -1;
    a.m[k] = {(const int8_t*)q[k], (const float*)s[k], bias[k], y[k], O[k], tiles};
    tiles += (O[k] + OT - 1) / OT;
  }
  a.n = n;
  return tiles;
}

int run(const void* x, int n, const void* const* q, const void* const* s,
        const void* const* bias, void* const* y, const int* O, int M, int I,
        int dtype, cudaStream_t st) {
  if (M < 0 || I <= 0 || I % 16 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.M = M;
  a.I = I;
  const int tiles = members(a, n, q, s, bias, y, O);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  if (takes_tile(M, I, tiles, dtype)) return launch_tile(a, tiles, st);
  Plan pl;
  const int e = decode_plan(M, dtype, pl);
  if (e) return e;
  return launch_decode(a, tiles, pl, st);
}

}  // namespace

// n (1-3) products of the same x, yk = to_dtype((x @ qk) * sk) (+ bk,
// rounded again), see the header; one launch. x [M, I] (dtype 0 fp32, 1
// bf16), 16-byte aligned; member k: levels qk int8 [I, Ok], 16-byte
// aligned; scales sk fp32 [Ok]; bias bk x's dtype [Ok] or null; output yk
// x's dtype [M, Ok], 16-byte aligned. All contiguous; I and each Ok
// multiples of 16. The slots past n are ignored.
extern "C" int oh_w8a16_group(const void* x, const void* q0, const void* s0,
                              const void* b0, void* y0, int O0, const void* q1,
                              const void* s1, const void* b1, void* y1, int O1,
                              const void* q2, const void* s2, const void* b2,
                              void* y2, int O2, int n, int M, int I, int dtype,
                              void* stream) {
  const void* const q[MAX_MEMBERS] = {q0, q1, q2};
  const void* const s[MAX_MEMBERS] = {s0, s1, s2};
  const void* const b[MAX_MEMBERS] = {b0, b1, b2};
  void* const y[MAX_MEMBERS] = {y0, y1, y2};
  const int O[MAX_MEMBERS] = {O0, O1, O2};
  return run(x, n, q, s, b, y, O, M, I, dtype, (cudaStream_t)stream);
}

// The cluster size along I that a launch of M rows over `tiles` 128-column
// tiles takes (1 in the tile mode, which never splits I), or a negative
// cudaError_t. Two launches of one tile with the same cluster size sum
// each output in the same order.
extern "C" int oh_w8a16_cluster(int M, int I, int tiles, int dtype) {
  if (M <= 0 || I <= 0 || I % 16 || tiles <= 0 || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  if (takes_tile(M, I, tiles, dtype)) return 1;
  Plan pl;
  const int e = decode_plan(M, dtype, pl);
  if (e) return -e;
  return cluster_size(tiles * ((M + pl.rows - 1) / pl.rows), I / KS, pl.cap);
}
