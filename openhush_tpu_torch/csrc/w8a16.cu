// W8A16: the product of activations with the int8 decoder weights,
//   y[M, O] = to_x_dtype((sum_i x[m, i] * q[i, o]) * s[o])   (+ bias[o], rounded again)
// x bf16 or fp32 [M, I] row-major, q int8 levels [I, O] row-major (as
// quantize_decoder_weights stores them), s fp32 per-output-channel scales
// [O], the sum in fp32. With a bias the rounded product gets bias[o] added
// and is rounded once more, which is what the plain code's `_mm(x, w) + b`
// does in x's dtype; the fold saves that add's launch. I and O are multiples
// of 16.
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
// cross-KV's M = B*1500 the operations (2*M*I*O) bound it. The design:
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
//   the grid stays within one wave of resident CTAs (the kernel's
//   occupancy times the SM count) and each rank keeps 2 k-steps a warp: a
//   [1280, 1280] product at M = 1 is 80 CTAs and not 10. The partial sums
//   meet in a fixed order: the 4 warps through shared memory, then the
//   cluster's ranks, each pushing its sums to the rank that owns them
//   (one-sided stores to distributed shared memory, one cluster barrier),
//   which adds them in rank order. No atomics: two launches give the same
//   bits.
// - The epilogue multiplies the fp32 sum by s[o] (one rounding, as the
//   plain `y * s`), rounds once to x's dtype, then adds the bias and rounds
//   again if there is one (__fmul_rn/__fadd_rn: nvcc would contract them).
// - Large M (prefill, the cross-KV at B*1500 rows) takes 32-row blocks of x
//   in the grid's y and re-reads the weights' tile for each from L2; no
//   cluster once the grid fills the card, and a thread stores its two
//   adjacent columns at once. Right, not tuned: a wgmma tile with the
//   widening in shared memory is the option for it.
// - fp32 x (the tests' tiny model) runs on the CUDA cores: a lane's 4
//   columns of a row are one 4-byte load, widened exactly as above, times
//   8 rows of x by fmaf, the partial sums met as above. Never TF32, never
//   bf16.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/torch_w8a16_probe.py, 64 MB
// of levels rotated, so each launch reads them from device memory): a
// [1280, 1280] product at M = 1 takes 0.0064 ms; in one run beside it, a
// build that returns at entry took 0.0019, one that only loads its levels
// 0.0042 and one that loads and multiplies 0.0046, so the reduction takes
// the last ~0.0018. Launch- and latency-bound: ~13x the byte bound of
// 0.00049 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                  // a CTA's warps, over its k-range
constexpr int THREADS = WARPS * 32;
constexpr int OT = 128;                   // output columns a CTA (and a warp)
constexpr int KS = 16;                    // rows of q a k-step: one mma's depth
constexpr int STAGES = 4;                 // k-steps in flight a warp
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_DEVICES = 64;

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  const void* bias;                       // x's dtype [O], or null
  void* y;
  int M, I, O;
  int steps_per_cta;                      // k-steps of a cluster rank's range
};

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
template <int NT>
__device__ __forceinline__ void copy_step(uint32_t wslot, uint32_t xslot,
                                          const int8_t* qcol, int o_bytes,
                                          const __nv_bfloat16* const (&xrow)[NT],
                                          const int (&x_bytes)[NT], int O,
                                          int t, int kb, int st) {
  const int krow[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    cp16(wslot + ((st * 4 + c) * 32) * 16, qcol + (size_t)(kb + krow[c]) * O,
         o_bytes);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cp4(xslot + (((st * NT + nt) * 2 + h) * 32) * 4, xrow[nt] + kb + 8 * h,
          x_bytes[nt]);
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

template <int NT>
__host__ __device__ constexpr int pipe_bytes() {
  return WARPS * STAGES * (4 * 32 * 16 + NT * 2 * 32 * 4);
}
template <int NREG>
__host__ __device__ constexpr int red_bytes() {
  return WARPS * NREG * 32 * 4;
}
template <int NT>
__host__ __device__ constexpr int smem_bytes() {  // max(ring, red) + recv
  return (pipe_bytes<NT>() > red_bytes<NT * 32>() ? pipe_bytes<NT>()
                                                  : red_bytes<NT * 32>()) +
         NT * 32 * 32 * 4;
}

// bf16 x: one CTA = (cluster rank: a k-range, 128 output columns, 8*NT rows
// of x). Accumulator acc[(nt * 8 + j) * 4 + d], d = 2h + e: output column
// 16g + 2j + h of row 8nt + 2t + e.
template <int NT>
__global__ void __launch_bounds__(THREADS) w8a16_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_arrive_relaxed();
  const int rank = cluster_ctarank();
  const int csize = cluster_nctarank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int obase = (blockIdx.x / csize) * OT;
  const int mbase = blockIdx.y * 8 * NT;
  const int nk = a.I / KS;
  const int k_begin = rank * a.steps_per_cta;
  const int k_end = min(nk, k_begin + a.steps_per_cta);
  const int first = k_begin + warp;
  const int nsteps = first < k_end ? (k_end - first + WARPS - 1) / WARPS : 0;

  const int ocol = obase + 16 * g;
  const int o_bytes = ocol < a.O ? 16 : 0;
  const int8_t* qcol = a.q + (o_bytes ? ocol : 0);
  const __nv_bfloat16* xrow[NT];
  int x_bytes[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = mbase + 8 * nt + g;
    x_bytes[nt] = m < a.M ? 4 : 0;
    xrow[nt] = (const __nv_bfloat16*)a.x + (size_t)(m < a.M ? m : 0) * a.I + 2 * t;
  }
  const uint32_t wslot = smem_u32(smem) + (warp * STAGES * 4 * 32 + lane) * 16;
  const uint32_t xslot = smem_u32(smem) + WARPS * STAGES * 4 * 32 * 16 +
                         (warp * STAGES * NT * 2 * 32 + lane) * 4;

  constexpr int NREG = NT * 32;
  float acc[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) acc[r] = 0.0f;

  for (int s = 0; s < STAGES && s < nsteps; ++s)
    copy_step<NT>(wslot, xslot, qcol, o_bytes, xrow, x_bytes, a.O, t,
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
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("ld.shared.u32 %0, [%1];\n"
                     : "=r"(b[nt][h])
                     : "r"(xslot + (((st * NT + nt) * 2 + h) * 32) * 4));
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
          mma_bf16(d[0], d[1], d[2], d[3], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
      }
    }
    if (s + STAGES < nsteps)
      copy_step<NT>(wslot, xslot, qcol, o_bytes, xrow, x_bytes, a.O, t,
                (first + WARPS * (s + STAGES)) * KS, st);
  }

  const __nv_bfloat16* bias = (const __nv_bfloat16*)a.bias;
  __nv_bfloat16* y = (__nv_bfloat16*)a.y;
  // Element e: register r = e / 32 = (nt * 8 + j) * 4 + 2h + e', lane e %
  // 32. A unit pairs h = 0 and 1 (registers r and r + 2): columns o, o + 1.
  auto where = [&](int e, int& row, int& o) {
    const int ul = e & 31, r = e >> 5, blk = r >> 2;
    row = mbase + 8 * (blk >> 3) + 2 * (ul & 3) + (r & 1);
    o = obase + 16 * (ul >> 2) + 2 * (blk & 7) + ((r >> 1) & 1);
  };
  auto value = [&](float v, int o) {
    const __nv_bfloat16 yv = __float2bfloat16_rn(__fmul_rn(v, a.s[o]));
    return bias ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(yv),
                                                __bfloat162float(bias[o])))
                : yv;
  };
  reduce<NREG, 64>(acc, (float*)smem,
                   (float*)(smem + smem_bytes<NT>()) - NREG * 32, rank, csize,
                   [&](int e, float v) {
    int row, o;
    where(e, row, o);
    if (row < a.M && o < a.O) y[(size_t)row * a.O + o] = value(v, o);
  }, [&](int e, float v0, float v1) {
    int row, o;
    where(e, row, o);
    if (row < a.M && o < a.O)
      *(__nv_bfloat162*)(y + (size_t)row * a.O + o) =
          __halves2bfloat162(value(v0, o), value(v1, o + 1));
  });
}

// fp32 x on the CUDA cores: a CTA = (cluster rank: a k-range, 128 output
// columns, 4 a lane, 8 rows of x); its warps over interleaved rows of q.
// Accumulator acc[m * 4 + k]: column 4 * lane + k of row m.
constexpr int F32_ROWS = 8;

__global__ void __launch_bounds__(THREADS) w8a16_f32_kernel(const Args a) {
  constexpr int NREG = F32_ROWS * 4;
  __shared__ __align__(16) float red[WARPS * NREG * 32];
  __shared__ __align__(16) float recv[NREG * 32];
  cluster_arrive_relaxed();
  const int rank = cluster_ctarank();
  const int csize = cluster_nctarank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int obase = (blockIdx.x / csize) * OT;
  const int o = obase + 4 * lane;
  const int mbase = blockIdx.y * F32_ROWS;
  const float* x = (const float*)a.x;
  const bool o_in = o < a.O;
  const int i_end = min(a.I, (rank + 1) * a.steps_per_cta * KS);
  float acc[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int i = rank * a.steps_per_cta * KS + warp; i < i_end; i += WARPS) {
    const uint32_t u =
        o_in ? __ldg((const unsigned int*)(a.q + (size_t)i * a.O + o)) : 0u;
    const uint32_t b = u ^ 0x80808080u;
    const float wq[4] = {level(b, 0x7650), level(b, 0x7651), level(b, 0x7652),
                         level(b, 0x7653)};
#pragma unroll
    for (int m = 0; m < F32_ROWS; ++m) {
      const int row = mbase + m;
      const float xv = row < a.M ? __ldg(x + (size_t)row * a.I + i) : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m * 4 + k] = fmaf(xv, wq[k], acc[m * 4 + k]);
    }
  }
  const float* bias = (const float*)a.bias;
  float* y = (float*)a.y;
  // Element e: register r = e / 32 = m * 4 + k, lane e % 32. A unit pairs
  // k and k + 1 (registers r and r + 1): columns col, col + 1.
  auto value = [&](float v, int col) {
    const float yv = __fmul_rn(v, a.s[col]);
    return bias ? __fadd_rn(yv, bias[col]) : yv;
  };
  reduce<NREG, 32>(acc, red, recv, rank, csize, [&](int e, float v) {
    const int row = mbase + (e >> 5) / 4, col = obase + 4 * (e & 31) + (e >> 5) % 4;
    if (row < a.M && col < a.O) y[(size_t)row * a.O + col] = value(v, col);
  }, [&](int e, float v0, float v1) {
    const int row = mbase + (e >> 5) / 4, col = obase + 4 * (e & 31) + (e >> 5) % 4;
    if (row < a.M && col < a.O)
      *(float2*)(y + (size_t)row * a.O + col) =
          make_float2(value(v0, col), value(v1, col + 1));
  });
}

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

// Per device: the CTAs of `kernel` resident on the card at once (its
// occupancy times the SM count), after raising its shared-memory limit to
// `smem`; computed at a kernel's first launch on the device.
template <typename Kernel>
int capacity(Kernel kernel, int smem, int (&cache)[MAX_DEVICES], int& out) {
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < MAX_DEVICES) cache[dev] = out;
  return 0;
}

// A launch of `kernel` over 128-column tiles of O x blocks of `rows` rows
// of x, with a cluster along I sized by cluster_size.
template <typename Kernel>
int launch(Kernel kernel, const Args& a0, int rows, int smem, int cap,
           cudaStream_t st) {
  Args a = a0;
  const int otiles = (a.O + OT - 1) / OT;
  const int mblocks = (a.M + rows - 1) / rows;
  const int nk = a.I / KS;
  if (mblocks > 65535) return (int)cudaErrorInvalidValue;
  const int csize = cluster_size(otiles * mblocks, nk, cap);
  a.steps_per_cta = (nk + csize - 1) / csize;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(otiles * csize, mblocks, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NT>
int launch_mma(const Args& a, cudaStream_t st) {
  static int cache[MAX_DEVICES];
  constexpr int smem = smem_bytes<NT>();
  int cap = 0;
  const int e = capacity(w8a16_mma_kernel<NT>, smem, cache, cap);
  if (e) return e;
  return launch(w8a16_mma_kernel<NT>, a, 8 * NT, smem, cap, st);
}

int launch_f32(const Args& a, cudaStream_t st) {
  static int cache[MAX_DEVICES];
  int cap = 0;
  const int e = capacity(w8a16_f32_kernel, 0, cache, cap);
  if (e) return e;
  return launch(w8a16_f32_kernel, a, F32_ROWS, 0, cap, st);
}

}  // namespace

// y = to_dtype((x @ q) * s) (+ bias, rounded again), see the header.
// x [M, I] (dtype 0 fp32, 1 bf16), 16-byte aligned; q int8 [I, O], 16-byte
// aligned; s fp32 [O]; bias x's dtype [O] or null; y x's dtype [M, O],
// 16-byte aligned. All contiguous; I and O multiples of 16.
extern "C" int oh_w8a16(const void* x, const void* q, const void* s,
                        const void* bias, void* y, int M, int I, int O,
                        int dtype, void* stream) {
  if (M < 0 || I <= 0 || O <= 0 || I % 16 || O % 16 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const Args a = {x, (const int8_t*)q, (const float*)s, bias, y, M, I, O, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32(a, st);
  if (M <= 8) return launch_mma<1>(a, st);
  if (M <= 16) return launch_mma<2>(a, st);
  return launch_mma<4>(a, st);
}
