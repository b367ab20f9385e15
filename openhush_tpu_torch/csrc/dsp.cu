// The three first-order recurrences of the daemon's audio front, each a
// sequential walk in sample or frame order:
//   oh_envelope     the compressor's attack/release envelope follower;
//                   replaces openhush_tpu/ops/dsp.py:39 _follow_envelope
//                   (lax.scan): coeff = a > env ? attack : release,
//                   env = coeff*env + (1-coeff)*a, from env = 0;
//   oh_limiter_gain the limiter's gain; replaces the lax.scan in
//                   openhush_tpu/ops/dsp.py:69 limit: g = tg < g ? tg :
//                   rc*g + (1-rc)*tg, from g = 1;
//   oh_noise_floor  the Wiener denoiser's per-band noise floor; replaces the
//                   lax.scan in openhush_tpu/ops/denoise.py:144 wiener_gains:
//                   rate = le < floor ? 0.3 : 0.003,
//                   floor = floor + rate*(le - floor), from floor0, per band.
// Each writes its carried value after every step. Everything elementwise
// before or after a recurrence (|x|, the target gains, the dB and 10**x
// maps, the Wiener rule) stays in PyTorch.
//
// Parity: each step is the reference's operations in the reference's order,
// every product and sum rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn,
// which nvcc never contracts into an FMA), so a kernel's output equals its
// plain PyTorch version's (ops/dsp.py, ops/denoise.py) bit for bit. No
// --use_fast_math (ops/_build.py): denormals stay.
//
// The envelope and the limiter's gain: segment-parallel walks with an exact
// carry. A 30 s window is 480,000 dependent steps; walked by one thread
// (the serial walk, chain_kernel below, still callable as oh_*_serial as
// the card's bit reference) it takes ~22 cycles a step, 5.4 ms. Here the
// signal is cut into segments of SEG = 512 samples, and three kernels give
// every segment its exact start:
//  1. summary_kernel, a thread a segment and a walk: a lane of warp 0 walks
//     from a low start `lo`, a lane of warp 1 from a high start `hi`, over
//     the segment and the WARM segments before it (W = WARM*SEG samples of
//     warm-up; the first WARM segments' windows start at sample 0, and both
//     walks there at the exact initial value). If the two ends are equal
//     (and not zero), the segment's end is E whatever the state at the
//     window's start was, as long as it lay in [lo, hi]. It also records
//     whether the segment is one repeated value v (a run).
//  2. carry_kernel, a warp a signal, in segment order: S[k], the state
//     before segment k, is exact; S[k+1] =
//       E_k    if segment k met and lo_k <= S[k-WARM] <= hi_k (the state
//              at its window's start: W is a whole number of segments, so
//              the carry knows it exactly);
//       S[k]   if segment k is a run of v and step(S[k], v) has the bits of
//              S[k] (a fixed point: SEG steps of it give it back);
//       else   the exact walk of segment k from S[k], by one lane.
//     32 lanes take 32 segments at once: each assumes the ends the rules
//     give the lanes before it, and the first lane whose rule fails ends
//     the round; every lane before it is exact by induction.
//  3. output_kernel, a thread a segment: walks it from S[k] with the plain
//     step and writes every state, through shared memory.
// The carry and the output pass launch while the kernel before them runs
// (programmatic dependent launch) and wait for its results.
//
// Exactness, on every input. A step is affine in the state in each branch
// with coefficients >= 0, and round-to-nearest is monotone, so each branch
// is nondecreasing in the state; the select alone breaks monotony, by an
// ulp, at the ~0.07% of inputs x where rc*x + (1-rc)*x (the branches at
// state x) does not round to x (tests/test_torch_dsp.py finds such x).
// So the summary walks monotone hulls m <= step <= M instead, exact
// functions of the state with the sample's constants c1, c2 (computed once
// a sample, before the walks):
//   limiter  m(g) = min(x, r(g)),  M(g) = x < g ? max(x, r(x)) : r(g),
//            r(g) = rc*g + (1-rc)*x: M is the step's supremum over states
//            <= g, m a lower bound of its infimum over states >= g;
//   envelope m(e) = x > e ? min(up(e), down(x)) : down(e),
//            M(e) = x > e ? up(e) : max(down(e), up(pred x)),
//            up/down the attack/release branches: the infimum over states
//            >= e and the supremum over states <= e.
// lo <= s <= hi at the window's start then gives m-walk <= true <= M-walk
// at every step, and equal ends fix the true end's value (a nonzero float
// has one bit pattern, hence the "not zero" rule). A segment meets only
// where this holds: coefficients > 0 and every sample of its window finite
// (then no state is NaN; +-inf states keep the order). The bounds need no
// proof: the carry checks them against the exact state. They are lo = 0
// for both; hi = +inf for the limiter (M(+inf) = max(x, r(x)), the step's
// bound for every state), and for the envelope the largest sample of the
// segment's window (the envelope sits below the largest recent |x| once
// the compressor's release has run for a fraction of the window).
//
// Why they meet: the limiter resets (g = tg at a peak below both walks),
// the envelope contracts (by the attack or release coefficient a step).
// On speech-like audio every segment of a 30 s window meets with W = 4096
// (limiter) and 8192 (envelope) samples of warm-up; tests/test_torch_dsp.py
// models the plan in float32 and holds it to the plain loops. Inputs that
// keep the state uncertain longer than W (one peak and then a long quiet,
// a release into digital silence, where the envelope settles on the
// denormal 400*2^-149 after ~77,000 steps, peaks too sparse for the
// release to contract) fall back on the carry's walks, toward the serial
// walk's time, and stay exact.
//
// Bound on an H100: the bytes, read once and written once (3.84 MB a 30 s
// window, 1.15 us at 3.35 TB/s), plus the walk the design cannot avoid:
// (WARM+1)*SEG steps of the summary and SEG of the output pass, at the
// cycles a step measured on an H100 80GB HBM3 at 700 W
// (tools/torch_dsp_probe.py --cycles: the limiter's low walk 15.4, its high
// walk 21.4, the envelope's 21.4 and 22.2; chip_smoke.py times the bound
// at the serial walk's time a step). The serial walk's chain (480,000
// steps) is no longer a bound, only the old design's floor.
//
// The noise floor keeps the serial walk: its chain is 3000 frames (22
// bands, one lane each), 0.06 ms. chain_kernel: one CTA per signal; the
// chain's lanes are threads of warp 0, and warps 1-3 stream the signal
// through three shared-memory tiles in coalesced loads and stores: while
// the chain walks tile i, they load tile i+1 and store tile i-1.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// The steps, and the hulls the summary walks
// ---------------------------------------------------------------------------

enum Walk { EXACT, LOW, HIGH };

// a > b ? x : y and a < b ? x : y as a compare and a select, never a
// branch: the lanes of a warp walk different segments, and a branch on
// their data would diverge at every step.
__device__ __forceinline__ float sel_gt(float a, float b, float x, float y) {
  float r;
  asm("{.reg .pred p; setp.gt.f32 p, %1, %2; selp.f32 %0, %3, %4, p;}"
      : "=f"(r) : "f"(a), "f"(b), "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float sel_lt(float a, float b, float x, float y) {
  float r;
  asm("{.reg .pred p; setp.lt.f32 p, %1, %2; selp.f32 %0, %3, %4, p;}"
      : "=f"(r) : "f"(a), "f"(b), "f"(x), "f"(y));
  return r;
}

// chain<W>(s, x, c1, c2): one step of walk W from state s over sample x;
// c1 and c2 are the sample's hull constants (consts(), computed once a
// sample before the walks, off their chains).
struct LimiterGain {
  static constexpr int WARM = 8;      // warm-up segments: W = 4096 samples
  float rc, c;                        // c = 1 - rc
  __device__ float init() const { return 1.0f; }
  // The hulls below are monotone and bracket the step for rc > 0.
  __device__ bool summarizable() const { return rc > 0.0f; }
  __device__ float hi_start(float) const { return __int_as_float(0x7f800000); }
  // c1 = max(x, r(x)), r(x) = rc*x + (1-rc)*x rounded; c2 unused.
  __device__ void consts(float x, float& c1, float& c2) const {
    c1 = fmaxf(x, __fadd_rn(__fmul_rn(rc, x), __fmul_rn(c, x)));
    c2 = 0.0f;
  }
  template <int W>
  __device__ float chain(float g, float x, float c1, float) const {
    const float r = __fadd_rn(__fmul_rn(rc, g), __fmul_rn(c, x));
    if constexpr (W == LOW) return fminf(x, r);
    else if constexpr (W == HIGH) return sel_lt(x, g, c1, r);
    else return sel_lt(x, g, x, r);
  }
  __device__ float step(float g, float x) const {
    return chain<EXACT>(g, x, 0.0f, 0.0f);
  }
};

// Both of the envelope's branches are computed and one is selected: the
// same operations on the same values as selecting the coefficient first,
// but the compare no longer heads the chain (multiply, add, select).
struct Envelope {
  static constexpr int WARM = 16;     // W = 8192 samples
  float attack, release, ca, cr;      // ca = 1 - attack, cr = 1 - release
  __device__ float init() const { return 0.0f; }
  __device__ bool summarizable() const {
    return attack > 0.0f && release > 0.0f;
  }
  __device__ float hi_start(float window_max) const { return window_max; }
  // c1 = down(a); c2 = up(pred a) (up(a), a looser bound, where a <= 0).
  __device__ void consts(float a, float& c1, float& c2) const {
    const float am =
        sel_gt(a, 0.0f, __int_as_float(__float_as_int(a) - 1), a);
    c1 = __fadd_rn(__fmul_rn(release, a), __fmul_rn(cr, a));
    c2 = __fadd_rn(__fmul_rn(attack, am), __fmul_rn(ca, a));
  }
  template <int W>
  __device__ float chain(float env, float a, float c1, float c2) const {
    const float up = __fadd_rn(__fmul_rn(attack, env), __fmul_rn(ca, a));
    const float down = __fadd_rn(__fmul_rn(release, env), __fmul_rn(cr, a));
    if constexpr (W == LOW) return sel_gt(a, env, fminf(up, c1), down);
    else if constexpr (W == HIGH) return sel_gt(a, env, up, fmaxf(down, c2));
    else return sel_gt(a, env, up, down);
  }
  __device__ float step(float env, float a) const {
    return chain<EXACT>(env, a, 0.0f, 0.0f);
  }
};

struct NoiseFloor {
  __device__ float step(float floor, float le) const {
    const float rate = le < floor ? 0.3f : 0.003f;
    return __fadd_rn(floor, __fmul_rn(rate, __fsub_rn(le, floor)));
  }
};

// ---------------------------------------------------------------------------
// Segments in shared memory
// ---------------------------------------------------------------------------

constexpr int SEG = 512;              // samples a segment
constexpr int PAD = 36;               // floats after each shared row: the
constexpr int ROW = SEG + PAD;        // lanes' rows fall on other banks
                                      // (ROW = 4 mod 32), and a walk reads
                                      // one block past a row's end
constexpr int OUT_SEGS = 32;          // segments an output CTA (a lane each)

__device__ __forceinline__ int seg_len(int r, long long n) {
  return (int)min((long long)SEG, n - (long long)r * SEG);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src));
}

// Segments [j0, j1) of one signal into shared rows (row r - j0 at
// sm + (r - j0) * ROW). Where the signal's rows are 16-byte aligned (and
// so a multiple of 4 samples long), thread 0 hands each row to the copy
// engine as one bulk copy completing on the mbarrier `bar`; otherwise
// every thread copies 4 bytes at a time. Every thread returns once the
// rows are in shared memory (a kernel stages once: `bar` completes its
// phase 0).
__device__ void stage_rows(float* sm, const float* src, long long n, int j0,
                           int j1, bool aligned, unsigned long long* bar) {
  if (aligned) {
    if (threadIdx.x == 0) {
      unsigned bytes = 0;
      for (int r = j0; r < j1; ++r) bytes += seg_len(r, n) * 4;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem(bar)),
          "r"(bytes)
          : "memory");
      for (int r = j0; r < j1; ++r)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem(sm + (r - j0) * ROW)),
            "l"(src + (long long)r * SEG), "r"(seg_len(r, n) * 4),
            "r"(smem(bar))
            : "memory");
    }
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
          "0; selp.u32 %0, 1, 0, p; }\n"
          : "=r"(done)
          : "r"(smem(bar))
          : "memory");
  } else {
    const int total = (j1 - j0) * SEG;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = j0 + e / SEG, o = e % SEG;
      const long long g = (long long)r * SEG + o;
      if (g < n) cp_async4(sm + (r - j0) * ROW + o, src + g);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }
}

// The mbarrier of stage_rows, by thread 0, before a __syncthreads.
__device__ __forceinline__ void init_bar(unsigned long long* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

__device__ void store_rows(float* dst, const float* sm, long long n, int j0,
                           int j1, bool aligned) {
  constexpr int QUADS = SEG / 4;
  const int total = (j1 - j0) * QUADS;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = j0 + e / QUADS, q = e % QUADS;
    const long long g = (long long)r * SEG + 4 * q;
    const float* s = sm + (r - j0) * ROW + 4 * q;
    if (aligned && g + 4 <= n) {
      *reinterpret_cast<float4*>(dst + g) =
          *reinterpret_cast<const float4*>(s);
    } else {
      for (int u = 0; u < 4; ++u)
        if (g + u < n) dst[g + u] = s[u];
    }
  }
}

constexpr int BLOCK = 8;              // samples a walk reads at a time

// Block b of a row (and of its constants' rows) into registers.
template <int W>
__device__ __forceinline__ void read_block(const float* x, const float* c1,
                                           const float* c2, int b,
                                           float (&v)[BLOCK],
                                           float (&p)[BLOCK],
                                           float (&q)[BLOCK]) {
#pragma unroll
  for (int h = 0; h < BLOCK; h += 4) {
    const int o = b * BLOCK + h;
    const float4 u = *reinterpret_cast<const float4*>(x + o);
    v[h] = u.x, v[h + 1] = u.y, v[h + 2] = u.z, v[h + 3] = u.w;
    if constexpr (W != EXACT) {
      const float4 e = *reinterpret_cast<const float4*>(c1 + o);
      const float4 f = *reinterpret_cast<const float4*>(c2 + o);
      p[h] = e.x, p[h + 1] = e.y, p[h + 2] = e.z, p[h + 3] = e.w;
      q[h] = f.x, q[h + 1] = f.y, q[h + 2] = f.z, q[h + 3] = f.w;
    } else {
      p[h] = p[h + 1] = p[h + 2] = p[h + 3] = 0.0f;
      q[h] = q[h + 1] = q[h + 2] = q[h + 3] = 0.0f;
    }
  }
}

// One walk over `len` samples of a shared row x (16-byte aligned, PAD >=
// BLOCK readable floats after it), with the hull constants in rows c1 and
// c2 at the same offsets (unused by the exact walk). Each block's chain
// runs beside the next block's reads, which it never waits on (the last
// read falls in the padding and is dropped). With OUT, each state is
// written over its sample.
template <int W, bool OUT, class Op>
__device__ __forceinline__ float walk_row(const Op& op, float s, float* x,
                                          const float* c1, const float* c2,
                                          int len) {
  float v[BLOCK], p[BLOCK], q[BLOCK], vn[BLOCK], pn[BLOCK], qn[BLOCK];
  read_block<W>(x, c1, c2, 0, v, p, q);
  const int blocks = len / BLOCK;
  for (int b = 0; b < blocks; ++b) {
    read_block<W>(x, c1, c2, b + 1, vn, pn, qn);
    float y[BLOCK];
#pragma unroll
    for (int i = 0; i < BLOCK; ++i)
      y[i] = s = op.template chain<W>(s, v[i], p[i], q[i]);
    if constexpr (OUT) {
      float* o = x + b * BLOCK;
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(y[4], y[5], y[6], y[7]);
    }
#pragma unroll
    for (int i = 0; i < BLOCK; ++i) v[i] = vn[i], p[i] = pn[i], q[i] = qn[i];
  }
  for (int t = blocks * BLOCK; t < len; ++t) {
    s = op.template chain<W>(s, x[t], W == EXACT ? 0.0f : c1[t],
                             W == EXACT ? 0.0f : c2[t]);
    if constexpr (OUT) x[t] = s;
  }
  return s;
}

// ---------------------------------------------------------------------------
// 1. Segment summaries
// ---------------------------------------------------------------------------

// Programmatic dependent launch: a kernel lets the next one in the stream
// start (launch_dependents), and that one waits for this one's completion
// and memory before reading what it wrote (wait).
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr int SUM_SEGS = 16;          // segments a summary CTA

// Per segment k of a signal: summ[k] = {E or NaN, lo, hi, v} (E: the end
// both walks reached; lo, hi: their starts; v: the segment's first
// sample), run[k] = whether every sample of segment k has v's bits.
// Grid: `chunks` CTAs per signal, SUM_SEGS segments each; 64 threads, the
// first SUM_SEGS lanes of warp 0 walk low, of warp 1 high. Shared memory:
// the window's rows of x, then of each hull constant.
template <class Op>
__global__ void __launch_bounds__(64)
summary_kernel(const float* __restrict__ x, long long n, int ns, int chunks,
               Op op, bool aligned, float4* __restrict__ summ,
               int* __restrict__ run) {
  constexpr int ROWS = SUM_SEGS + Op::WARM;
  extern __shared__ __align__(16) float sm[];
  float* const c1 = sm + ROWS * ROW;
  float* const c2 = c1 + ROWS * ROW;
  __shared__ float row_max[ROWS];
  __shared__ int row_finite[ROWS];
  __shared__ float starts[2][SUM_SEGS], ends[2][SUM_SEGS];
  __shared__ unsigned long long bar;
  const int sig = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * SUM_SEGS;
  const int k1 = min(ns, k0 + SUM_SEGS);
  const int j0 = max(0, k0 - Op::WARM);
  summ += (long long)sig * ns;
  run += (long long)sig * ns;
  pdl_trigger();
  init_bar(&bar);
  __syncthreads();
  stage_rows(sm, x + (long long)sig * n, n, j0, k1, aligned, &bar);
  __syncthreads();

  // The hull constants of every staged sample, once, four at a time.
  const int quads = (k1 - j0) * (SEG / 4);
#pragma unroll 4
  for (int e = threadIdx.x; e < quads; e += blockDim.x) {
    const int i = e / (SEG / 4) * ROW + e % (SEG / 4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(sm + i);
    float4 a, b;
    op.consts(v.x, a.x, b.x);
    op.consts(v.y, a.y, b.y);
    op.consts(v.z, a.z, b.z);
    op.consts(v.w, a.w, b.w);
    *reinterpret_cast<float4*>(c1 + i) = a;
    *reinterpret_cast<float4*>(c2 + i) = b;
  }
  // Each staged row's largest sample, whether all its samples are finite,
  // and whether an own row is a run (four lanes of partial results).
  if (threadIdx.x < k1 - j0) {
    const int r = j0 + threadIdx.x, len = seg_len(r, n);
    const float* row = sm + threadIdx.x * ROW;
    const unsigned v = __float_as_uint(row[0]);
    float mx[4] = {row[0], row[0], row[0], row[0]};
    bool same = true, finite = true;
    int t = 0;
#pragma unroll 4
    for (; t + 4 <= len; t += 4) {
      const float4 u = *reinterpret_cast<const float4*>(row + t);
      const float w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const unsigned b = __float_as_uint(w[h]);
        mx[h] = fmaxf(mx[h], w[h]);
        same &= b == v;
        finite &= (b & 0x7f800000u) != 0x7f800000u;
      }
    }
    for (; t < len; ++t) {
      const unsigned b = __float_as_uint(row[t]);
      mx[0] = fmaxf(mx[0], row[t]);
      same &= b == v;
      finite &= (b & 0x7f800000u) != 0x7f800000u;
    }
    row_max[threadIdx.x] = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_finite[threadIdx.x] = finite;
    if (r >= k0) run[r] = same;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = k0 + lane;
  if (lane < SUM_SEGS && k < k1) {
    const int first = max(0, k - Op::WARM);
    float s;
    if (k < Op::WARM) {
      s = op.init();
    } else if (warp == 0) {
      s = 0.0f;                       // lo, for both recurrences
    } else {
      float mx = row_max[first - j0];
      for (int r = first + 1; r <= k; ++r) mx = fmaxf(mx, row_max[r - j0]);
      s = op.hi_start(mx);
    }
    starts[warp][lane] = s;
    for (int r = first; r <= k; ++r) {
      const int o = (r - j0) * ROW, len = seg_len(r, n);
      s = warp == 0 ? walk_row<LOW, false>(op, s, sm + o, c1 + o, c2 + o, len)
                    : walk_row<HIGH, false>(op, s, sm + o, c1 + o, c2 + o,
                                            len);
    }
    ends[warp][lane] = s;
  }
  __syncthreads();
  if (warp == 0 && lane < SUM_SEGS && k < k1) {
    // A met end counts only where the hulls hold: positive coefficients
    // and finite samples over the whole window (no NaN state can arise).
    bool finite = true;
    for (int r = max(0, k - Op::WARM); r <= k; ++r)
      finite &= row_finite[r - j0] != 0;
    const float lo = ends[0][lane], hi = ends[1][lane];
    const bool met = op.summarizable() && finite && lo == hi && lo != 0.0f;
    summ[k] = make_float4(met ? lo : __int_as_float(0x7fffffff),
                          starts[0][lane], starts[1][lane],
                          sm[(k - j0) * ROW]);
  }
}

// ---------------------------------------------------------------------------
// 2. The carry
// ---------------------------------------------------------------------------

constexpr int CARRY_CHUNK = 1024;     // summaries staged at a time
constexpr int HIST = 64;              // ring of the last starts (> WARM)

// The exact walk of segment k from s: the warp loads it, lane 0 walks.
template <class Op>
__device__ float walk_segment(const Op& op, const float* src, long long n,
                              int k, float s, float* seg, int lane) {
  const long long g = (long long)k * SEG;
  const int len = seg_len(k, n);
  __syncwarp();
#pragma unroll 4
  for (int i = lane; i < len; i += 32) seg[i] = src[g + i];
  __syncwarp();
  if (lane == 0) s = walk_row<EXACT, false>(op, s, seg, seg, seg, len);
  return __shfl_sync(FULL, s, 0);
}

// S: [n_sig, ns + 1], S[k] the state before segment k's first sample.
// Grid: one warp per signal.
template <class Op>
__global__ void __launch_bounds__(32)
carry_kernel(const float* __restrict__ x, long long n, int ns, Op op,
             const float4* __restrict__ summ, const int* __restrict__ run,
             float* __restrict__ S) {
  __shared__ float4 s_summ[CARRY_CHUNK];
  __shared__ int s_run[CARRY_CHUNK];
  __shared__ float hist[HIST];
  __shared__ __align__(16) float seg[ROW];
  const int sig = blockIdx.x, lane = threadIdx.x;
  pdl_trigger();
  pdl_wait();                         // the summaries are written
  const float* src = x + (long long)sig * n;
  summ += (long long)sig * ns;
  run += (long long)sig * ns;
  S += (long long)sig * (ns + 1);
  const float init = op.init();
  float cur = init;                   // S[base], exact
  if (lane == 0) {
    S[0] = init;
    hist[0] = init;
  }
  int c_lo = 0, c_hi = 0;
  for (int base = 0; base < ns;) {
    if (base >= c_hi) {
      c_lo = base;
      c_hi = min(ns, base + CARRY_CHUNK);
      __syncwarp();
      for (int i = lane; i < c_hi - c_lo; i += 32) {
        cp_async16(s_summ + i, summ + c_lo + i);
        cp_async4(s_run + i, run + c_lo + i);
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncwarp();
    }
    const int k = base + lane;
    const bool act = k < c_hi;
    const float4 sm = act ? s_summ[k - c_lo]
                          : make_float4(__int_as_float(0x7fffffff), 0.f, 0.f,
                                        0.f);
    const bool is_run = act && s_run[k - c_lo];
    const bool met = act && sm.x == sm.x;
    // Each lane's end if every lane up to it is taken: the end of the last
    // met lane at or before it, else the round's start.
    const unsigned upto = __ballot_sync(FULL, met) & (FULL >> (31 - lane));
    const float e_last = __shfl_sync(FULL, sm.x, upto ? 31 - __clz(upto) : 0);
    const float out = upto ? e_last : cur;
    float in = __shfl_up_sync(FULL, out, 1);
    if (lane == 0) in = cur;
    // The state at the window's start, S[k - WARM].
    const float in_w = __shfl_up_sync(FULL, in, Op::WARM);
    const int kw = k - Op::WARM;
    const float sw = kw <= 0 ? init
                             : (lane >= Op::WARM ? in_w : hist[kw % HIST]);
    const bool ok = met ? (sm.y <= sw && sw <= sm.z)
                        : (is_run && __float_as_uint(op.step(in, sm.w)) ==
                                         __float_as_uint(in));
    const unsigned bad = __ballot_sync(FULL, act && !ok);
    const int taken = bad ? __ffs(bad) - 1 : min(32, c_hi - base);
    if (lane < taken) {
      S[k + 1] = out;
      hist[(k + 1) % HIST] = out;
    }
    const float last = __shfl_sync(FULL, out, max(taken - 1, 0));
    if (taken) cur = last;
    base += taken;
    if (bad) {                        // segment `base` starts at cur
      const float v = __shfl_sync(FULL, sm.w, taken);
      const bool v_run = __shfl_sync(FULL, (int)is_run, taken);
      float next = cur;
      if (!(v_run &&
            __float_as_uint(op.step(cur, v)) == __float_as_uint(cur)))
        next = walk_segment(op, src, n, base, cur, seg, lane);
      if (lane == 0) {
        S[base + 1] = next;
        hist[(base + 1) % HIST] = next;
      }
      cur = next;
      ++base;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// 3. Outputs
// ---------------------------------------------------------------------------

// Grid: `chunks` CTAs per signal, OUT_SEGS segments each; 128 threads
// stage and store, warp 0 walks.
template <class Op>
__global__ void __launch_bounds__(128)
output_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
              int ns, int chunks, Op op, const float* __restrict__ S,
              bool aligned_x, bool aligned_y) {
  extern __shared__ __align__(16) float sm[];
  const int sig = blockIdx.x / chunks;
  const int k0 = (blockIdx.x % chunks) * OUT_SEGS;
  const int k1 = min(ns, k0 + OUT_SEGS);
  const int k = k0 + threadIdx.x;
  __shared__ unsigned long long bar;
  init_bar(&bar);
  __syncthreads();
  stage_rows(sm, x + (long long)sig * n, n, k0, k1, aligned_x, &bar);
  pdl_wait();                         // the starts are written
  __syncthreads();
  if (threadIdx.x < 32 && k < k1) {
    float* row = sm + threadIdx.x * ROW;
    walk_row<EXACT, true>(op, S[(long long)sig * (ns + 1) + k], row, row, row,
                          seg_len(k, n));
  }
  __syncthreads();
  store_rows(y + (long long)sig * n, sm, n, k0, k1, aligned_y);
}

// A launch that may start while the kernel before it in the stream runs
// (it waits itself with pdl_wait).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int grid, int block,
                             int smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class Op>
int launch_segments(const float* x, float* y, long long n, int n_sig, Op op,
                    float* scratch, void* stream) {
  if (n_sig < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n_sig == 0 || n == 0) return (int)cudaSuccess;
  const long long ns_ll = (n + SEG - 1) / SEG;
  const long long sum_chunks = (ns_ll + SUM_SEGS - 1) / SUM_SEGS;
  const long long out_chunks = (ns_ll + OUT_SEGS - 1) / OUT_SEGS;
  if (ns_ll > INT_MAX || sum_chunks * n_sig > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int ns = (int)ns_ll;
  const long long per = (long long)ns * n_sig;
  float4* summ = reinterpret_cast<float4*>(scratch);
  int* run = reinterpret_cast<int*>(scratch + 4 * per);
  float* S = scratch + 5 * per;
  const bool rows16 = n % 4 == 0;
  const bool ax = rows16 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool ay = rows16 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int sum_smem = 3 * (SUM_SEGS + Op::WARM) * ROW * (int)sizeof(float);
  const int out_smem = OUT_SEGS * ROW * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      summary_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sum_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(output_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem);
  if (err != cudaSuccess) return (int)err;
  summary_kernel<Op><<<(int)(sum_chunks * n_sig), 64, sum_smem, st>>>(
      x, n, ns, (int)sum_chunks, op, ax, summ, run);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_dependent(carry_kernel<Op>, n_sig, 32, 0, st, x, n, ns, op,
                         (const float4*)summ, (const int*)run, S);
  if (err != cudaSuccess) return (int)err;
  err = launch_dependent(output_kernel<Op>, (int)(out_chunks * n_sig), 128,
                         out_smem, st, x, y, n, ns, (int)out_chunks, op,
                         (const float*)S, ax, ay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The serial walk (the noise floor; the other two as a reference)
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;      // warp 0: the chain; warps 1-3: the stream
constexpr int TILE = 2048;        // floats in one shared-memory tile
constexpr int UNROLL = 16;        // steps a lane reads ahead into registers

// Tile `tile` of one signal, between global memory and a shared tile, by
// warps 1-3 (96 threads, consecutive threads on consecutive floats). A
// thread has LOADS loads in flight before it writes them to shared memory.
constexpr int LOADS = 8;

__device__ __forceinline__ void load_tile(float* buf, const float* src,
                                          long long tile, int tile_elems,
                                          long long total) {
  constexpr int STRIDE = THREADS - 32;
  const long long base = tile * tile_elems;
  const int n = (int)min((long long)tile_elems, total - base);
  for (int j0 = threadIdx.x - 32; j0 < n; j0 += LOADS * STRIDE) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int j = j0 + u * STRIDE;
      v[u] = j < n ? src[base + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int j = j0 + u * STRIDE;
      if (j < n) buf[j] = v[u];
    }
  }
}

__device__ __forceinline__ void store_tile(float* dst, const float* buf,
                                           long long tile, int tile_elems,
                                           long long total, int first,
                                           int stride) {
  const long long base = tile * tile_elems;
  const long long n = min((long long)tile_elems, total - base);
  for (int j = first; j < n; j += stride) dst[base + j] = buf[j];
}

// x, y: [n_sig, n_steps, lanes] contiguous; init: [n_sig, lanes] or null
// (then every lane starts at init_value). Grid: one CTA per signal.
template <typename Step>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const float* __restrict__ x, float* __restrict__ y,
             long long n_steps, int lanes, const float* __restrict__ init,
             float init_value, Step op) {
  __shared__ float buf[3][TILE];
  const long long total = n_steps * lanes;
  const float* src = x + blockIdx.x * total;
  float* dst = y + blockIdx.x * total;
  const int steps_per_tile = TILE / lanes;
  const int tile_elems = steps_per_tile * lanes;
  const long long n_tiles = (n_steps + steps_per_tile - 1) / steps_per_tile;
  const int lane = threadIdx.x;
  const bool chain = lane < lanes;
  float state = 0.0f;
  if (chain) state = init ? init[blockIdx.x * lanes + lane] : init_value;

  if (threadIdx.x >= 32) load_tile(buf[0], src, 0, tile_elems, total);
  __syncthreads();
  for (long long i = 0; i < n_tiles; ++i) {
    if (threadIdx.x >= 32) {
      if (i + 1 < n_tiles)
        load_tile(buf[(i + 1) % 3], src, i + 1, tile_elems, total);
      if (i >= 1)
        store_tile(dst, buf[(i + 2) % 3], i - 1, tile_elems, total,
                   threadIdx.x - 32, THREADS - 32);
    } else if (chain) {
      float* b = buf[i % 3] + lane;
      const int steps = (int)min((long long)steps_per_tile,
                                 n_steps - i * steps_per_tile);
      int t = 0;
      for (; t + UNROLL <= steps; t += UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = b[(t + u) * lanes];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          state = op.step(state, v[u]);
          v[u] = state;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) b[(t + u) * lanes] = v[u];
      }
      for (; t < steps; ++t) {
        state = op.step(state, b[t * lanes]);
        b[t * lanes] = state;
      }
    }
    __syncthreads();
  }
  store_tile(dst, buf[(n_tiles - 1) % 3], n_tiles - 1, tile_elems, total,
             threadIdx.x, THREADS);
}

template <typename Step>
int launch_chain(const float* x, float* y, long long n_steps, int n_sig,
                 int lanes, const float* init, float init_value, Step op,
                 void* stream) {
  if (n_sig < 0 || n_steps < 0 || lanes < 1 || lanes > 32)
    return (int)cudaErrorInvalidValue;
  if (n_sig == 0 || n_steps == 0) return (int)cudaSuccess;
  chain_kernel<Step><<<n_sig, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, n_steps, lanes, init, init_value, op);
  return (int)cudaGetLastError();
}

Envelope envelope_op(float attack, float release) {
  return Envelope{attack, release, 1.0f - attack, 1.0f - release};
}

LimiterGain limiter_op(float rc) { return LimiterGain{rc, 1.0f - rc}; }

}  // namespace

// Floats of device scratch oh_envelope and oh_limiter_gain take for n_sig
// signals of n samples (the segment summaries and starts).
extern "C" long long oh_dsp_scratch_floats(long long n, int n_sig) {
  const long long ns = (n + SEG - 1) / SEG;
  return (long long)n_sig * (5 * ns + ns + 1);
}

// a: |x| [n_sig, n] fp32, env: [n_sig, n] fp32, both contiguous; scratch:
// oh_dsp_scratch_floats(n, n_sig) fp32, 16-byte aligned.
extern "C" int oh_envelope(const float* a, float* env, long long n, int n_sig,
                           float attack, float release, float* scratch,
                           void* stream) {
  return launch_segments(a, env, n, n_sig, envelope_op(attack, release),
                         scratch, stream);
}

// tg: target gains [n_sig, n] fp32, g: [n_sig, n] fp32, both contiguous;
// scratch as oh_envelope's.
extern "C" int oh_limiter_gain(const float* tg, float* g, long long n,
                               int n_sig, float rc, float* scratch,
                               void* stream) {
  return launch_segments(tg, g, n, n_sig, limiter_op(rc), scratch, stream);
}

// The serial walks of the same two recurrences (one thread a signal): the
// card's fast bit reference and the old design's time, for chip_smoke.py
// and tools/torch_audio_front_probe.py; nothing on the path calls them.
extern "C" int oh_envelope_serial(const float* a, float* env, long long n,
                                  int n_sig, float attack, float release,
                                  void* stream) {
  return launch_chain(a, env, n, n_sig, 1, nullptr, 0.0f,
                      envelope_op(attack, release), stream);
}

extern "C" int oh_limiter_gain_serial(const float* tg, float* g, long long n,
                                      int n_sig, float rc, void* stream) {
  return launch_chain(tg, g, n, n_sig, 1, nullptr, 1.0f, limiter_op(rc),
                      stream);
}

// le: log band energies [n_sig, n_frames, n_bands] fp32, floor0: [n_sig,
// n_bands] fp32, floor: [n_sig, n_frames, n_bands] fp32 (the floor after
// each frame), all contiguous; n_bands at most 32.
extern "C" int oh_noise_floor(const float* le, const float* floor0,
                              float* floor, int n_frames, int n_sig,
                              int n_bands, void* stream) {
  return launch_chain(le, floor, (long long)n_frames, n_sig, n_bands, floor0,
                      0.0f, NoiseFloor{}, stream);
}
