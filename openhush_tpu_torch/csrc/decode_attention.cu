// Single-query decode attention over the flat [B, T, H*64] caches of the
// decode step, with two kernels that compute the same function: K4 (one CTA
// per query streams the keys) and K5 (a thread-block cluster per query
// splits the keys).
//
// Replaces two TPU kernels:
//   openhush_tpu/ops/decode_attention.py:decode_cross_attend (body _kernel),
//     by K4, the direct load path (decode_attention_kernel);
//   openhush_tpu/ops/decode_attention_dma.py:decode_cross_attend_dma (body
//     _kernel), whose hand double-buffered HBM->VMEM copies become K5's
//     slices, each put in flight whole (decode_attention_split_kernel).
// The role they fill on the decode step is the one XLA einsums fill in the
// JAX model (models/whisper/model.py:_attend_decode_flat, _multi, _ro), at
// that production arithmetic, per query:
//   QUANT (int8 K/V with per-(position, head) fp32 scales ks, vs [B, T, H]):
//     qscale = max(max|q_h|, 1e-10) / 127;  q8 = clip(rint(q_h / qscale))
//     s_t    = ((float(K8_t . q8) * ks_t) * qscale) * sm_scale  (int32 dot)
//     p      = exp(s - max) / sum                          (fp32 softmax)
//     pscale = max(max_t(p_t * vs_t), 1e-20) / 127
//     p8_t   = clip(rint(p_t * vs_t / pscale))
//     out    = float(sum_t p8_t * V8_t) * pscale            (int32 sums)
//   float (bf16 or fp32 K/V, or int8 taken as plain numbers):
//     s_t = (K_t . q) * sm_scale; p as above, rounded to the value type
//     (bf16 for plain int8, as the TPU kernel rounds its probs) before an
//     fp32 value sum.
// Key t is visible to query s of row b iff t < n = len_b + (causal ? s : 0),
// len_b = lengths[b] (or len_default); keys past n are never read. That is
// the reference's finfo(f32).min mask: a masked key's exp is exactly 0.
// Built without --use_fast_math: `/` is the IEEE divide, expf the accurate
// one, rintf rounds half to even like jnp.round.
//
// Bound on an H100: bytes. A decode step reads each cache once per query
// (large-v3, B=8: 30.7 MB of int8 cross K/V + 1.9 MB of scales per layer)
// and does ~2 operations per byte. Head dim 64, so a head's row is 64 B
// (int8) or 128 B (bf16) at a stride of H*64 elements; each thread loads
// 16 B, neighbouring threads take the neighbouring 16 B of a row and then
// the next rows, so a warp reads whole 32-byte sectors.
//
// K4 (the self-attention, T <= 448): one CTA of 128 threads per (head,
// query, row). Its bound is bytes, but a row is small (100 keys of bf16 K
// and V for 20 heads are 0.51 MB, 0.15 us at the card's rate): what a
// launch takes is the launch itself, its chain of dependent trips to device
// memory and CTA barriers, and the instructions' latency. So at entry each
// CTA asks for the query, all its visible K rows and all its V rows
// (cp.async, 16 B a thread), then waits once; the scores stay in shared
// memory until the row's max and sum are known (the reference rounds
// exp(s - m) / l, and in int8 mode the joint prob scale max_t(p*vs) needs
// the whole row first), each warp reduces its own rows in registers and the
// warps are joined once per quantity. Where K and V of T rows do not fit
// (an fp32 cache of 448 rows, T = 1500 in the cross-attention's modes), the
// rows stream through a ring of 4 stages, V following K into the same
// slots. The sums run in a fixed order: the same bits on every launch.
//
// K4's beam mode (a mask pointer) is the grouped beam step's
// self-attention, the function of the JAX model's _attend_decode_flat_beam
// (XLA einsums there, no Pallas kernel): the K beams of a group attend over
// the group's K cache rows seen as one row of K*T keys (a free view of the
// row-contiguous [G*K, T, H*64] cache), and query s sees key j iff
// mask[b, s, j], the beam's ancestry. The caller writes each beam's new key
// first and sets its own bit, so the mask is the reference's cache mask plus
// its identity block over the new keys. This first version reads all K*T
// keys and masks the scores: a masked key scores -inf (exp exactly 0) and
// adds exact zeros to the value sums. At large-v3's K = 5 and T = 448 that
// is 2240 keys, streamed through the ring, K times the keys a query can see
// at most and many more early in a window (PERF.md has both bounds). The
// mask row is copied to shared memory while the rows are in flight. Reading
// only the visible rows (a per-position source-row table) is a later
// redesign.
//
// K5 (the int8 cross-attention, T = 1500): a CTA streaming 1500 keys alone
// keeps too few bytes in flight (at batch 1 that is 20 CTAs on 132 SMs),
// and the joint prob scale max_t(p*vs) needs the whole row's softmax before
// the value sum. So a cluster of CLUSTER = 8 CTAs takes each (heads, query,
// row): rank r holds keys [r*per, (r+1)*per), per = ceil(n / 8). At entry
// it loads the query, then puts its whole slice of K, with the slice's ks
// and vs scales, in flight (cp.async, about 12 KB a head at T = 1500 int8)
// before it waits for anything. As each thread takes the score of its piece
// of K, it asks for V's piece of the same row and columns into the same
// slot, so V's loads run under the exchanges below and a CTA holds one
// slice of rows, not two. Every thread copies exactly what it computes on,
// so no barrier guards the buffers. The softmax is joint over the cluster,
// through distributed shared memory: each rank writes its max, then its
// sum of exp(s - m), then (int8) its max of p*vs into a slot of every
// rank's shared memory with st.async, which counts the bytes on that
// rank's mbarrier; a rank waits only for its own slots (no cluster-wide
// barrier per exchange) and reads them in rank order, so all hold the same
// m, l and pscale. The max is exact; l is the same sum as K4's in another
// order (which can move a prob level at an exact .5 tie); pscale is exact
// given l. Each rank then sums its slice's values (int32 in QUANT mode) and
// writes the sum to rank 0, which adds the eight in rank order (exact in
// int32) once the cluster barrier's release by every rank has reached it.
// The result is the same on every launch.
//
// With int8 K/V and an even head count a cluster takes two adjacent heads
// (G = 2; their rows and scales lie side by side). An H100 holds 124
// clusters of 8 at once at up to 28 KB of shared memory a CTA, 92 at the
// pair kernel's 35 KB (cudaOccupancyMaxActiveClusters;
// tools/torch_k5_probe.py), so at batch 8 of large-v3 the one-head grid
// (160 clusters) ran in two waves, each waiting for its loads and then its
// chain of exchanges; with pairs it is 80 clusters, all resident, and at
// batch 1 pairs measured no slower than single heads. PERF.md has the
// times beside the bound (bytes).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HEAD_DIM = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;                     // K4: the ring's groups of passes
constexpr int PASS_BYTES = THREADS * 16;      // K4: a pass, 16 B per thread
constexpr int CLUSTER = 8;                    // K5: CTAs per query
constexpr size_t MAX_SMEM = 200 * 1024;       // K4: dynamic shared memory
constexpr size_t MAX_SMEM_SPLIT = 200 * 1024; // K5: a slice's rows, sums and scores

template <typename T> struct Layout {
  static constexpr int VALS = 16 / (int)sizeof(T);     // values per 16 B
  static constexpr int CHUNKS = HEAD_DIM / VALS;       // threads per row
  static constexpr int RPP = THREADS / CHUNKS;         // rows per pass
};

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Element j of a 16-byte chunk, as float.
template <typename T> __device__ __forceinline__ float elem(const int4& c, int j);
__device__ __forceinline__ int int8_at(const int4& c, int j);
template <> __device__ __forceinline__ float elem<int8_t>(const int4& c, int j) {
  return (float)int8_at(c, j);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const int4& c, int j) {
  const uint32_t w = (uint32_t)(&c.x)[j >> 1];
  return bf16_bits_to_f32((j & 1) ? (w >> 16) : (w & 0xffffu));
}
template <> __device__ __forceinline__ float elem<float>(const int4& c, int j) {
  return __int_as_float((&c.x)[j]);
}

__device__ __forceinline__ int int8_at(const int4& c, int j) {
  return (int)(int8_t)(((&c.x)[j >> 2] >> (8 * (j & 3))) & 0xff);
}

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void store_f32(T* p, float x);
template <> __device__ __forceinline__ void store_f32<float>(float* p, float x) { *p = x; }
template <> __device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Probabilities are rounded to the value type before the value sum (the
// reference's probs.astype(v.dtype)); plain int8 values take bf16 probs.
template <typename T> __device__ __forceinline__ float round_prob(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}
template <> __device__ __forceinline__ float round_prob<float>(float p) { return p; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Thread i < G*64's element of the queries of G adjacent heads of one
// (row, query), as fp32.
template <int G, typename QO>
__device__ __forceinline__ float query_elem(const QO* qp) {
  return threadIdx.x < G * HEAD_DIM ? load_f32(qp + threadIdx.x) : 0.f;
}

// The queries of G adjacent heads, from query_elem on each thread, into
// shared memory: their fp32 values and, in QUANT mode, each head's int8
// levels (four to a word) and scale, warp g taking head g:
//   qscale = max(max|q_h|, 1e-10) / 127;  q8 = clip(rint(q_h / qscale)).
// Every thread calls it.
template <bool QUANT, int G>
__device__ __forceinline__ void stage_query(float qv, float* qs, int* q8w, float* qscale_s) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  if (threadIdx.x < G * HEAD_DIM) qs[threadIdx.x] = qv;
  __syncthreads();
  if constexpr (QUANT) if (g < G) {
    const float* qh = qs + g * HEAD_DIM;
    float m = fmaxf(fabsf(qh[lane]), fabsf(qh[lane + 32]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float qscale = fmaxf(m, 1e-10f) / 127.0f;
    if (lane == 0) qscale_s[g] = qscale;
    if (lane < HEAD_DIM / 4) {
      int w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = fminf(fmaxf(rintf(qh[4 * lane + j] / qscale), -127.f), 127.f);
        w |= ((int)r & 0xff) << (8 * j);
      }
      q8w[g * (HEAD_DIM / 4) + lane] = w;
    }
  }
  __syncthreads();
}

// The dot of one key row with the query, from the 16-byte piece `ch`
// (column chunk c) that this thread holds, summed over the row's lanes:
// the exact int32 dot of the levels in QUANT mode (as float: |dot| < 2^24),
// else an fp32 dot. Every lane of the warp calls it.
template <typename KV, bool QUANT>
__device__ __forceinline__ float piece_dot(const int4& ch, int c, const float* qs,
                                           const int* q8w) {
  using L = Layout<KV>;
  if constexpr (QUANT) {
    int acc = 0;
    acc = __dp4a(ch.x, q8w[4 * c + 0], acc);
    acc = __dp4a(ch.y, q8w[4 * c + 1], acc);
    acc = __dp4a(ch.z, q8w[4 * c + 2], acc);
    acc = __dp4a(ch.w, q8w[4 * c + 3], acc);
#pragma unroll
    for (int off = L::CHUNKS / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return (float)acc;
  } else {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) acc = fmaf(elem<KV>(ch, j), qs[c * L::VALS + j], acc);
#pragma unroll
    for (int off = L::CHUNKS / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
  }
}

// The score of key t: ((dot * ks_t) * qscale) * sm_scale in QUANT mode.
template <bool QUANT>
__device__ __forceinline__ float score_of(float dot, const float* ks_t, float qscale,
                                          float sm_scale) {
  if constexpr (QUANT) return ((dot * *ks_t) * qscale) * sm_scale;
  return dot * sm_scale;
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K4's dynamic shared memory: a ring of `ring` passes of rows (a pass is
// one 16-byte piece per thread; K's rows, then V's, through the same
// slots), then every key's score and, in QUANT mode, every key's ks and vs,
// then, in the beam mode, the query's row of the mask (a byte a key).
template <bool QUANT> __host__ __device__ constexpr size_t direct_tail(int T, bool masked) {
  return (size_t)T * sizeof(float) * (QUANT ? 3 : 1) + (masked ? (size_t)(T + 15) / 16 * 16 : 0);
}
// The ring's passes for a cache of T rows: K and V of all T rows, rounded
// up to whole stages, or as many whole stages as MAX_SMEM holds beside the
// scores (then the rows stream through the ring). Fewer than STAGES: no fit.
template <typename KV, bool QUANT> int ring_passes(int T, bool masked) {
  using L = Layout<KV>;
  const long long need = 2LL * ((T + L::RPP - 1) / L::RPP);
  const long long want = (need + STAGES - 1) / STAGES * STAGES;
  const long long room = ((long long)MAX_SMEM - (long long)direct_tail<QUANT>(T, masked)) /
                         PASS_BYTES / STAGES * STAGES;
  return (int)(want < room ? want : room);
}

// K4: asks for this thread's pieces of passes [p0, p1) (pass p < kp: K's
// rows, else V's) in consecutive slots from `slot`, and the ks of its K
// rows in QUANT mode, as one cp.async group. Returns whether the group
// holds a copy. (No division here or in the loops that call it: at a few
// us a launch, a division's chain of dependent instructions shows.)
template <typename KV, bool QUANT>
__device__ __forceinline__ bool issue_passes(int4* slot, float* kss, const KV* kb, const KV* vb,
                                             const float* ksb, int p0, int p1, int kp, int n,
                                             int HD, int H) {
  using L = Layout<KV>;
  const int c = threadIdx.x % L::CHUNKS, r0 = threadIdx.x / L::CHUNKS;
  bool copied = false;
  for (int p = p0; p < p1; ++p, slot += THREADS) {
    const bool is_k = p < kp;
    const int t = (is_k ? p : p - kp) * L::RPP + r0;
    if (t < n) {
      cp_async16(slot + threadIdx.x, (is_k ? kb : vb) + (long long)t * HD + c * L::VALS);
      if (QUANT && is_k && c == 0) cp_async4(kss + t, ksb + (long long)t * H);
      copied = true;
    }
  }
  cp_async_commit();
  return copied;
}

// K4, streaming: moves to the next pass's slot; once a stage has been read,
// asks for stage `next` into its slots.
template <typename KV, bool QUANT>
__device__ __forceinline__ void next_pass(int4*& cur, int& in_stage, int& next, unsigned& held,
                                          int4* slots, int span, int sp, int P, float* kss,
                                          const KV* kb, const KV* vb, const float* ksb, int kp,
                                          int n, int HD, int H) {
  cur += THREADS;
  if (++in_stage == sp) {
    const bool copied = issue_passes<KV, QUANT>(cur - sp * THREADS, kss, kb, vb, ksb, next * sp,
                                                min((next + 1) * sp, P), kp, n, HD, H);
    held = (held << 1) | (copied ? 1u : 0u);
    ++next;
    in_stage = 0;
    if (cur == slots + span * THREADS) cur = slots;
  }
}

// K4: the score of key t from this thread's piece `ch` of its row (every
// lane calls it; lane c == 0 of the row writes sc[t]); returns the running
// max of the scores this thread wrote. In the beam mode (mk: the query's
// row of the mask in shared memory) a key the mask hides scores -inf, so
// its exp is exactly 0, as the reference's finfo(f32).min fill gives, and
// it does not enter the max.
template <typename KV, bool QUANT>
__device__ __forceinline__ float score_pass(const int4& ch, int t, int n, int c, const float* qw,
                                            const int* q8, const float* kss, float qscale,
                                            float sm_scale, const unsigned char* mk, float* sc,
                                            float lmax) {
  const float dot = piece_dot<KV, QUANT>(t < n ? ch : make_int4(0, 0, 0, 0), c, qw, q8);
  if (c == 0 && t < n) {
    if (mk && !mk[t]) {
      sc[t] = -INFINITY;
    } else {
      const float score = score_of<QUANT>(dot, kss + t, qscale, sm_scale);
      sc[t] = score;
      lmax = fmaxf(lmax, score);
    }
  }
  return lmax;
}

// K4: adds prob sc[t] times this thread's piece `ch` of V's row t to its
// column sums (int32 in QUANT mode).
template <typename KV, bool QUANT, typename Acc>
__device__ __forceinline__ void value_pass(Acc (&acc)[Layout<KV>::VALS], const int4& ch, int t,
                                           int n, const float* sc) {
  if (t >= n) return;
  if constexpr (QUANT) {
    const int p8 = (int)sc[t];
#pragma unroll
    for (int j = 0; j < Layout<KV>::VALS; ++j) acc[j] += p8 * int8_at(ch, j);
  } else {
    const float pr = sc[t];
#pragma unroll
    for (int j = 0; j < Layout<KV>::VALS; ++j) acc[j] = fmaf(pr, elem<KV>(ch, j), acc[j]);
  }
}

// The max and the sum over a warp's 32 lanes, every lane getting the result.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K4: before the passes of the stage issued STAGES stages ago, waits until
// at most the later stages' groups that hold copies are pending (groups
// complete in order; bit i of `held`: the i-th most recent stage's group
// holds a copy of this thread's).
__device__ __forceinline__ void wait_stage(unsigned held) {
  static_assert(STAGES == 4, "a case for each count of later groups");
  switch (__popc(held & ((1u << (STAGES - 1)) - 1))) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<STAGES - 1>(); break;
  }
}

// K4: one CTA of 128 threads per (head, query, row). Pass p < kp holds K's
// rows p*RPP.., pass kp + p V's same rows; thread i always takes the piece
// (row p*RPP + i / CHUNKS, column chunk i % CHUNKS) of a pass and copies
// exactly the pieces it computes on, so no barrier guards the slots. When
// the ring holds all 2 * kp passes (every self-attention call: 2 * 448 rows
// of bf16 are 112 KB), they are one group asked for at the entry and waited
// on once, and the loops over them are unrolled; else they stream in
// STAGES groups of sp passes, stage st + STAGES asked for as soon as stage
// st has been read. Warp w owns the rows whose pieces its lanes hold (RW
// per pass): their scores, exps and probs, so the softmax needs one CTA
// barrier per quantity (max, sum and, int8, max(p*vs)), and the value sum
// one more. tools/torch_k4_probe.py times the launch and each part.
template <typename KV, typename QO, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const QO* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        int len_default, int causal, const unsigned char* __restrict__ mask,
                        QO* __restrict__ out, float* __restrict__ probs, int S, int H, int T,
                        float sm_scale, int ring) {
  using L = Layout<KV>;
  using Acc = typename std::conditional<QUANT, int, float>::type;   // value sums
  constexpr int RW = 32 / L::CHUNKS;                 // a warp's rows of a pass
  extern __shared__ __align__(16) unsigned char smem[];
  int4* slots = reinterpret_cast<int4*>(smem);       // [ring][THREADS]
  float* sc = reinterpret_cast<float*>(smem + (size_t)ring * PASS_BYTES);   // [T]
  float* kss = sc + T;                               // [T], QUANT
  float* vss = kss + T;                              // [T], QUANT
  unsigned char* mk = reinterpret_cast<unsigned char*>(sc + T * (QUANT ? 3 : 1));  // [T], beam
  __shared__ float qs[WARPS][HEAD_DIM];              // each warp's copy
  __shared__ int q8w[WARPS][HEAD_DIM / 4];
  __shared__ float red_max[WARPS], red_sum[WARPS], red_pv[WARPS];
  __shared__ Acc part[WARPS][HEAD_DIM];

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const long long qo_off = ((long long)b * S + s) * HD + h * HEAD_DIM;
  int n = (lengths ? lengths[b] : len_default) + (causal ? s : 0);
  n = n < T ? n : T;
  float* pb = probs ? probs + (((long long)b * S + s) * H + h) * T : nullptr;
  if (n <= 0) {                     // no visible key: callers never ask
    if (threadIdx.x < HEAD_DIM) store_f32(out + qo_off + threadIdx.x, 0.f);
    if (pb)
      for (int t = threadIdx.x; t < T; t += THREADS) pb[t] = 0.f;
    return;
  }
  const long long row0 = (long long)b * T;
  const KV* kb = k + row0 * HD + h * HEAD_DIM;
  const KV* vb = v + row0 * HD + h * HEAD_DIM;
  const float* ksb = QUANT ? ks + row0 * H + h : nullptr;
  const float* vsb = QUANT ? vs + row0 * H + h : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = threadIdx.x % L::CHUNKS, r0 = threadIdx.x / L::CHUNKS;

  // -- the query's load first; then every pass of the ring in flight -------
  const float qa = load_f32(q + qo_off + lane), qb = load_f32(q + qo_off + lane + 32);
  const int kp = (n + L::RPP - 1) / L::RPP;          // passes of K, and of V
  const int P = 2 * kp;
  // Every pass in flight from the entry, one group (`whole`); else STAGES
  // groups of sp passes each through the ring's span.
  const bool whole = P <= ring;
  const int sp = whole ? P : ring / STAGES;
  const int span = STAGES * sp;
  bool vs_copied = false;
  if constexpr (QUANT)              // the vs of this lane's softmax entries,
    for (int j = lane; j < kp * RW; j += 32) {      // in the first group
      const int t = (j / RW) * L::RPP + warp * RW + j % RW;
      if (t < n) {
        cp_async4(vss + t, vsb + (long long)t * H);
        vs_copied = true;
      }
    }
  // A group with no copy is never pending, so cp.async.wait_group counts
  // only this thread's groups that hold copies: bit i of `held` says
  // whether the i-th most recent stage gave this thread any.
  unsigned held = 0;
  if (whole) {
    issue_passes<KV, QUANT>(slots, kss, kb, vb, ksb, 0, P, kp, n, HD, H);
  } else {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      const bool copied = issue_passes<KV, QUANT>(slots + st * sp * THREADS, kss, kb, vb, ksb,
                                                  st * sp, min((st + 1) * sp, P), kp, n, HD, H);
      held = (held << 1) | (copied || (st == 0 && vs_copied) ? 1u : 0u);
    }
  }
  // Streaming: the pass being read, its place in its stage, and the next
  // stage to ask for once this one has been read (into the same slots).
  int4* cur = slots;
  int in_stage = 0, next = STAGES;
  // The beam mode: the query's row of the mask, into shared memory while
  // the rows are in flight (one trip to memory, under theirs).
  if (mask) {
    const unsigned char* mrow = mask + ((long long)b * S + s) * T;
    for (int t = threadIdx.x; t < n; t += THREADS) mk[t] = mrow[t];
    __syncthreads();
  }
  const unsigned char* mvis = mask ? mk : nullptr;

  // -- the query, in this warp's copy: fp32 and, QUANT, its int8 levels:
  //    qscale = max(max|q_h|, 1e-10) / 127;  q8 = clip(rint(q_h / qscale)) -----
  float* qw = qs[warp];
  int* q8 = q8w[warp];
  qw[lane] = qa;
  qw[lane + 32] = qb;
  float qscale = 1.f;
  if constexpr (QUANT) {
    qscale = fmaxf(warp_max(fmaxf(fabsf(qa), fabsf(qb))), 1e-10f) / 127.0f;
    __syncwarp();
    if (lane < HEAD_DIM / 4) {
      int w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = fminf(fmaxf(rintf(qw[4 * lane + j] / qscale), -127.f), 127.f);
        w |= ((int)r & 0xff) << (8 * j);
      }
      q8[lane] = w;
    }
  }
  __syncwarp();

  // -- scores: one 16-byte piece per thread, summed over the row's lanes ----
  float lmax = -FLT_MAX;
  if (whole) {
    cp_async_wait<0>();             // the one wait on memory
#pragma unroll 4
    for (int p = 0; p < kp; ++p)
      lmax = score_pass<KV, QUANT>(slots[p * THREADS + threadIdx.x], p * L::RPP + r0, n, c, qw,
                                   q8, kss, qscale, sm_scale, mvis, sc, lmax);
  } else {
    for (int p = 0; p < kp; ++p) {
      if (in_stage == 0) wait_stage(held);   // this pass's stage has landed
      lmax = score_pass<KV, QUANT>(cur[threadIdx.x], p * L::RPP + r0, n, c, qw, q8, kss, qscale,
                                   sm_scale, mvis, sc, lmax);
      next_pass<KV, QUANT>(cur, in_stage, next, held, slots, span, sp, P, kss, kb, vb, ksb, kp,
                           n, HD, H);
    }
  }

  // -- softmax (fp32): each warp over its own rows, the warps joined once per
  //    quantity, in warp order; then the probs the value sum takes ----------
  lmax = warp_max(lmax);
  if (lane == 0) red_max[warp] = lmax;
  __syncthreads();
  float m = red_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_max[w]);
  float lsum = 0.f;
  for (int j = lane; j < kp * RW; j += 32) {
    const int t = (j / RW) * L::RPP + warp * RW + j % RW;   // warp's j-th row
    if (t < n) {
      const float e = expf(sc[t] - m);
      sc[t] = e;
      lsum += e;
    }
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red_sum[warp] = lsum;
  __syncthreads();
  float l = red_sum[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) l += red_sum[w];
  if (l == 0.f) {                   // the mask hid every key: callers never
    cp_async_wait<0>();             // ask (a beam's own key is visible)
    if (threadIdx.x < HEAD_DIM) store_f32(out + qo_off + threadIdx.x, 0.f);
    if (pb)
      for (int t = threadIdx.x; t < T; t += THREADS) pb[t] = 0.f;
    return;
  }
  float pscale = 1.f;
  if constexpr (QUANT) {
    float pmax = 0.f;
    for (int j = lane; j < kp * RW; j += 32) {
      const int t = (j / RW) * L::RPP + warp * RW + j % RW;   // warp's j-th row
      if (t < n) {
        const float pv = (sc[t] / l) * vss[t];
        sc[t] = pv;
        pmax = fmaxf(pmax, pv);
      }
    }
    pmax = warp_max(pmax);
    if (lane == 0) red_pv[warp] = pmax;
    __syncthreads();
    pmax = red_pv[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) pmax = fmaxf(pmax, red_pv[w]);
    pscale = fmaxf(pmax, 1e-20f) / 127.0f;
  }
  for (int j = lane; j < kp * RW; j += 32) {
    const int t = (j / RW) * L::RPP + warp * RW + j % RW;   // warp's j-th row
    if (t < n) {
      const float p = QUANT ? fminf(fmaxf(rintf(sc[t] / pscale), -127.f), 127.f)
                            : round_prob<KV>(sc[t] / l);
      sc[t] = p;
      if (pb) pb[t] = p;            // the value sum's probs, for checks
    }
  }
  if (pb)
    for (int t = n + threadIdx.x; t < T; t += THREADS) pb[t] = 0.f;
  __syncwarp();

  // -- values: each thread sums its 16 B of columns over its rows, then the
  //    warp's rows by shuffles and the warps in order ------------------------
  Acc acc[L::VALS];
#pragma unroll
  for (int j = 0; j < L::VALS; ++j) acc[j] = 0;
  if (whole) {
#pragma unroll 4
    for (int p = kp; p < P; ++p)
      value_pass<KV, QUANT>(acc, slots[p * THREADS + threadIdx.x], (p - kp) * L::RPP + r0, n,
                            sc);
  } else {
    for (int p = kp; p < P; ++p) {
      if (in_stage == 0) wait_stage(held);
      value_pass<KV, QUANT>(acc, cur[threadIdx.x], (p - kp) * L::RPP + r0, n, sc);
      next_pass<KV, QUANT>(cur, in_stage, next, held, slots, span, sp, P, kss, kb, vb, ksb, kp,
                           n, HD, H);
    }
  }
#pragma unroll
  for (int off = L::CHUNKS; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane < L::CHUNKS)             // lane c holds chunk c's warp sum
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) part[warp][c * L::VALS + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < HEAD_DIM) {
    Acc total = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += part[w][threadIdx.x];
    store_f32(out + qo_off + threadIdx.x, QUANT ? (float)total * pscale : (float)total);
  }
}

// The one cluster barrier, split: every rank arrives once its mbarriers are
// initialised, and waits before its first write to another rank's shared
// memory, so that no write finds a barrier not yet initialised.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` in rank `rank`'s shared memory.
__device__ __forceinline__ uint32_t at_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(oh_tma::smem_u32(p)), "r"(rank));
  return a;
}

// Writes 4 bytes to another rank's shared memory and counts them on that
// rank's mbarrier: one-sided, the writer waits for nothing.
__device__ __forceinline__ void st_async(uint32_t remote, uint32_t bits, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(remote), "r"(bits), "r"(remote_bar) : "memory");
}

// v[g] for a g known only at run time, without indexing a register array.
template <int G>
__device__ __forceinline__ float pick(const float (&v)[G], int g) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < G; ++i)
    if (g == i) x = v[i];
  return x;
}

// G values: x at g, `identity` elsewhere.
template <int G>
__device__ __forceinline__ void at_only(float (&v)[G], int g, float x, float identity) {
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = i == g ? x : identity;
}

// The CTA's reduction by `op` of each of G values: shuffles within each
// warp, then the warps in order; every thread gets the G results. `red` holds
// WARPS * G floats.
template <int G, typename Op>
__device__ __forceinline__ void block_reduce(float (&v)[G], float* red, Op op) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[g] = op(v[g], __shfl_xor_sync(0xffffffffu, v[g], off));
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * G + g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    v[g] = red[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v[g] = op(v[g], red[w * G + g]);
  }
  __syncthreads();
}

// Every rank's G values x (the same on all of this CTA's threads) land in
// slot[rank * G + g] of every rank's copy of `slot`, counted on that rank's
// `bar`: thread g * CLUSTER + r writes value g to rank r. A rank has all
// CLUSTER * G values once its `bar` completes its phase.
template <int G>
__device__ __forceinline__ void push_all(float* slot, uint64_t* bar, int rank, const float (&x)[G]) {
  if (threadIdx.x < CLUSTER * G) {
    const int dst = threadIdx.x % CLUSTER, g = threadIdx.x / CLUSTER;
    st_async(at_rank(slot + rank * G + g, dst), __float_as_uint(pick(x, g)), at_rank(bar, dst));
  }
}

// Each head's values from the ranks, in rank order, so that every rank gets
// the same numbers.
template <int G, typename Op>
__device__ __forceinline__ void rank_order(const float* slot, float init, Op op, float (&out)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float x = init;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) x = op(x, slot[r * G + g]);
    out[g] = x;
  }
}

struct MaxOp {
  __device__ float operator()(float a, float x) const { return fmaxf(a, x); }
};
struct AddOp {
  __device__ float operator()(float a, float x) const { return a + x; }
};

// K5's dynamic shared memory, in bytes, for slices of at most per_cap rows
// of G heads: the rows (K's, then V's in the same slots), the value sums by
// warp and, on rank 0, every rank's sum, then the scores, ks and vs.
struct SplitSmem {
  int sums, sc, ks, vs, total;
  __host__ __device__ SplitSmem(int per_cap, int row_bytes, int G)
      : sums(per_cap * row_bytes * G),
        sc(sums + (WARPS + CLUSTER) * G * HEAD_DIM * 4),
        ks(sc + per_cap * G * 4),
        vs(ks + per_cap * G * 4),
        total(vs + per_cap * G * 4) {}
};

// K5: a cluster of CLUSTER CTAs per (G adjacent heads, query, row); rank r
// takes keys [r*per, (r+1)*per) of the row's n (per = ceil(n / CLUSTER); a
// slice may be empty).
template <typename KV, typename QO, bool QUANT, int G>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
decode_attention_split_kernel(const QO* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, const int* __restrict__ lengths,
                              int len_default, int causal, QO* __restrict__ out,
                              float* __restrict__ probs, int S, int H, int T,
                              float sm_scale) {
  using L = Layout<KV>;
  using Acc = typename std::conditional<QUANT, int, float>::type;   // value sums
  constexpr int RC = G * L::CHUNKS;     // threads per row of the CTA's heads
  constexpr int RPP = THREADS / RC;     // rows per pass
  constexpr int GD = G * HEAD_DIM;      // the heads' columns
  static_assert(RC <= 32 && GD <= THREADS, "a row's pieces within a warp");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int per_cap = (T + CLUSTER - 1) / CLUSTER;
  const SplitSmem lay(per_cap, HEAD_DIM * (int)sizeof(KV), G);
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rows = reinterpret_cast<int4*>(smem);                  // [per_cap][RC]
  float* sc = reinterpret_cast<float*>(smem + lay.sc);          // [per_cap][G]
  float* kss = reinterpret_cast<float*>(smem + lay.ks);         // [per_cap][G]
  float* vss = reinterpret_cast<float*>(smem + lay.vs);         // [per_cap][G]
  Acc (*part)[GD] = reinterpret_cast<Acc (*)[GD]>(smem + lay.sums);   // [WARPS]
  Acc (*partials)[GD] = part + WARPS;                           // [CLUSTER], rank 0's
  __shared__ float qs[GD];
  __shared__ int q8w[GD / 4];
  __shared__ float red[WARPS * G];
  __shared__ float qscale_s[G];
  // Every rank's max, sum and max(p*vs) per head, written here by each
  // rank, and the mbarriers that count their arrival.
  __shared__ float xmax[CLUSTER * G], xsum[CLUSTER * G], xpv[CLUSTER * G];
  __shared__ __align__(8) uint64_t got_max, got_sum, got_pv;

  const int h0 = blockIdx.y * G, s = blockIdx.z % S, b = blockIdx.z / S;
  const int HD = H * HEAD_DIM;
  const long long qo_off = ((long long)b * S + s) * HD + h0 * HEAD_DIM;
  int n = (lengths ? lengths[b] : len_default) + (causal ? s : 0);
  n = n < T ? n : T;
  // Head h0 + g's probs at pb + g * T.
  float* pb = probs ? probs + (((long long)b * S + s) * H + h0) * T : nullptr;
  if (n <= 0) {                     // the same for the whole cluster
    if (rank == 0 && threadIdx.x < GD) store_f32(out + qo_off + threadIdx.x, 0.f);
    if (rank == 0 && pb)
      for (int t = threadIdx.x; t < G * T; t += THREADS) pb[t] = 0.f;
    return;
  }
  const int per = (n + CLUSTER - 1) / CLUSTER;
  const int t0 = min(rank * per, n);
  const int cnt = min(per, n - t0);
  const long long row0 = (long long)b * T + t0;
  const KV* kb = k + row0 * HD + h0 * HEAD_DIM;
  const KV* vb = v + row0 * HD + h0 * HEAD_DIM;
  const float* ksb = QUANT ? ks + row0 * H + h0 : nullptr;
  const float* vsb = QUANT ? vs + row0 * H + h0 : nullptr;
  const int c = threadIdx.x % RC;   // this thread's 16 B of a row: in head
  const int g = c / L::CHUNKS;      // h0 + g, its column chunk hc
  const int hc = c % L::CHUNKS;
  const int r0 = threadIdx.x / RC;
  const int gs = threadIdx.x % G;   // the head of this thread's softmax entries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // -- the query's load first, ahead of the slice's; then the slice's K and
  //    scales in flight at once. Each thread copies exactly what it computes
  //    on (a 16-byte piece of a row, a row's ks where it takes that row's
  //    score, the vs of the probs it takes), so no barrier guards the
  //    buffers ---------------------------------------------------------------
  const float qv = query_elem<G>(q + qo_off);
  for (int r = r0; r < cnt; r += RPP) {
    cp_async16(rows + r * RC + c, kb + (long long)r * HD + c * L::VALS);
    if (QUANT && hc == 0) cp_async4(kss + r * G + g, ksb + (long long)r * H + g);
  }
  if constexpr (QUANT)
    for (int i = threadIdx.x; i < cnt * G; i += THREADS)
      cp_async4(vss + i, vsb + (long long)(i / G) * H + i % G);
  cp_async_commit();
  if (threadIdx.x == 0) {
    oh_tma::mbar_init(&got_max, 1);
    oh_tma::mbar_init(&got_sum, 1);
    oh_tma::mbar_init(&got_pv, 1);
    oh_tma::mbar_init_fence();
    oh_tma::mbar_expect_tx(&got_max, CLUSTER * G * 4);
    oh_tma::mbar_expect_tx(&got_sum, CLUSTER * G * 4);
    oh_tma::mbar_expect_tx(&got_pv, CLUSTER * G * 4);
  }
  cluster_arrive_relaxed();         // this rank's mbarriers are initialised
  // (Its __syncthreads also make them visible to this CTA's threads.)
  stage_query<QUANT, G>(qv, qs, q8w, qscale_s);
  const float qscale = QUANT ? qscale_s[g] : 1.f;

  // -- scores of the slice, and the cluster's max. As a thread takes the
  //    score of a piece of K, it asks for V's piece of the same row and
  //    columns into that slot: V's loads run under the exchanges, and the
  //    CTA holds one slice of rows, not two ---------------------------------
  cp_async_wait_all();              // this thread's K pieces and scales have landed
  float lmax = -FLT_MAX;
  for (int rb = 0; rb < cnt; rb += RPP) {
    const int r = rb + r0;
    const float dot = piece_dot<KV, QUANT>(
        r < cnt ? rows[r * RC + c] : make_int4(0, 0, 0, 0), hc, qs + g * HEAD_DIM,
        q8w + g * (HEAD_DIM / 4));
    if (r < cnt)                    // (the slot's read returned before the dot's shuffles)
      cp_async16(rows + r * RC + c, vb + (long long)r * HD + c * L::VALS);
    if (hc == 0 && r < cnt) {
      const float score = score_of<QUANT>(dot, kss + r * G + g, qscale, sm_scale);
      sc[r * G + g] = score;
      lmax = fmaxf(lmax, score);
    }
  }
  cp_async_commit();
  __syncthreads();
  float m[G];
  at_only(m, g, lmax, -FLT_MAX);
  block_reduce(m, red, MaxOp());
  cluster_wait();                   // every rank's mbarriers are initialised
  push_all(xmax, &got_max, rank, m);
  oh_tma::mbar_wait_cluster(&got_max, 0);
  rank_order(xmax, -FLT_MAX, MaxOp(), m);
  const float m_s = pick(m, gs);

  // -- softmax: l summed over the ranks in rank order (deterministic); entry
  //    i of sc is row i / G, head i % G = gs ----------------------------------
  float lsum = 0.f;
  for (int i = threadIdx.x; i < cnt * G; i += THREADS) {
    const float e = expf(sc[i] - m_s);
    sc[i] = e;
    lsum += e;
  }
  float l[G];
  at_only(l, gs, lsum, 0.f);
  block_reduce(l, red, AddOp());
  push_all(xsum, &got_sum, rank, l);
  oh_tma::mbar_wait_cluster(&got_sum, 0);
  rank_order(xsum, 0.f, AddOp(), l);
  const float l_s = pick(l, gs);
  float pscale[G];
#pragma unroll
  for (int i = 0; i < G; ++i) pscale[i] = 1.f;
  if constexpr (QUANT) {
    float pmax = 0.f;
    for (int i = threadIdx.x; i < cnt * G; i += THREADS) {
      const float pv = (sc[i] / l_s) * vss[i];
      sc[i] = pv;
      pmax = fmaxf(pmax, pv);
    }
    at_only(pscale, gs, pmax, 0.f);
    block_reduce(pscale, red, MaxOp());
    push_all(xpv, &got_pv, rank, pscale);
    oh_tma::mbar_wait_cluster(&got_pv, 0);
    rank_order(xpv, 0.f, MaxOp(), pscale);
#pragma unroll
    for (int i = 0; i < G; ++i) pscale[i] = fmaxf(pscale[i], 1e-20f) / 127.0f;
    const float ps = pick(pscale, gs);
    for (int i = threadIdx.x; i < cnt * G; i += THREADS)
      sc[i] = fminf(fmaxf(rintf(sc[i] / ps), -127.f), 127.f);
  } else {
    for (int i = threadIdx.x; i < cnt * G; i += THREADS) sc[i] = round_prob<KV>(sc[i] / l_s);
  }
  __syncthreads();
  if (pb) {                         // the value sum's probs, for checks
    for (int i = threadIdx.x; i < cnt * G; i += THREADS)
      pb[(long long)(i % G) * T + t0 + i / G] = sc[i];
    if (rank == CLUSTER - 1)
      for (int i = threadIdx.x; i < (T - n) * G; i += THREADS)
        pb[(long long)(i % G) * T + n + i / G] = 0.f;
  }

  // -- values of the slice: each thread sums its 16 B of columns over its
  //    rows (int32 in QUANT mode, exact), then over the warp's rows and the
  //    CTA's warps, in a fixed order --------------------------------------
  cp_async_wait_all();              // this thread's V pieces have landed
  Acc acc[L::VALS];
#pragma unroll
  for (int j = 0; j < L::VALS; ++j) acc[j] = 0;
  for (int r = r0; r < cnt; r += RPP) {
    const int4 ch = rows[r * RC + c];
    if constexpr (QUANT) {
      const int p8 = (int)sc[r * G + g];
#pragma unroll
      for (int j = 0; j < L::VALS; ++j) acc[j] += p8 * int8_at(ch, j);
    } else {
      const float p = sc[r * G + g];
#pragma unroll
      for (int j = 0; j < L::VALS; ++j) acc[j] = fmaf(p, elem<KV>(ch, j), acc[j]);
    }
  }
#pragma unroll
  for (int off = RC; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane < RC)                    // lane c holds chunk c's warp sum
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) part[warp][c * L::VALS + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < GD) {           // this rank's sum, written to rank 0
    Acc total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += part[w][threadIdx.x];
    *cluster.map_shared_rank(&partials[rank][threadIdx.x], 0) = total;
  }
  // The cluster barrier's second phase: each rank's arrival releases its
  // sum to rank 0, which waits for all of them. The other ranks exit
  // without waiting: each has received every value sent to it, and no rank
  // touches their shared memory after this.
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();
  if (threadIdx.x < GD) {
    Acc total = 0;                  // int32 exact; fp32 in rank order
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) total += partials[r][threadIdx.x];
    store_f32(out + qo_off + threadIdx.x,
              QUANT ? (float)total * pick(pscale, threadIdx.x / HEAD_DIM) : (float)total);
  }
}

// K5's dynamic shared memory: a slice's rows of G heads, their value sums,
// scores and scales.
template <typename KV>
size_t smem_split(int T, int G) {
  return (size_t)SplitSmem((T + CLUSTER - 1) / CLUSTER, HEAD_DIM * (int)sizeof(KV), G).total;
}

template <typename KV, typename QO, bool QUANT, int G>
int launch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* lengths, int len_default, int causal, void* out, void* probs,
                 int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  const auto kernel = decode_attention_split_kernel<KV, QO, QUANT, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM_SPLIT);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(CLUSTER, H / G, S * B);
  kernel<<<grid, THREADS, smem_split<KV>(T, G), st>>>(
      (const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, len_default, causal, (QO*)out, (float*)probs, S, H, T, sm_scale);
  return (int)cudaGetLastError();
}

template <typename KV, typename QO, bool QUANT, bool SPLIT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, int len_default, int causal,
           const void* mask, void* out, void* probs, int B, int S, int H, int T,
           float sm_scale, cudaStream_t st) {
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0 ||
      (SPLIT ? H > 65535 || (long long)S * B > 65535 : S > 65535 || B > 65535))
    return (int)cudaErrorInvalidValue;
  if constexpr (SPLIT) {
    if (mask) return (int)cudaErrorInvalidValue;      // the beam mode is K4's
    if (smem_split<KV>(T, 1) > MAX_SMEM_SPLIT) return (int)cudaErrorInvalidValue;
    // int8 K/V: two adjacent heads to a cluster when H is even (see the
    // header), one head otherwise.
    if constexpr (sizeof(KV) == 1)
      if (H % 2 == 0 && smem_split<KV>(T, 2) <= MAX_SMEM_SPLIT)
        return launch_split<KV, QO, QUANT, 2>(q, k, v, ks, vs, lengths, len_default, causal,
                                              out, probs, B, S, H, T, sm_scale, st);
    return launch_split<KV, QO, QUANT, 1>(q, k, v, ks, vs, lengths, len_default, causal, out,
                                          probs, B, S, H, T, sm_scale, st);
  } else {
    const auto kernel = decode_attention_kernel<KV, QO, QUANT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const int ring = ring_passes<KV, QUANT>(T, mask != nullptr);
    if (ring < STAGES) return (int)cudaErrorInvalidValue;
    dim3 grid(H, S, B);
    kernel<<<grid, THREADS, (size_t)ring * PASS_BYTES + direct_tail<QUANT>(T, mask != nullptr),
             st>>>((const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
                   (const int*)lengths, len_default, causal, (const unsigned char*)mask,
                   (QO*)out, (float*)probs, S, H, T, sm_scale, ring);
    return (int)cudaGetLastError();
  }
}

template <typename QO, bool SPLIT>
int dispatch_kv(int kv_kind, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* lengths,
                int len_default, int causal, const void* mask, void* out, void* probs,
                int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  switch (kv_kind) {
    case 0: return launch<int8_t, QO, true, SPLIT>(q, k, v, ks, vs, lengths, len_default, causal,
                                                   mask, out, probs, B, S, H, T, sm_scale, st);
    case 1: return launch<int8_t, QO, false, SPLIT>(q, k, v, ks, vs, lengths, len_default, causal,
                                                    mask, out, probs, B, S, H, T, sm_scale, st);
    case 2: return launch<__nv_bfloat16, QO, false, SPLIT>(q, k, v, ks, vs, lengths, len_default,
                                                           causal, mask, out, probs, B, S, H, T,
                                                           sm_scale, st);
    case 3: return launch<float, QO, false, SPLIT>(q, k, v, ks, vs, lengths, len_default, causal,
                                                   mask, out, probs, B, S, H, T, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, S, H*64] contiguous, fp32 (qo_kind 0) or bf16 (1).
// k, v: [B, T, H*64] contiguous: int8 with fp32 scales ks, vs [B, T, H]
// (kv_kind 0), int8 taken as plain numbers (1), bf16 (2) or fp32 (3).
// lengths: int32 [B] or null (then every row has len_default).
// Query s of row b sees keys t < lengths[b] + (causal ? s : 0), at most T.
// mask: null, or the beam mode (K4 only): uint8 [B, S, T], and key t is
// visible to query s of row b iff it is nonzero (and t < the length above;
// the beam mode passes no lengths, len_default T and causal 0).
// probs: null, or fp32 [B, S, H, T] that takes the probs of the value sum
// (int8 levels in the int8 mode; 0 past each query's keys), for checks.
// pipelined: 0 = direct loads (K4), 1 = the cluster split over T (K5).
extern "C" int oh_decode_attention(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* lengths, int len_default,
                                   int causal, const void* mask, void* out, void* probs,
                                   int B, int S, int H, int T, float sm_scale, int kv_kind,
                                   int qo_kind, int pipelined, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (qo_kind == 0)
    return pipelined
        ? dispatch_kv<float, true>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                   mask, out, probs, B, S, H, T, sm_scale, st)
        : dispatch_kv<float, false>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                    mask, out, probs, B, S, H, T, sm_scale, st);
  if (qo_kind == 1)
    return pipelined
        ? dispatch_kv<__nv_bfloat16, true>(kv_kind, q, k, v, ks, vs, lengths, len_default,
                                           causal, mask, out, probs, B, S, H, T, sm_scale, st)
        : dispatch_kv<__nv_bfloat16, false>(kv_kind, q, k, v, ks, vs, lengths, len_default,
                                            causal, mask, out, probs, B, S, H, T, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
