// Decode attention over the flat [B, T, H*64] caches of the decode step,
// with two kernels that compute the same function: K4 (one CTA per query
// streams the keys) and K5 (a thread-block cluster per query, or per row
// for its S queries, splits the keys).
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
// K4's beam mode (a source-row table) is the grouped beam step's
// self-attention, the function of the JAX model's _attend_decode_flat_beam
// (XLA einsums there, no Pallas kernel): the K beams of a group attend over
// the group's K cache rows of T positions (a free view [G, K*T, H*64] of the
// row-contiguous [G*K, T, H*64] cache) under each beam's ancestry. The
// ancestry has at most one writer row for each (beam, position), so the
// caller turns it once a step into a table rows [G, K, T] (int8: that row,
// or -1) and passes each group's length n = pos + 1: key t < n of query
// (g, i) is position t of cache row g*K + rows[g, i, t], flat key
// rows*T + t of the view; a -1 entry is neither loaded nor counted (it
// scores -inf, as the reference's finfo(f32).min fill gives) and keys at
// t >= n are never read. A query thus reads at most T rows, not K*T, and
// the beam mode is K4's direct path over positions: bf16 and int8 K and V
// of T <= 448 positions go in flight whole with one wait, an fp32 cache of
// 448 streams through the ring. The table row must be read before the rows'
// addresses exist: each thread asks for its (at most four) bytes of it at
// entry beside the length, which the self mode waits on already, and stages
// them in shared memory (T bytes, one CTA barrier), so the dependent trip
// costs the barrier and at most one more round trip. The sums run over
// positions t, in K4's fixed order.
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
// K5's multi-query mode (S > 1 queries a row, no causal offset: a beam
// group's K beams folded into its row's queries, a speculative verify
// block, a prefill's cross-attention) computes the function of the JAX
// model's _attend_decode_flat_multi (openhush_tpu/models/whisper/model.py:
// 677, XLA einsums over the cache read once for all S queries), on K5 in
// place of S clusters per row that each read the row's keys
// (decode_attention_multi_kernel). Its bound is
// still bytes: a row's keys, values and scales once, whatever S (G=4 beam
// groups of K=5: 16.3 MB, 0.0049 ms at 3.35 TB/s). One cluster takes (G
// heads, row): each rank loads its slice once, takes every query's scores
// from that copy (the dots of int8 levels by dp4a, integer-exact; the
// query levels of a thread's 16 columns held in registers), and runs each
// exchange once for all of a block's (query, head) pairs (S*G values a
// rank in one round of st.async on one mbarrier phase; both heads of a
// query in one butterfly). V follows K into the same slots. The int8 value
// sum is packed: each quad of rows' column words are transposed to a word
// a column (four byte permutes a word) and summed by dp4a against each
// query's prob levels of those rows, packed as bytes after the softmax,
// so a thread holds 4 sums a query, not 16. Each query keeps the
// arithmetic of a launch of it alone (the same entries per thread, the same
// reductions in the same order, the same rank order; the int8 sums are
// exact), so a multi-query launch gives, query by query, the bits of S
// single-query launches. The kernel is compiled for each block size SQ =
// min(S, S_MAX) (S_MAX = 6: S*H <= 128 at large-v3's 20 heads), so no
// query of a block is guarded: a guard per query put each query's chain in
// a basic block of its own and the block's queries ran one after another
// (PERF.md). Above S_MAX the cluster walks its queries in blocks of S_MAX
// over the same slice, V then in a second slice and the ranks' sums in two
// buffers, the last block repeating the row's last query where it is short
// (and writing nothing for it); the exchanges' mbarriers go through a phase
// a block, re-armed right after their wait, before the rank sends what
// lets the others start the next block. A CTA of one cluster carries all
// of a block's queries on 128 threads, which serialises their chains: at
// batch 1 (80 CTAs on 132 SMs, a warp a scheduler) that lost to the
// per-query grid. So where the grid leaves SMs idle (B * H/G * 8 <= the SM
// count) the CTA is SQ groups of 128 threads, a group a query, each
// group's thread vt taking the per-query kernel's thread vt's entries; the
// slice still loads once (group 0 copies it, a CTA barrier shares it).
// S = 1 and causal blocks keep the per-query kernel
// (decode_attention_split_kernel) as it was: the multi-query code at S = 1
// measured slower there (PERF.md), and the two give the same bits query by
// query. An int8 mma.sync (m16n8k32) score pass measured 2-3% faster at B=4
// and 8, 8% slower at B=1, and is not used (PERF.md).
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
constexpr int TAB_LOADS = 4;                  // K4's beam mode: table bytes a thread
constexpr int PASS_BYTES = THREADS * 16;      // K4: a pass, 16 B per thread
constexpr int CLUSTER = 8;                    // K5: CTAs per query (per row, multi)
constexpr int S_MAX = 6;                      // K5's multi-query mode: a block's queries
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

// Element vt < G*64 of queries s0, ..., s0 + N - 1 of a row (qp: its query
// 0; queries HD elements apart) as fp32, 0 for vt >= G*64; a query past
// s_last is taken as s_last (a block past the row's last query repeats it
// and writes nothing).
template <int G, int N, typename QO>
__device__ __forceinline__ void query_elems(const QO* qp, int HD, int s0, int s_last, int vt,
                                            float (&qv)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    qv[j] = vt < G * HEAD_DIM ? load_f32(qp + (long long)min(s0 + j, s_last) * HD + vt) : 0.f;
}

// A group's N queries sg, ..., sg + N - 1 of a block (the per-query
// kernel: N = 1, sg = 0, vt = threadIdx.x), from query_elem(s) on each of
// its threads (vt: the thread in the group), into shared memory: their
// fp32 values (query s, head g at qs[(s*G + g) * 64]) and, in QUANT mode,
// each (query, head)'s int8 levels (four to a word, at q8w[(s*G + g) *
// 16]) and scale (qscale_s[s*G + g]), a warp of the group taking each
// (query, head) in turn:
//   qscale = max(max|q_h|, 1e-10) / 127;  q8 = clip(rint(q_h / qscale)).
// Every thread calls it.
template <bool QUANT, int G, int N>
__device__ __forceinline__ void stage_queries(const float (&qv)[N], int sg, int vt, float* qs,
                                              int* q8w, float* qscale_s) {
  const int lane = vt & 31, warp = vt >> 5;
  if (vt < G * HEAD_DIM)
#pragma unroll
    for (int j = 0; j < N; ++j) qs[(sg + j) * G * HEAD_DIM + vt] = qv[j];
  __syncthreads();
  if constexpr (QUANT)
    for (int pr = sg * G + warp; pr < (sg + N) * G; pr += WARPS) {
      const float* qh = qs + pr * HEAD_DIM;
      float m = fmaxf(fabsf(qh[lane]), fabsf(qh[lane + 32]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float qscale = fmaxf(m, 1e-10f) / 127.0f;
      if (lane == 0) qscale_s[pr] = qscale;
      if (lane < HEAD_DIM / 4) {
        int w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float r = fminf(fmaxf(rintf(qh[4 * lane + j] / qscale), -127.f), 127.f);
          w |= ((int)r & 0xff) << (8 * j);
        }
        q8w[pr * (HEAD_DIM / 4) + lane] = w;
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

// piece_dot with this piece's four words of query levels (QUANT) in
// registers: the multi-query kernel holds each query's.
template <typename KV, bool QUANT>
__device__ __forceinline__ float piece_dot_regs(const int4& ch, int c, const float* qs,
                                                const int (&q8)[4]) {
  using L = Layout<KV>;
  if constexpr (QUANT) {
    int acc = 0;
    acc = __dp4a(ch.x, q8[0], acc);
    acc = __dp4a(ch.y, q8[1], acc);
    acc = __dp4a(ch.z, q8[2], acc);
    acc = __dp4a(ch.w, q8[3], acc);
#pragma unroll
    for (int off = L::CHUNKS / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return (float)acc;
  }
  return piece_dot<KV, false>(ch, c, qs, nullptr);
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
// then, in the beam mode, the query's row of the source-row table (a byte a
// position).
template <bool QUANT> __host__ __device__ constexpr size_t direct_tail(int T, bool beam) {
  return (size_t)T * sizeof(float) * (QUANT ? 3 : 1) + (beam ? (size_t)(T + 15) / 16 * 16 : 0);
}
// The ring's passes for a cache of T rows: K and V of all T rows, rounded
// up to whole stages, or as many whole stages as MAX_SMEM holds beside the
// scores (then the rows stream through the ring). Fewer than STAGES: no fit.
template <typename KV, bool QUANT> int ring_passes(int T, bool beam) {
  using L = Layout<KV>;
  const long long need = 2LL * ((T + L::RPP - 1) / L::RPP);
  const long long want = (need + STAGES - 1) / STAGES * STAGES;
  const long long room = ((long long)MAX_SMEM - (long long)direct_tail<QUANT>(T, beam)) /
                         PASS_BYTES / STAGES * STAGES;
  return (int)(want < room ? want : room);
}

// K4: the index of key t < n among the keys of its row (t itself) or, in
// the beam mode, of its group (position t of the group's cache row tab[t]:
// tab[t] * T + t); -1 for a key that is not read (t >= n, or tab[t] = -1).
template <bool BEAM>
__device__ __forceinline__ long long key_index(const int8_t* tab, int t, int n, int T) {
  if (t >= n) return -1;
  if constexpr (BEAM) {
    const int r = tab[t];
    return r < 0 ? -1 : (long long)r * T + t;
  }
  return t;
}
template <bool BEAM>
__device__ __forceinline__ bool visible(const int8_t* tab, int t, int n) {
  return t < n && (!BEAM || tab[t] >= 0);
}

// K4: asks for this thread's pieces of passes [p0, p1) (pass p < kp: K's
// rows, else V's) in consecutive slots from `slot`, and the ks of its K
// rows in QUANT mode, as one cp.async group; a key that is not read leaves
// its slot as it was. Returns whether the group holds a copy. (No division
// here or in the loops that call it: at a few us a launch, a division's
// chain of dependent instructions shows.)
template <typename KV, bool QUANT, bool BEAM>
__device__ __forceinline__ bool issue_passes(int4* slot, float* kss, const KV* kb, const KV* vb,
                                             const float* ksb, const int8_t* tab, int p0, int p1,
                                             int kp, int n, int T, int HD, int H) {
  using L = Layout<KV>;
  const int c = threadIdx.x % L::CHUNKS, r0 = threadIdx.x / L::CHUNKS;
  bool copied = false;
  for (int p = p0; p < p1; ++p, slot += THREADS) {
    const bool is_k = p < kp;
    const int t = (is_k ? p : p - kp) * L::RPP + r0;
    const long long key = key_index<BEAM>(tab, t, n, T);
    if (key >= 0) {
      cp_async16(slot + threadIdx.x, (is_k ? kb : vb) + key * HD + c * L::VALS);
      if (QUANT && is_k && c == 0) cp_async4(kss + t, ksb + key * H);
      copied = true;
    }
  }
  cp_async_commit();
  return copied;
}

// K4, streaming: moves to the next pass's slot; once a stage has been read,
// asks for stage `next` into its slots.
template <typename KV, bool QUANT, bool BEAM>
__device__ __forceinline__ void next_pass(int4*& cur, int& in_stage, int& next, unsigned& held,
                                          int4* slots, int span, int sp, int P, float* kss,
                                          const KV* kb, const KV* vb, const float* ksb,
                                          const int8_t* tab, int kp, int n, int T, int HD, int H) {
  cur += THREADS;
  if (++in_stage == sp) {
    const bool copied = issue_passes<KV, QUANT, BEAM>(cur - sp * THREADS, kss, kb, vb, ksb, tab,
                                                      next * sp, min((next + 1) * sp, P), kp, n,
                                                      T, HD, H);
    held = (held << 1) | (copied ? 1u : 0u);
    ++next;
    in_stage = 0;
    if (cur == slots + span * THREADS) cur = slots;
  }
}

// K4: the score of key t from this thread's piece `ch` of its row (every
// lane calls it; lane c == 0 of the row writes sc[t]); returns the running
// max of the scores this thread wrote. In the beam mode (tab: the query's
// row of the table in shared memory) a position with no source row scores
// -inf, so its exp is exactly 0, as the reference's finfo(f32).min fill
// gives, and it does not enter the max.
template <typename KV, bool QUANT, bool BEAM>
__device__ __forceinline__ float score_pass(const int4& ch, int t, int n, int c, const float* qw,
                                            const int* q8, const float* kss, float qscale,
                                            float sm_scale, const int8_t* tab, float* sc,
                                            float lmax) {
  const bool vis = visible<BEAM>(tab, t, n);
  const float dot = piece_dot<KV, QUANT>(vis ? ch : make_int4(0, 0, 0, 0), c, qw, q8);
  if (c == 0 && t < n) {
    if (!vis) {
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
// column sums (int32 in QUANT mode). A key that was not read is skipped:
// its slot holds stale bytes, which a prob of 0 need not cancel (0 * NaN).
template <typename KV, bool QUANT, bool BEAM, typename Acc>
__device__ __forceinline__ void value_pass(Acc (&acc)[Layout<KV>::VALS], const int4& ch, int t,
                                           int n, const int8_t* tab, const float* sc) {
  if (!visible<BEAM>(tab, t, n)) return;
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
// BEAM: the beam mode (see the header): row b is a group of S beams, query
// s its beam s, T its positions, and key t of query s is position t of the
// group's cache row rows[b, s, t].
template <typename KV, typename QO, bool QUANT, bool BEAM>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const QO* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        int len_default, int causal, const int8_t* __restrict__ rows,
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
  int8_t* tab = reinterpret_cast<int8_t*>(sc + T * (QUANT ? 3 : 1));   // [T], BEAM
  __shared__ float qs[WARPS][HEAD_DIM];              // each warp's copy
  __shared__ int q8w[WARPS][HEAD_DIM / 4];
  __shared__ float red_max[WARPS], red_sum[WARPS], red_pv[WARPS];
  __shared__ Acc part[WARPS][HEAD_DIM];

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const long long qo_off = ((long long)b * S + s) * HD + h * HEAD_DIM;
  // The beam mode: this thread's bytes of the query's table row, asked for
  // beside the length (one trip for both; T <= TAB_LOADS * THREADS).
  int tv[BEAM ? TAB_LOADS : 1];
  if constexpr (BEAM) {
    const int8_t* trow = rows + ((long long)b * S + s) * T;
#pragma unroll
    for (int j = 0; j < TAB_LOADS; ++j) {
      const int t = threadIdx.x + j * THREADS;
      tv[j] = t < T ? trow[t] : -1;
    }
  }
  int n = (lengths ? lengths[b] : len_default) + (causal ? s : 0);
  n = n < T ? n : T;
  float* pb = probs ? probs + (((long long)b * S + s) * H + h) * T : nullptr;
  if (n <= 0) {                     // no visible key: callers never ask
    if (threadIdx.x < HEAD_DIM) store_f32(out + qo_off + threadIdx.x, 0.f);
    if (pb)
      for (int t = threadIdx.x; t < T; t += THREADS) pb[t] = 0.f;
    return;
  }
  const long long row0 = (long long)b * (BEAM ? S : 1) * T;   // the row's (group's) keys
  const KV* kb = k + row0 * HD + h * HEAD_DIM;
  const KV* vb = v + row0 * HD + h * HEAD_DIM;
  const float* ksb = QUANT ? ks + row0 * H + h : nullptr;
  const float* vsb = QUANT ? vs + row0 * H + h : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = threadIdx.x % L::CHUNKS, r0 = threadIdx.x / L::CHUNKS;

  // -- the query's load first; then every pass of the ring in flight -------
  const float qa = load_f32(q + qo_off + lane), qb = load_f32(q + qo_off + lane + 32);
  if constexpr (BEAM) {             // the table row, before any address
#pragma unroll
    for (int j = 0; j < TAB_LOADS; ++j) {
      const int t = threadIdx.x + j * THREADS;
      if (t < T) tab[t] = (int8_t)tv[j];
    }
    __syncthreads();
  }
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
      const long long key = key_index<BEAM>(tab, t, n, T);
      if (key >= 0) {
        cp_async4(vss + t, vsb + key * H);
        vs_copied = true;
      } else if (t < n) {
        vss[t] = 0.f;               // not read (beam mode): its prob is 0
      }
    }
  // A group with no copy is never pending, so cp.async.wait_group counts
  // only this thread's groups that hold copies: bit i of `held` says
  // whether the i-th most recent stage gave this thread any.
  unsigned held = 0;
  if (whole) {
    issue_passes<KV, QUANT, BEAM>(slots, kss, kb, vb, ksb, tab, 0, P, kp, n, T, HD, H);
  } else {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      const bool copied = issue_passes<KV, QUANT, BEAM>(slots + st * sp * THREADS, kss, kb, vb,
                                                        ksb, tab, st * sp, min((st + 1) * sp, P),
                                                        kp, n, T, HD, H);
      held = (held << 1) | (copied || (st == 0 && vs_copied) ? 1u : 0u);
    }
  }
  // Streaming: the pass being read, its place in its stage, and the next
  // stage to ask for once this one has been read (into the same slots).
  int4* cur = slots;
  int in_stage = 0, next = STAGES;

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
      lmax = score_pass<KV, QUANT, BEAM>(slots[p * THREADS + threadIdx.x], p * L::RPP + r0, n, c,
                                         qw, q8, kss, qscale, sm_scale, tab, sc, lmax);
  } else {
    for (int p = 0; p < kp; ++p) {
      if (in_stage == 0) wait_stage(held);   // this pass's stage has landed
      lmax = score_pass<KV, QUANT, BEAM>(cur[threadIdx.x], p * L::RPP + r0, n, c, qw, q8, kss,
                                         qscale, sm_scale, tab, sc, lmax);
      next_pass<KV, QUANT, BEAM>(cur, in_stage, next, held, slots, span, sp, P, kss, kb, vb, ksb,
                                 tab, kp, n, T, HD, H);
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
  if (l == 0.f) {                   // the table hid every key: only a group
    cp_async_wait<0>();             // whose outputs the caller discards
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
      value_pass<KV, QUANT, BEAM>(acc, slots[p * THREADS + threadIdx.x], (p - kp) * L::RPP + r0,
                                  n, tab, sc);
  } else {
    for (int p = kp; p < P; ++p) {
      if (in_stage == 0) wait_stage(held);
      value_pass<KV, QUANT, BEAM>(acc, cur[threadIdx.x], (p - kp) * L::RPP + r0, n, tab, sc);
      next_pass<KV, QUANT, BEAM>(cur, in_stage, next, held, slots, span, sp, P, kss, kb, vb, ksb,
                                 tab, kp, n, T, HD, H);
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

// v[i] for an i known only at run time, without indexing a register array.
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (i == j) x = v[j];
  return x;
}

// The CTA's reduction by `op` of a block's SQ*G (query, head) values,
// each thread holding x[s] for one head of each query: lane bit SPLIT
// tells the G = 2 heads apart (lane l holds head 0 or 1 as l & SPLIT is 0
// or not). A butterfly of shuffles within each warp that skips offset
// SPLIT leaves each lane its head's total over the warp, in the order of a
// butterfly over all 32 lanes with the other head's lanes at op's identity
// (x op identity is x, exactly); then the warps in order. Every thread
// gets v[s*G + head]. `red` holds WARPS * SQ * G floats (a group of
// THREADS threads' own).
template <int SQ, int G, int SPLIT, typename Op>
__device__ __forceinline__ void block_reduce_heads(const float (&x)[SQ], float (&v)[SQ * G],
                                                   float* red, Op op) {
  constexpr int NV = SQ * G;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % THREADS) >> 5;   // in the group
  float y[SQ];
#pragma unroll
  for (int s = 0; s < SQ; ++s) y[s] = x[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (G == 1 || off != SPLIT)
#pragma unroll
      for (int s = 0; s < SQ; ++s) y[s] = op(y[s], __shfl_xor_sync(0xffffffffu, y[s], off));
  if (lane == 0 || (G == 2 && lane == SPLIT))
#pragma unroll
    for (int s = 0; s < SQ; ++s) red[warp * NV + s * G + (lane == 0 ? 0 : 1)] = y[s];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = red[i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v[i] = op(v[i], red[w * NV + i]);
  }
  __syncthreads();
}

// A group of THREADS threads' (vt: the thread in it) N of the NV values a
// rank sends (the same on all of its threads) land in slot[rank * NV + base
// + i] of every rank's copy of `slot`, counted on that rank's `bar`: thread
// i * CLUSTER + r of the group writes value i to rank r. A rank has all
// CLUSTER * NV values once its `bar` completes its phase.
template <int N>
__device__ __forceinline__ void push_all(float* slot, int NV, int base, uint64_t* bar, int rank,
                                         const float (&x)[N], int vt) {
  if (vt < CLUSTER * N) {
    const int dst = vt % CLUSTER, i = vt / CLUSTER;
    st_async(at_rank(slot + rank * NV + base + i, dst), __float_as_uint(pick(x, i)),
             at_rank(bar, dst));
  }
}

// Values base .. base + N - 1 of the NV each rank sent, each from the ranks
// in rank order, so that every rank gets the same numbers.
template <int N, typename Op>
__device__ __forceinline__ void rank_order(const float* slot, int NV, int base, float init, Op op,
                                           float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = init;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) x = op(x, slot[r * NV + base + i]);
    out[i] = x;
  }
}

struct MaxOp {
  __device__ float operator()(float a, float x) const { return fmaxf(a, x); }
};
struct AddOp {
  __device__ float operator()(float a, float x) const { return a + x; }
};

// K5's dynamic shared memory, in bytes, for slices of at most per_cap rows
// of G heads and blocks of at most nq queries: the rows (K's, then V's in
// the same slots; V's in a second slice when the cluster walks several
// blocks), each query's value sums by warp (packed: by quad of rows) and,
// on rank 0, every rank's (two buffers when walking), then each query's
// scores, ks and vs and, packed (the multi-query mode's int8 value pass),
// each (query, head)'s prob levels as bytes, four rows to a word. Packed
// slices are padded to whole quads of rows.
struct SplitSmem {
  int vrows, sums, partials, sc, ks, vs, p8, total;
  __host__ __device__ SplitSmem(int per_cap, int row_bytes, int G, int nq, bool walk, bool packed)
      : vrows(walk ? quads(per_cap, packed) * row_bytes * G : 0),
        sums((walk ? 2 : 1) * quads(per_cap, packed) * row_bytes * G),
        partials(sums + nq * (packed ? 4 * THREADS : WARPS * G * HEAD_DIM) * 4),
        sc(partials + (walk ? 2 : 1) * CLUSTER * nq * G * HEAD_DIM * 4),
        ks(sc + nq * per_cap * G * 4),
        vs(ks + per_cap * G * 4),
        p8(vs + per_cap * G * 4),
        total(p8 + (packed ? nq * G * quads(per_cap, true) : 0)) {}
  // Rows, rounded up to whole quads when packed.
  __host__ __device__ static int quads(int rows, bool packed) {
    return packed ? (rows + 3) / 4 * 4 : rows;
  }
};

// Four words a_i, the same 4 columns of rows i = 0..3 (a byte a column),
// as four words c_j, the 4 rows of column j (a byte a row): a 4x4 byte
// transpose, so that dp4a sums over rows.
__device__ __forceinline__ void transpose4(int a0, int a1, int a2, int a3, int (&c)[4]) {
  const int t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const int t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

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
  const SplitSmem lay(per_cap, HEAD_DIM * (int)sizeof(KV), G, 1, false, false);
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
  stage_queries<QUANT, G, 1>({qv}, 0, threadIdx.x, qs, q8w, qscale_s);
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
  block_reduce_heads<1, G, L::CHUNKS>({lmax}, m, red, MaxOp());   // head g = lane's bit CHUNKS
  cluster_wait();                   // every rank's mbarriers are initialised
  push_all(xmax, G, 0, &got_max, rank, m, threadIdx.x);
  oh_tma::mbar_wait_cluster(&got_max, 0);
  rank_order(xmax, G, 0, -FLT_MAX, MaxOp(), m);
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
  block_reduce_heads<1, G, 1>({lsum}, l, red, AddOp());           // head gs = lane's bit 0
  push_all(xsum, G, 0, &got_sum, rank, l, threadIdx.x);
  oh_tma::mbar_wait_cluster(&got_sum, 0);
  rank_order(xsum, G, 0, 0.f, AddOp(), l);
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
    block_reduce_heads<1, G, 1>({pmax}, pscale, red, MaxOp());
    push_all(xpv, G, 0, &got_pv, rank, pscale, threadIdx.x);
    oh_tma::mbar_wait_cluster(&got_pv, 0);
    rank_order(xpv, G, 0, 0.f, MaxOp(), pscale);
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

// K5's multi-query mode (see the header): a cluster of CLUSTER CTAs per
// (G adjacent heads, row), which takes the row's S >= 2 queries (no causal
// offset: each sees the row's n keys) in blocks of SQ over one copy of the
// slice. Rank r takes keys [r*per, (r+1)*per) of the row's n (per =
// ceil(n / CLUSTER); a slice may be empty), as the per-query kernel does.
// A CTA is SQ / QG groups of THREADS threads, group j taking queries
// j*QG .. j*QG + QG - 1 of a block; thread vt of a group takes the entries
// thread vt of a per-query CTA takes, so each query keeps that kernel's
// order. QG = SQ: one group holds every query (a thread carries SQ
// queries); QG = 1: a group a query, for grids that leave SMs idle.
template <typename KV, typename QO, bool QUANT, int G, int SQ, int QG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS * (SQ / QG))
decode_attention_multi_kernel(const QO* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, const int* __restrict__ lengths,
                              int len_default, QO* __restrict__ out,
                              float* __restrict__ probs, int S, int H, int T,
                              float sm_scale) {
  using L = Layout<KV>;
  using Acc = typename std::conditional<QUANT, int, float>::type;   // value sums
  constexpr int NG = SQ / QG;           // groups of THREADS threads
  constexpr int RC = G * L::CHUNKS;     // threads per row of the CTA's heads
  constexpr int RPP = THREADS / RC;     // rows per pass
  constexpr int GD = G * HEAD_DIM;      // the heads' columns
  constexpr int NV = SQ * G;            // a block's (query, head) pairs
  constexpr int NVG = QG * G;           // a group's
  static_assert(SQ >= 2 && SQ % QG == 0 && RC <= 32 && GD <= THREADS &&
                CLUSTER * NVG <= THREADS, "a row's pieces within a warp; one round an exchange");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h0 = blockIdx.y * G, b = blockIdx.z;
  const bool walk = S > SQ;
  const int per_cap = (T + CLUSTER - 1) / CLUSTER;
  const SplitSmem lay(per_cap, HEAD_DIM * (int)sizeof(KV), G, SQ, walk, QUANT);
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rows = reinterpret_cast<int4*>(smem);                  // [per_cap][RC]
  int4* vrows = reinterpret_cast<int4*>(smem + lay.vrows);      // V's: rows unless walking
  Acc* part = reinterpret_cast<Acc*>(smem + lay.sums);          // [SQ][WARPS or quads][GD]
  Acc* partials = reinterpret_cast<Acc*>(smem + lay.partials);  // rank 0's [CLUSTER][SQ][GD]
  float* sc = reinterpret_cast<float*>(smem + lay.sc);          // [SQ][per_cap * G]
  float* kss = reinterpret_cast<float*>(smem + lay.ks);         // [per_cap][G]
  float* vss = reinterpret_cast<float*>(smem + lay.vs);         // [per_cap][G]
  int8_t* p8b = reinterpret_cast<int8_t*>(smem + lay.p8);       // QUANT: [SQ][G][quads]
  const int QB = SplitSmem::quads(per_cap, true);               // a (query, head)'s bytes
  __shared__ float qs[SQ * GD];
  __shared__ int q8w[SQ * GD / 4];
  __shared__ float red[WARPS * NV];     // [NG][WARPS][NVG]
  __shared__ float qscale_s[NV];
  // Every rank's max, sum and max(p*vs) per (query, head), written here by
  // each rank, and the mbarriers that count their arrival.
  __shared__ float xmax[CLUSTER * NV], xsum[CLUSTER * NV], xpv[CLUSTER * NV];
  __shared__ __align__(8) uint64_t got_max, got_sum, got_pv;

  const int HD = H * HEAD_DIM;
  const int grp = threadIdx.x / THREADS, vt = threadIdx.x % THREADS;
  const int sg = grp * QG;          // the group's first query of a block
  int n = lengths ? lengths[b] : len_default;
  n = n < T ? n : T;
  if (n <= 0) {                     // the same for the whole cluster
    if (rank == 0)
      for (int s = grp; s < S; s += NG) {
        if (vt < GD)
          store_f32(out + ((long long)b * S + s) * HD + h0 * HEAD_DIM + vt, 0.f);
        if (probs)                  // head h0 + g's probs at g * T
          for (int t = vt; t < G * T; t += THREADS)
            probs[(((long long)b * S + s) * H + h0) * T + t] = 0.f;
      }
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
  const int c = vt % RC;            // this thread's 16 B of a row: in head
  const int g = c / L::CHUNKS;      // h0 + g, its column chunk hc
  const int hc = c % L::CHUNKS;
  const int r0 = vt / RC;
  const int gs = vt % G;            // the head of this thread's softmax entries
  const int warp = vt / 32, lane = vt % 32;   // in the group
  const int SCW = per_cap * G;      // a query's scores
  float* gred = red + grp * WARPS * NVG;
  constexpr uint32_t TX = CLUSTER * NV * 4;   // an exchange's bytes

  // -- the first block's queries first, ahead of the slice's; then group
  //    0 puts the slice's K and scales (walking: and V, into its own
  //    slice) in flight at once, each thread copying the pieces the
  //    per-query kernel's thread vt copies. With one group no barrier
  //    guards the buffers (every thread reads only what it copied) ------
  float qv[QG];
  const QO* qrow = q + (long long)b * S * HD + h0 * HEAD_DIM;
  query_elems<G, QG>(qrow, HD, sg, S - 1, vt, qv);
  if (grp == 0) {
    for (int r = r0; r < cnt; r += RPP) {
      cp_async16(rows + r * RC + c, kb + (long long)r * HD + c * L::VALS);
      if (QUANT && hc == 0) cp_async4(kss + r * G + g, ksb + (long long)r * H + g);
      if (walk) cp_async16(vrows + r * RC + c, vb + (long long)r * HD + c * L::VALS);
    }
    if constexpr (QUANT)
      for (int i = vt; i < cnt * G; i += THREADS)
        cp_async4(vss + i, vsb + (long long)(i / G) * H + i % G);
    cp_async_commit();
  }
  if (threadIdx.x == 0) {
    oh_tma::mbar_init(&got_max, 1);
    oh_tma::mbar_init(&got_sum, 1);
    if (QUANT) oh_tma::mbar_init(&got_pv, 1);
    oh_tma::mbar_init_fence();
    oh_tma::mbar_expect_tx(&got_max, TX);
    oh_tma::mbar_expect_tx(&got_sum, TX);
    if (QUANT) oh_tma::mbar_expect_tx(&got_pv, TX);
  }
  cluster_arrive_relaxed();         // this rank's mbarriers are initialised
  // (The __syncthreads in stage_queries also make them visible to this
  // CTA's threads.)

  // Blocks of at most SQ queries, each with the arithmetic of a launch of
  // each of its queries alone: the same entries per thread, the same
  // reductions in the same order. An exchange's slots and mbarrier serve
  // every block (phase blk & 1): a rank writes block blk + 1's values only
  // after every rank has sent it block blk's last exchange, which each
  // sends after reading its slots and re-arming its mbarriers.
  for (int s0 = 0, blk = 0; s0 < S; s0 += SQ, ++blk) {
    const int nq = min(SQ, S - s0);   // the block's queries to write
    const int ph = blk & 1;
    const bool last = s0 + SQ >= S;
    if (blk > 0) query_elems<G, QG>(qrow, HD, s0 + sg, S - 1, vt, qv);
    stage_queries<QUANT, G, QG>(qv, sg, vt, qs, q8w, qscale_s);

    // -- scores of the slice, and the cluster's max. One group: as a
    //    thread takes the scores of a piece of K, it asks for V's piece of
    //    the same row and columns into that slot, so V's loads run under
    //    the exchanges and the CTA holds one slice of rows, not two; with
    //    several, group 0 asks for V once every group has read K --------
    if (blk == 0) {
      cp_async_wait_all();          // group 0's K pieces and scales
      if (NG > 1) __syncthreads();  // ... for every group
    }
    // The levels of this thread's 16 columns of each query, and their scales.
    int q8r[QG][4];
    float qsc[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q8r[j][i] = QUANT ? q8w[((sg + j) * G + g) * (HEAD_DIM / 4) + 4 * hc + i] : 0;
      qsc[j] = QUANT ? qscale_s[(sg + j) * G + g] : 1.f;
    }
    float lmax[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) lmax[j] = -FLT_MAX;
    for (int rb = 0; rb < cnt; rb += RPP) {
      const int r = rb + r0;
      const int4 ch = r < cnt ? rows[r * RC + c] : make_int4(0, 0, 0, 0);
      float dot[QG];
#pragma unroll
      for (int j = 0; j < QG; ++j)
        dot[j] = piece_dot_regs<KV, QUANT>(ch, hc, qs + (sg + j) * GD + g * HEAD_DIM, q8r[j]);
      if (NG == 1 && !walk && r < cnt)   // (the slot's read returned before the dots' shuffles)
        cp_async16(rows + r * RC + c, vb + (long long)r * HD + c * L::VALS);
      if (hc == 0 && r < cnt)
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          const float score = score_of<QUANT>(dot[j], kss + r * G + g, qsc[j], sm_scale);
          sc[(sg + j) * SCW + r * G + g] = score;
          lmax[j] = fmaxf(lmax[j], score);
        }
    }
    if (NG == 1 && !walk) cp_async_commit();
    __syncthreads();
    if (NG > 1 && !walk && blk == 0 && grp == 0) {
      for (int r = r0; r < cnt; r += RPP)
        cp_async16(rows + r * RC + c, vb + (long long)r * HD + c * L::VALS);
      cp_async_commit();
    }
    float m[NVG];
    block_reduce_heads<QG, G, L::CHUNKS>(lmax, m, gred, MaxOp());   // head g = lane's bit CHUNKS
    if (blk == 0) cluster_wait();   // every rank's mbarriers are initialised
    push_all(xmax, NV, sg * G, &got_max, rank, m, vt);
    oh_tma::mbar_wait_cluster(&got_max, ph);
    if (!last && threadIdx.x == 0) oh_tma::mbar_expect_tx(&got_max, TX);
    rank_order(xmax, NV, sg * G, -FLT_MAX, MaxOp(), m);
    float ms[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) ms[j] = pick(m, j * G + gs);

    // -- softmax: l summed over the ranks in rank order (deterministic);
    //    entry i of a query's scores is row i / G, head i % G = gs --------
    float lsum[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) lsum[j] = 0.f;
    for (int i = vt; i < cnt * G; i += THREADS)
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        float* e_at = sc + (sg + j) * SCW + i;
        const float e = expf(*e_at - ms[j]);
        *e_at = e;
        lsum[j] += e;
      }
    float l[NVG];
    block_reduce_heads<QG, G, 1>(lsum, l, gred, AddOp());           // head gs = lane's bit 0
    push_all(xsum, NV, sg * G, &got_sum, rank, l, vt);
    oh_tma::mbar_wait_cluster(&got_sum, ph);
    if (!last && threadIdx.x == 0) oh_tma::mbar_expect_tx(&got_sum, TX);
    rank_order(xsum, NV, sg * G, 0.f, AddOp(), l);
    float ls[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) ls[j] = pick(l, j * G + gs);
    float pscale[NVG];
#pragma unroll
    for (int i = 0; i < NVG; ++i) pscale[i] = 1.f;
    if constexpr (QUANT) {
      float pmax[QG];
#pragma unroll
      for (int j = 0; j < QG; ++j) pmax[j] = 0.f;
      for (int i = vt; i < cnt * G; i += THREADS)
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          float* p_at = sc + (sg + j) * SCW + i;
          const float pv = (*p_at / ls[j]) * vss[i];
          *p_at = pv;
          pmax[j] = fmaxf(pmax[j], pv);
        }
      block_reduce_heads<QG, G, 1>(pmax, pscale, gred, MaxOp());
      push_all(xpv, NV, sg * G, &got_pv, rank, pscale, vt);
      oh_tma::mbar_wait_cluster(&got_pv, ph);
      if (!last && threadIdx.x == 0) oh_tma::mbar_expect_tx(&got_pv, TX);
      rank_order(xpv, NV, sg * G, 0.f, MaxOp(), pscale);
#pragma unroll
      for (int i = 0; i < NVG; ++i) pscale[i] = fmaxf(pscale[i], 1e-20f) / 127.0f;
      float ps[QG];
#pragma unroll
      for (int j = 0; j < QG; ++j) ps[j] = pick(pscale, j * G + gs);
      for (int i = vt; i < cnt * G; i += THREADS)
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          float* p_at = sc + (sg + j) * SCW + i;
          const float p8 = fminf(fmaxf(rintf(*p_at / ps[j]), -127.f), 127.f);
          *p_at = p8;
          p8b[((sg + j) * G + gs) * QB + i / G] = (int8_t)p8;
        }
      // A last quad's rows past the slice: level 0.
      for (int i = cnt * G + vt; i < SplitSmem::quads(cnt, true) * G; i += THREADS)
#pragma unroll
        for (int j = 0; j < QG; ++j) p8b[((sg + j) * G + gs) * QB + i / G] = 0;
    } else {
      for (int i = vt; i < cnt * G; i += THREADS)
#pragma unroll
        for (int j = 0; j < QG; ++j)
          sc[(sg + j) * SCW + i] = round_prob<KV>(sc[(sg + j) * SCW + i] / ls[j]);
    }
    if (blk == 0) cp_async_wait_all();   // group 0's V pieces have landed
    __syncthreads();                // (every thread's, for the quads and the groups)
    if (probs)                      // the value sum's probs, for checks
      for (int j = 0; j < QG; ++j) {
        const int s = sg + j;
        if (s >= nq) break;
        float* pb = probs + (((long long)b * S + s0 + s) * H + h0) * T;   // head g at g * T
        for (int i = vt; i < cnt * G; i += THREADS)
          pb[(long long)(i % G) * T + t0 + i / G] = sc[s * SCW + i];
        if (rank == CLUSTER - 1)
          for (int i = vt; i < (T - n) * G; i += THREADS)
            pb[(long long)(i % G) * T + n + i / G] = 0.f;
      }

    // -- values of the slice. QUANT (int32, exact): thread (quad qo, word
    //    w) takes column word w of the quads of rows qo, qo + QPP, ...,
    //    each transposed to a word a column (a byte a row), and sums dp4a
    //    of them with each query's levels of those four rows; the quads'
    //    sums add in order. Else (fp32, the per-query kernel's order) each
    //    thread sums its 16 B of columns over its rows for each query, then
    //    over the warp's rows and the group's warps ------------------------
    constexpr int NP = QUANT ? 4 * THREADS / GD : WARPS;   // partial sums a column
    if constexpr (QUANT) {
      constexpr int WPR = GD / 4;              // words of a row of the heads
      const int w = vt % WPR, qo = vt / WPR;
      const int* vw = reinterpret_cast<const int*>(vrows);
      const int* pw = reinterpret_cast<const int*>(p8b) + (w / (HEAD_DIM / 4)) * (QB / 4);
      int acc[QG][4];
#pragma unroll
      for (int j = 0; j < QG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
      for (int m4 = qo; m4 < (cnt + 3) / 4; m4 += NP) {
        int col[4];
        transpose4(vw[(4 * m4) * WPR + w], vw[(4 * m4 + 1) * WPR + w],
                   vw[(4 * m4 + 2) * WPR + w], vw[(4 * m4 + 3) * WPR + w], col);
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          const int p4 = pw[(sg + j) * G * (QB / 4) + m4];   // this head's levels of the quad
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = __dp4a(col[i], p4, acc[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < QG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[((sg + j) * NP + qo) * GD + 4 * w + i] = acc[j][i];
    } else {
      Acc acc[QG][L::VALS];
#pragma unroll
      for (int j = 0; j < QG; ++j)
#pragma unroll
        for (int i = 0; i < L::VALS; ++i) acc[j][i] = 0;
      for (int r = r0; r < cnt; r += RPP) {
        const int4 ch = vrows[r * RC + c];
#pragma unroll
        for (int j = 0; j < QG; ++j) {
          const float p = sc[(sg + j) * SCW + r * G + g];
#pragma unroll
          for (int i = 0; i < L::VALS; ++i) acc[j][i] = fmaf(p, elem<KV>(ch, i), acc[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < QG; ++j) {
#pragma unroll
        for (int off = RC; off < 32; off <<= 1)
#pragma unroll
          for (int i = 0; i < L::VALS; ++i)
            acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], off);
        if (lane < RC)              // lane c holds chunk c's warp sum
#pragma unroll
          for (int i = 0; i < L::VALS; ++i)
            part[((sg + j) * WARPS + warp) * GD + c * L::VALS + i] = acc[j][i];
      }
    }
    __syncthreads();
    // This rank's sums of the group's queries, written to rank 0 (into
    // buffer ph when walking: a rank writes block blk + 2's only after the
    // cluster barrier of block blk + 1, at which rank 0 arrives once it has
    // read block blk's).
    Acc* pbuf = partials + (size_t)(walk ? ph : 0) * CLUSTER * SQ * GD;
    for (int i = vt; i < QG * GD; i += THREADS) {
      const int s = sg + i / GD, col = i % GD;
      if (s >= nq) break;
      Acc total = 0;
#pragma unroll
      for (int w = 0; w < NP; ++w) total += part[(s * NP + w) * GD + col];
      *cluster.map_shared_rank(pbuf + ((size_t)rank * SQ + s) * GD + col, 0) = total;
    }
    // The cluster barrier: each rank's arrival releases its sums to rank 0,
    // which waits for all of them. After the last block the other ranks
    // exit without waiting: each has received every value sent to it, and
    // no rank touches their shared memory after this.
    cluster_arrive();
    if (rank != 0) {
      if (last) return;
      cluster_wait();
      continue;
    }
    cluster_wait();
    for (int i = vt; i < QG * GD; i += THREADS) {
      const int s = sg + i / GD, col = i % GD;
      if (s >= nq) break;
      Acc total = 0;                // int32 exact; fp32 in rank order
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) total += pbuf[((size_t)r * SQ + s) * GD + col];
      store_f32(out + ((long long)b * S + s0 + s) * HD + h0 * HEAD_DIM + col,
                QUANT ? (float)total * pick(pscale, (i / GD) * G + col / HEAD_DIM)
                      : (float)total);
    }
  }
}

// The current card's SM count (read once a device).
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

// K5's dynamic shared memory: a slice's rows of G heads, the value sums,
// scores and scales of a block of queries (multi: min(S, S_MAX) queries, a
// second slice and sums buffer when S > S_MAX, packed levels for QUANT;
// else one query).
template <typename KV, bool QUANT>
size_t smem_split(int T, int G, int S, bool multi) {
  return (size_t)SplitSmem((T + CLUSTER - 1) / CLUSTER, HEAD_DIM * (int)sizeof(KV), G,
                           multi ? (S < S_MAX ? S : S_MAX) : 1, multi && S > S_MAX,
                           QUANT && multi).total;
}

// The per-query kernel: one cluster per (G heads, query, row).
template <typename KV, typename QO, bool QUANT, int G>
int launch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* lengths, int len_default, int causal, void* out, void* probs,
                 int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  const auto kernel = decode_attention_split_kernel<KV, QO, QUANT, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM_SPLIT);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(CLUSTER, H / G, S * B);
  kernel<<<grid, THREADS, smem_split<KV, QUANT>(T, G, S, false), st>>>(
      (const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, len_default, causal, (QO*)out, (float*)probs, S, H, T, sm_scale);
  return (int)cudaGetLastError();
}

// The multi-query kernel: one cluster per (G heads, row), blocks of SQ
// queries, QG of them a group of THREADS threads.
template <typename KV, typename QO, bool QUANT, int G, int SQ, int QG>
int launch_multi(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* lengths, int len_default, void* out, void* probs, int B, int S,
                 int H, int T, float sm_scale, cudaStream_t st) {
  const auto kernel = decode_attention_multi_kernel<KV, QO, QUANT, G, SQ, QG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM_SPLIT);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(CLUSTER, H / G, B);
  kernel<<<grid, THREADS * (SQ / QG), smem_split<KV, QUANT>(T, G, S, true), st>>>(
      (const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, len_default, (QO*)out, (float*)probs, S, H, T, sm_scale);
  return (int)cudaGetLastError();
}

template <typename KV, typename QO, bool QUANT, bool BEAM>
int launch_direct(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                  const void* lengths, int len_default, int causal, const void* rows, void* out,
                  void* probs, int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  const auto kernel = decode_attention_kernel<KV, QO, QUANT, BEAM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int ring = ring_passes<KV, QUANT>(T, BEAM);
  if (ring < STAGES) return (int)cudaErrorInvalidValue;
  dim3 grid(H, S, B);
  kernel<<<grid, THREADS, (size_t)ring * PASS_BYTES + direct_tail<QUANT>(T, BEAM), st>>>(
      (const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, len_default, causal, (const int8_t*)rows, (QO*)out, (float*)probs, S,
      H, T, sm_scale, ring);
  return (int)cudaGetLastError();
}

// K5 with SQ queries a cluster (SQ = 1: a cluster per query; SQ >= 2: the
// multi-query mode): int8 K/V take two adjacent heads to a cluster when H
// is even (see the header), others one head.
template <typename KV, typename QO, bool QUANT, int SQ>
int launch_heads(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* lengths, int len_default, int causal, void* out, void* probs,
                 int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  constexpr bool MULTI = SQ > 1;
  if (smem_split<KV, QUANT>(T, 1, S, MULTI) > MAX_SMEM_SPLIT) return (int)cudaErrorInvalidValue;
  const bool pairs = sizeof(KV) == 1 && H % 2 == 0 &&
                     smem_split<KV, QUANT>(T, 2, S, MULTI) <= MAX_SMEM_SPLIT;
  if constexpr (MULTI) {
    // int8 with scales on a grid that leaves SMs idle (a CTA each at most):
    // a group of THREADS threads a query; else one group for the block.
    const bool spread = QUANT && (long long)B * (H / (pairs ? 2 : 1)) * CLUSTER <= sm_count();
#define OH_MULTI(G_, QG_) launch_multi<KV, QO, QUANT, G_, SQ, QG_>(q, k, v, ks, vs, lengths, \
                              len_default, out, probs, B, S, H, T, sm_scale, st)
    if constexpr (QUANT) {
      if (pairs) return spread ? OH_MULTI(2, 1) : OH_MULTI(2, SQ);
      return spread ? OH_MULTI(1, 1) : OH_MULTI(1, SQ);
    } else if constexpr (sizeof(KV) > 1) {
      return OH_MULTI(1, SQ);
    } else {                        // int8 as plain numbers: one query a row only
      return (int)cudaErrorInvalidValue;
    }
#undef OH_MULTI
  } else {
    if constexpr (sizeof(KV) == 1)
      if (pairs)
        return launch_split<KV, QO, QUANT, 2>(q, k, v, ks, vs, lengths, len_default, causal,
                                              out, probs, B, S, H, T, sm_scale, st);
    return launch_split<KV, QO, QUANT, 1>(q, k, v, ks, vs, lengths, len_default, causal, out,
                                          probs, B, S, H, T, sm_scale, st);
  }
}

// MODE 0: K4 (the direct path); 1: K5, a cluster per query; 2: K5's
// multi-query mode, a cluster per row for its S queries (no causal
// offset), compiled for each block size SQ = min(S, S_MAX) so that no
// query of a block is guarded (S = 1: the cluster per query).
template <typename KV, typename QO, bool QUANT, int MODE>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, int len_default, int causal,
           const void* rows, void* out, void* probs, int B, int S, int H, int T,
           float sm_scale, cudaStream_t st) {
  if (B <= 0 || S <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 ||
      (MODE == 1 ? (long long)S * B > 65535 : S > 65535))
    return (int)cudaErrorInvalidValue;
  if constexpr (MODE > 0) {
    if (rows || (MODE == 2 && causal)) return (int)cudaErrorInvalidValue;   // the beam mode is K4's
#define OH_K5(SQ) launch_heads<KV, QO, QUANT, SQ>(q, k, v, ks, vs, lengths, len_default, causal, \
                                                 out, probs, B, S, H, T, sm_scale, st)
    if (MODE == 2) switch (S < S_MAX ? S : S_MAX) {
        case 2: return OH_K5(2);
        case 3: return OH_K5(3);
        case 4: return OH_K5(4);
        case 5: return OH_K5(5);
        case S_MAX: return OH_K5(S_MAX);
        default: break;             // S = 1
      }
    return OH_K5(1);
#undef OH_K5
  } else {
    if (!rows)
      return launch_direct<KV, QO, QUANT, false>(q, k, v, ks, vs, lengths, len_default, causal,
                                                 nullptr, out, probs, B, S, H, T, sm_scale, st);
    // The beam mode: every group's lengths, no causal offset, T bytes of
    // table a query; int8 taken as plain numbers has none.
    if constexpr (QUANT || sizeof(KV) > 1)
      if (lengths && !causal && T <= TAB_LOADS * THREADS)
        return launch_direct<KV, QO, QUANT, true>(q, k, v, ks, vs, lengths, len_default, causal,
                                                  rows, out, probs, B, S, H, T, sm_scale, st);
    return (int)cudaErrorInvalidValue;
  }
}

template <typename QO, int MODE>
int dispatch_kv(int kv_kind, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* lengths,
                int len_default, int causal, const void* rows, void* out, void* probs,
                int B, int S, int H, int T, float sm_scale, cudaStream_t st) {
  switch (kv_kind) {
    case 0: return launch<int8_t, QO, true, MODE>(q, k, v, ks, vs, lengths, len_default, causal,
                                                  rows, out, probs, B, S, H, T, sm_scale, st);
    case 1: return launch<int8_t, QO, false, MODE>(q, k, v, ks, vs, lengths, len_default, causal,
                                                   rows, out, probs, B, S, H, T, sm_scale, st);
    case 2: return launch<__nv_bfloat16, QO, false, MODE>(q, k, v, ks, vs, lengths, len_default,
                                                          causal, rows, out, probs, B, S, H, T,
                                                          sm_scale, st);
    case 3: return launch<float, QO, false, MODE>(q, k, v, ks, vs, lengths, len_default, causal,
                                                  rows, out, probs, B, S, H, T, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QO>
int dispatch_mode(int mode, int kv_kind, const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* lengths, int len_default,
                  int causal, const void* rows, void* out, void* probs, int B, int S, int H,
                  int T, float sm_scale, cudaStream_t st) {
  switch (mode) {
    case 0: return dispatch_kv<QO, 0>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                      rows, out, probs, B, S, H, T, sm_scale, st);
    case 1: return dispatch_kv<QO, 1>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                      rows, out, probs, B, S, H, T, sm_scale, st);
    case 2: return dispatch_kv<QO, 2>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                      rows, out, probs, B, S, H, T, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, S, H*64] contiguous, fp32 (qo_kind 0) or bf16 (1).
// k, v: [B, T, H*64] contiguous: int8 with fp32 scales ks, vs [B, T, H]
// (kv_kind 0), int8 taken as plain numbers (1), bf16 (2) or fp32 (3).
// lengths: int32 [B] or null (then every row has len_default).
// Query s of row b sees keys t < lengths[b] + (causal ? s : 0), at most T.
// rows: null, or the beam mode (K4 only): int8 [B, S, T]. Then row b is a
// group of S beams over k, v [B, S*T, H*64] (ks, vs [B, S*T, H]), lengths
// are required and causal is 0, T <= 512, and key t < lengths[b] of query
// s is position t of the group's cache row r = rows[b, s, t] (flat key
// r*T + t), none where r = -1.
// probs: null, or fp32 [B, S, H, T] that takes the probs of the value sum
// (int8 levels in the int8 mode; 0 past each query's keys), for checks.
// pipelined: 0 = direct loads (K4); 1 = the cluster split over T (K5), a
// cluster per query; 2 = K5's multi-query mode, a cluster per row for all
// its S queries (causal must be 0, kv_kind 0, 2 or 3; the same bits, query
// by query, as 1).
extern "C" int oh_decode_attention(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* lengths, int len_default,
                                   int causal, const void* rows, void* out, void* probs,
                                   int B, int S, int H, int T, float sm_scale, int kv_kind,
                                   int qo_kind, int pipelined, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (qo_kind == 0)
    return dispatch_mode<float>(pipelined, kv_kind, q, k, v, ks, vs, lengths, len_default,
                                causal, rows, out, probs, B, S, H, T, sm_scale, st);
  if (qo_kind == 1)
    return dispatch_mode<__nv_bfloat16>(pipelined, kv_kind, q, k, v, ks, vs, lengths,
                                        len_default, causal, rows, out, probs, B, S, H, T,
                                        sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
