// Single-query decode attention over the flat [B, T, H*64] caches of the
// decode step, with two load paths that give bit-identical results.
//
// Replaces two TPU kernels:
//   openhush_tpu/ops/decode_attention.py:decode_cross_attend (body _kernel),
//     the direct load path (PIPE = false);
//   openhush_tpu/ops/decode_attention_dma.py:decode_cross_attend_dma (body
//     _kernel), whose hand double-buffered HBM->VMEM copies become a 2-stage
//     cp.async ring of T-tiles in shared memory (PIPE = true).
// The role it fills on the decode step is the one XLA einsums fill in the
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
// and does ~2 operations per byte. Design: one CTA of 128 threads per
// (head, query, row); head dim 64, so a head's row is 64 B (int8) or 128 B
// (bf16) at a stride of H*64 elements. Each thread loads 16 B, neighbouring
// threads take the neighbouring 16 B of a row and then the next rows, so a
// warp reads whole 32-byte sectors. Scores stay in shared memory (T <= ~10k
// fp32), then one pass softmaxes them and a second pass over V sums the
// output with each thread owning 16 B of columns. The joint prob scale needs
// the whole row's softmax before any value term, so T is not split across
// CTAs (a split-T design would have to carry max_t(exp(s-m)*vs) per split).
// The cp.async path stages TILE_ROWS rows per stage; every thread copies
// exactly the 16-byte pieces it later computes on, so the ring needs no
// barrier, and shared reads and writes are consecutive 16-byte words (no
// bank conflicts). Both paths compute every row and every partial sum in
// the same order, so their outputs are equal bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HEAD_DIM = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 64;                 // rows per cp.async stage
constexpr int UNROLL = 4;                     // direct path: loads in flight
constexpr size_t MAX_SMEM = 48 * 1024;

template <typename T> struct Layout {
  static constexpr int VALS = 16 / (int)sizeof(T);     // values per 16 B
  static constexpr int CHUNKS = HEAD_DIM / VALS;       // threads per row
  static constexpr int RPP = THREADS / CHUNKS;         // rows per pass
  static_assert(TILE_ROWS % RPP == 0, "tile must hold whole passes");
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
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v += red[w];
  __syncthreads();
  return v;
}

// Streams rows [0, n) of one head's K or V: fn(t, chunk) is called for the
// 16-byte piece (row t, column chunk c) that this thread owns, rows in
// ascending order, from global memory (direct) or through the cp.async ring.
template <typename T, bool PIPE, typename Fn>
__device__ __forceinline__ void stream_rows(const T* base, long long row_stride,
                                            int n, int4* ring, Fn&& fn) {
  using L = Layout<T>;
  const int c = threadIdx.x % L::CHUNKS;
  const int r0 = threadIdx.x / L::CHUNKS;
  if constexpr (!PIPE) {
    for (int tb = 0; tb < n; tb += L::RPP * UNROLL) {
      int4 ch[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = tb + u * L::RPP + r0;
        ch[u] = t < n ? __ldg(reinterpret_cast<const int4*>(
                            base + t * row_stride + c * L::VALS))
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fn(tb + u * L::RPP + r0, ch[u]);
    }
  } else {
    constexpr int PER_THREAD = TILE_ROWS / L::RPP;      // pieces per stage
    const int n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
    auto issue = [&](int tile, int stage) {
      int4* dst = ring + stage * (TILE_ROWS * L::CHUNKS);
#pragma unroll
      for (int m = 0; m < PER_THREAD; ++m) {
        const int row = m * L::RPP + r0;                // row within the tile
        const int t = tile * TILE_ROWS + row;
        if (t < n)
          cp_async16(dst + row * L::CHUNKS + c, base + t * row_stride + c * L::VALS);
      }
      cp_async_commit();
    };
    issue(0, 0);
    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) issue(j + 1, (j + 1) & 1);
      else cp_async_commit();                           // keep the group count
      cp_async_wait_prev();
      const int4* src = ring + (j & 1) * (TILE_ROWS * L::CHUNKS);
#pragma unroll
      for (int m = 0; m < PER_THREAD; ++m) {
        const int row = m * L::RPP + r0;
        const int t = j * TILE_ROWS + row;
        // Every lane calls fn (it may shuffle); rows past n carry zeros.
        fn(t, t < n ? src[row * L::CHUNKS + c] : make_int4(0, 0, 0, 0));
      }
    }
  }
}

template <typename KV, typename QO, bool QUANT, bool PIPE>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const QO* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        int len_default, int causal, QO* __restrict__ out,
                        float* __restrict__ probs, int S, int H, int T,
                        float sm_scale) {
  using L = Layout<KV>;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);                    // PIPE only
  const size_t ring_bytes = PIPE ? 2 * TILE_ROWS * HEAD_DIM * sizeof(KV) : 0;
  float* part = reinterpret_cast<float*>(smem + ring_bytes);     // [RPP][64]
  float* sc = part + L::RPP * HEAD_DIM;                          // [T]
  __shared__ float qs[HEAD_DIM];
  __shared__ int q8w[HEAD_DIM / 4];
  __shared__ float red[WARPS];
  __shared__ float qscale_s;

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
  const int lane = threadIdx.x & 31;
  const int c = threadIdx.x % L::CHUNKS;

  // -- query (quantized per (row, query, head) in QUANT mode) --------------
  if (threadIdx.x < HEAD_DIM) qs[threadIdx.x] = load_f32(q + qo_off + threadIdx.x);
  __syncthreads();
  if constexpr (QUANT) if (threadIdx.x < 32) {
    float m = fmaxf(fabsf(qs[lane]), fabsf(qs[lane + 32]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float qscale = fmaxf(m, 1e-10f) / 127.0f;
    if (lane == 0) qscale_s = qscale;
    if (lane < HEAD_DIM / 4) {
      int w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = fminf(fmaxf(rintf(qs[4 * lane + j] / qscale), -127.f), 127.f);
        w |= ((int)r & 0xff) << (8 * j);
      }
      q8w[lane] = w;
    }
  }
  __syncthreads();
  const float qscale = QUANT ? qscale_s : 1.f;

  // -- scores: one 16-byte piece per thread, summed over the row's lanes ----
  float lmax = -FLT_MAX;
  stream_rows<KV, PIPE>(kb, HD, n, ring, [&](int t, const int4& ch) {
    float score;
    if constexpr (QUANT) {
      int acc = 0;
      acc = __dp4a(ch.x, q8w[4 * c + 0], acc);
      acc = __dp4a(ch.y, q8w[4 * c + 1], acc);
      acc = __dp4a(ch.z, q8w[4 * c + 2], acc);
      acc = __dp4a(ch.w, q8w[4 * c + 3], acc);
#pragma unroll
      for (int off = L::CHUNKS / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      score = t < n ? (float)acc * ksb[(long long)t * H] : 0.f;
      score = score * qscale;
      score = score * sm_scale;
    } else {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < L::VALS; ++j) acc = fmaf(elem<KV>(ch, j), qs[c * L::VALS + j], acc);
#pragma unroll
      for (int off = L::CHUNKS / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      score = acc * sm_scale;
    }
    if (c == 0 && t < n) {
      sc[t] = score;
      lmax = fmaxf(lmax, score);
    }
  });
  __syncthreads();
  const float m = block_max(lmax, red);

  // -- softmax (fp32), then the probs the value sum takes --------------------
  float lsum = 0.f;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    lsum += e;
  }
  const float l = block_sum(lsum, red);
  float pscale = 1.f;
  if constexpr (QUANT) {
    float pmax = 0.f;
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const float pv = (sc[t] / l) * vsb[(long long)t * H];
      sc[t] = pv;
      pmax = fmaxf(pmax, pv);
    }
    pscale = fmaxf(block_max(pmax, red), 1e-20f) / 127.0f;
    for (int t = threadIdx.x; t < n; t += THREADS)
      sc[t] = fminf(fmaxf(rintf(sc[t] / pscale), -127.f), 127.f);
  } else {
    for (int t = threadIdx.x; t < n; t += THREADS) sc[t] = round_prob<KV>(sc[t] / l);
  }
  __syncthreads();
  if (pb)                           // the value sum's probs, for checks
    for (int t = threadIdx.x; t < T; t += THREADS) pb[t] = t < n ? sc[t] : 0.f;

  // -- values: each thread sums its 16 B of columns over its rows -----------
  if constexpr (QUANT) {
    int acc[L::VALS];
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) acc[j] = 0;
    stream_rows<KV, PIPE>(vb, HD, n, ring, [&](int t, const int4& ch) {
      if (t < n) {
        const int p8 = (int)sc[t];
#pragma unroll
        for (int j = 0; j < L::VALS; ++j) acc[j] += p8 * int8_at(ch, j);
      }
    });
#pragma unroll
    for (int j = 0; j < L::VALS; ++j)
      reinterpret_cast<int*>(part)[(threadIdx.x / L::CHUNKS) * HEAD_DIM + c * L::VALS + j] = acc[j];
  } else {
    float acc[L::VALS];
#pragma unroll
    for (int j = 0; j < L::VALS; ++j) acc[j] = 0.f;
    stream_rows<KV, PIPE>(vb, HD, n, ring, [&](int t, const int4& ch) {
      if (t < n) {
        const float p = sc[t];
#pragma unroll
        for (int j = 0; j < L::VALS; ++j) acc[j] = fmaf(p, elem<KV>(ch, j), acc[j]);
      }
    });
#pragma unroll
    for (int j = 0; j < L::VALS; ++j)
      part[(threadIdx.x / L::CHUNKS) * HEAD_DIM + c * L::VALS + j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < HEAD_DIM) {
    float o;
    if constexpr (QUANT) {
      int total = 0;
      for (int r = 0; r < L::RPP; ++r) total += reinterpret_cast<int*>(part)[r * HEAD_DIM + threadIdx.x];
      o = (float)total * pscale;
    } else {
      o = 0.f;
      for (int r = 0; r < L::RPP; ++r) o += part[r * HEAD_DIM + threadIdx.x];
    }
    store_f32(out + qo_off + threadIdx.x, o);
  }
}

template <typename KV, typename QO, bool QUANT, bool PIPE>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, int len_default, int causal,
           void* out, void* probs, int B, int S, int H, int T, float sm_scale,
           cudaStream_t st) {
  using L = Layout<KV>;
  const size_t smem = (PIPE ? 2 * TILE_ROWS * HEAD_DIM * sizeof(KV) : 0) +
                      L::RPP * HEAD_DIM * sizeof(float) + (size_t)T * sizeof(float);
  if (smem > MAX_SMEM || B <= 0 || S <= 0 || H <= 0 || T <= 0 || S > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, S, B);
  decode_attention_kernel<KV, QO, QUANT, PIPE><<<grid, THREADS, smem, st>>>(
      (const QO*)q, (const KV*)k, (const KV*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, len_default, causal, (QO*)out, (float*)probs, S, H, T,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename QO, bool PIPE>
int dispatch_kv(int kv_kind, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* lengths,
                int len_default, int causal, void* out, void* probs, int B,
                int S, int H, int T, float sm_scale, cudaStream_t st) {
  switch (kv_kind) {
    case 0: return launch<int8_t, QO, true, PIPE>(q, k, v, ks, vs, lengths, len_default,
                                                  causal, out, probs, B, S, H, T, sm_scale, st);
    case 1: return launch<int8_t, QO, false, PIPE>(q, k, v, ks, vs, lengths, len_default,
                                                   causal, out, probs, B, S, H, T, sm_scale, st);
    case 2: return launch<__nv_bfloat16, QO, false, PIPE>(q, k, v, ks, vs, lengths, len_default,
                                                          causal, out, probs, B, S, H, T, sm_scale, st);
    case 3: return launch<float, QO, false, PIPE>(q, k, v, ks, vs, lengths, len_default,
                                                  causal, out, probs, B, S, H, T, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, S, H*64] contiguous, fp32 (qo_kind 0) or bf16 (1).
// k, v: [B, T, H*64] contiguous: int8 with fp32 scales ks, vs [B, T, H]
// (kv_kind 0), int8 taken as plain numbers (1), bf16 (2) or fp32 (3).
// lengths: int32 [B] or null (then every row has len_default).
// Query s of row b sees keys t < lengths[b] + (causal ? s : 0), at most T.
// probs: null, or fp32 [B, S, H, T] that takes the probs of the value sum
// (int8 levels in the int8 mode; 0 past each query's keys), for checks.
// pipelined: 0 = direct loads (K4), 1 = cp.async ring (K5).
extern "C" int oh_decode_attention(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs,
                                   const void* lengths, int len_default,
                                   int causal, void* out, void* probs, int B,
                                   int S, int H, int T, float sm_scale, int kv_kind,
                                   int qo_kind, int pipelined, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (qo_kind == 0)
    return pipelined
        ? dispatch_kv<float, true>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                   out, probs, B, S, H, T, sm_scale, st)
        : dispatch_kv<float, false>(kv_kind, q, k, v, ks, vs, lengths, len_default, causal,
                                    out, probs, B, S, H, T, sm_scale, st);
  if (qo_kind == 1)
    return pipelined
        ? dispatch_kv<__nv_bfloat16, true>(kv_kind, q, k, v, ks, vs, lengths, len_default,
                                           causal, out, probs, B, S, H, T, sm_scale, st)
        : dispatch_kv<__nv_bfloat16, false>(kv_kind, q, k, v, ks, vs, lengths, len_default,
                                            causal, out, probs, B, S, H, T, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
