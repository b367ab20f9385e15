// Whisper log-mel frontend: framing -> hann-windowed real DFT -> power ->
// mel projection -> log10, one pass per tile of frames.
//
// Replaces the TPU kernel openhush_tpu/ops/frontend_pallas.py:log_mel_pallas
// (body _frontend_kernel). The global max-8 clamp, the (x+4)/4 scale and the
// transpose stay in PyTorch (ops/frontend.py), as they were an XLA epilogue.
//
// Bound on an H100: operations. One 30 s window is two [3000, 400] @ [400,
// 201] products (965 MFLOP) plus the mel projection, whose slaney filters
// are bands of 1-14 bins (394 nonzeros at 128 mels: 2.4 MFLOP), against
// about 4 MB of input and output; folded as below, the products are two
// [3000, 201] @ [201, 201] (485 MFLOP). They must be true fp32: the DFT's
// low bins cancel badly, so TF32 tensor cores are out and the rate to beat
// is the fp32 CUDA-core peak.
//
// Design: a register-tiled fp32 product on the CUDA cores, fused with the
// power and a banded mel projection.
// - A CTA owns F = 4 * TF consecutive frames (24, or 12 when the grid would
//   not fill the card) and all 201 bins, padded to 208, so the mel
//   projection stays in the CTA. Thread (fg, kg) of 4 x 52 keeps TF frames
//   x 4 bins of re and im in registers: each float4 of the bases read from
//   shared memory feeds 4 * TF FMAs, each float4 of samples 16. A warp's
//   threads share their frames, so its sample loads are broadcasts.
// - The frames are staged once, as the one span of audio they cover (the
//   centred frames' reflect padding is read in place), and folded on the
//   way: the windowed
//   bases satisfy C[400-n] = C[n] and S[400-n] = -S[n], so Re sums
//   x[n] + x[400-n] and Im x[n] - x[400-n] over n = 1..199, plus the n = 0
//   and n = 200 terms: 201 rows of the bases instead of 400, half the FMAs
//   and half the basis reads.
// - The bases ([400, cos 208 | sin 208], zero-padded bins) stream through
//   shared memory in chunks of 8 rows by cp.async, three chunks in flight;
//   no FMA waits on a global load.
// - The power goes to shared memory (over the basis stages), and mel m sums
//   MAX_BAND bins from the start of its band [lo_m, hi_m] (1-14 bins of
//   201) in ascending order, against its weights, zero past hi_m, staged in
//   shared memory beside the first chunk: the terms past the band add exact
//   zeros, so these are the bits of the band's sum and of the dense loop.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HALF = N_FFT / 2;               // 200
constexpr int HOP = 160;
constexpr int KPAD = 208;                     // 201 bins, padded
constexpr int KG = KPAD / 4;                  // bin groups of 4
constexpr int FG = 4;                         // frame groups
constexpr int THREADS = KG * FG;              // 208
constexpr int ROW = 2 * KPAD;                 // one basis row: cos | sin
constexpr int NK = 8;                         // basis rows a stage
constexpr int STAGE = NK * ROW;               // floats
constexpr int STAGES = 4;                     // three stages in flight
constexpr int PLD = KPAD + 4;                 // power row stride
constexpr int MAX_BAND = 16;                  // bins a mel filter may span
constexpr int FPI = 4;                        // frames a mel item sums

// Rows of the bases read (201, padded to a multiple of NK), and the stride
// of a staged frame's row: 212 = 20 mod 32, so where a warp straddles two
// frame groups (TF rows apart, TF = 3 or 6) their rows start on other banks
// (0 and 28, or 0 and 24).
constexpr int ROWS = 208;
constexpr int LDX = 212;

// Bases, the frames' x+ and x- rows, then the mel weights [n_mels][MAX_BAND].
template <int TF>
__host__ __device__ constexpr int frames_offset() {
  return STAGES * STAGE + 2 * FG * TF * LDX;
}
template <int TF>
int smem_bytes(int n_mels) {
  return 4 * (frames_offset<TF>() + n_mels * MAX_BAND);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [c * NK, (c + 1) * NK) of the bases into one stage.
__device__ __forceinline__ void stage_rows(float* dst, const float* basis,
                                           int c, int tid) {
  const float* src = basis + (long long)c * STAGE;
#pragma unroll
  for (int i = tid * 4; i < STAGE; i += THREADS * 4)
    cp_async16(dst + i, src + i);
}

// Sample i of the centred frames' signal: the audio x[0..n) reflected by
// N_FFT/2 at both ends (torch's reflect pad), zeros past the padding.
__device__ __forceinline__ float sample(const float* x, long long n,
                                        long long i) {
  long long j = i - HALF;
  if (j < 0) j = -j;
  else if (j >= n) j = 2 * (n - 1) - j;
  return i < n + N_FFT ? x[j] : 0.f;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int TF>
__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ audio, long long n_samples,
               const float* __restrict__ basis,   // [400, ROW]
               const float* __restrict__ weights, // [n_mels, MAX_BAND]
               const int* __restrict__ first,     // [n_mels]: lo_m
               float* __restrict__ out,           // [B, n_frames, n_mels]
               int n_frames, int n_mels) {
  constexpr int F = FG * TF;
  constexpr int CHUNKS = ROWS / NK;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                           // STAGES stages of the bases
  float* xa = smem + STAGES * STAGE;          // the frames' x+ rows
  float* xb = xa + F * LDX;                   // their x- rows
  float* ws = smem + frames_offset<TF>();     // weights [n_mels][MAX_BAND]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * F;
  const float* a = audio + (long long)b * n_samples;

  // The mel weights ride with the first chunk of the bases; the first
  // STAGES - 1 chunks are in flight while the frames are staged.
  for (int i = tid * 4; i < n_mels * MAX_BAND; i += THREADS * 4)
    cp_async16(ws + i, weights + i);
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    stage_rows(bs + c * STAGE, basis, c, tid);
    cp_async_commit();
  }

  // The frames are one span of the centred signal, SPAN samples from
  // f0 * HOP on: staged raw into the x- rows' space (float4 loads where no
  // reflection or end falls in it), then folded by thread n = tid into row
  // n of every frame: x[n] + x[400-n] and x[n] - x[400-n] for n < 200, the
  // lone sample for n = 0 and 200, zeros past 200.
  static_assert(THREADS == ROWS, "one thread a folded row");
  constexpr int SPAN = (F - 1) * HOP + N_FFT;
  static_assert(SPAN <= F * LDX && SPAN % 4 == 0, "the raw span fits");
  float* raw = xb;
  const long long p0 = (long long)f0 * HOP;
  const float* src = a + (p0 - HALF);
  if (p0 >= HALF && p0 - HALF + SPAN <= n_samples &&
      (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int i = tid; i < SPAN / 4; i += THREADS)
      reinterpret_cast<float4*>(raw)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = tid; i < SPAN; i += THREADS)
      raw[i] = sample(a, n_samples, p0 + i);
  }
  __syncthreads();
  float plus[F], minus[F];
  {
    const int n = tid;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float lo = n <= HALF ? raw[f * HOP + n] : 0.f;
      const float hi = n > 0 && n < HALF ? raw[f * HOP + N_FFT - n] : 0.f;
      plus[f] = lo + hi;
      minus[f] = lo - hi;
    }
    __syncthreads();                          // the raw span is read
#pragma unroll
    for (int f = 0; f < F; ++f) {
      xa[f * LDX + n] = plus[f];
      xb[f * LDX + n] = minus[f];
    }
  }

  // A warp's threads share a frame group (but where a warp straddles two),
  // so its sample loads are broadcasts and its basis loads 32 float4s.
  const int fg = tid / KG, kg = tid % KG;
  const float* xr = xa + fg * TF * LDX;
  const float* xi = xb + fg * TF * LDX;
  float re[TF][4], im[TF][4];
#pragma unroll
  for (int i = 0; i < TF; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.f;

  for (int c = 0; c < CHUNKS; ++c) {
    // Wait for chunk c; the chunks after it that were asked for may stay in
    // flight (a group with no copy would never count as pending).
    const int ahead = min(STAGES - 2, CHUNKS - 1 - c);
    if (ahead >= 2) cp_async_wait<2>();
    else if (ahead == 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                          // and every thread is past c-1
    if (c + STAGES - 1 < CHUNKS) {
      stage_rows(bs + ((c + STAGES - 1) % STAGES) * STAGE, basis,
                 c + STAGES - 1, tid);
      cp_async_commit();
    }
    const float* B = bs + (c % STAGES) * STAGE + kg * 4;
#pragma unroll
    for (int j4 = 0; j4 < NK; j4 += 4) {
      const int n = c * NK + j4;
      float4 xe[TF], xo[TF];
#pragma unroll
      for (int i = 0; i < TF; ++i) {
        xe[i] = *reinterpret_cast<const float4*>(xr + i * LDX + n);
        xo[i] = *reinterpret_cast<const float4*>(xi + i * LDX + n);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(B + (j4 + j) * ROW);
        const float4 sv =
            *reinterpret_cast<const float4*>(B + (j4 + j) * ROW + KPAD);
#pragma unroll
        for (int i = 0; i < TF; ++i) {
          const float e = lane(xe[i], j);
          const float o = lane(xo[i], j);
          re[i][0] = fmaf(e, cv.x, re[i][0]);
          re[i][1] = fmaf(e, cv.y, re[i][1]);
          re[i][2] = fmaf(e, cv.z, re[i][2]);
          re[i][3] = fmaf(e, cv.w, re[i][3]);
          im[i][0] = fmaf(o, sv.x, im[i][0]);
          im[i][1] = fmaf(o, sv.y, im[i][1]);
          im[i][2] = fmaf(o, sv.z, im[i][2]);
          im[i][3] = fmaf(o, sv.w, im[i][3]);
        }
      }
    }
  }
  __syncthreads();                            // the stages are free

  float* ps = bs;                             // power [F, PLD]
#pragma unroll
  for (int i = 0; i < TF; ++i) {
    float4 p;
    p.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
    p.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
    p.z = re[i][2] * re[i][2] + im[i][2] * im[i][2];
    p.w = re[i][3] * re[i][3] + im[i][3] * im[i][3];
    *reinterpret_cast<float4*>(ps + (fg * TF + i) * PLD + kg * 4) = p;
  }
  __syncthreads();

  // Mel m sums MAX_BAND bins from lo_m on, against its band's weights and
  // then zeros: every term past the band is an exact zero added (the power
  // is finite, and bins past 200 hold zeros), so these are the bits of the
  // band alone, and of the dense loop. An item is one mel over FPI frames,
  // its weights held in registers; neighbouring threads take neighbouring
  // mels, so the stores coalesce.
  for (int item = tid; item < n_mels * (F / FPI); item += THREADS) {
    const int m = item % n_mels, fq = item / n_mels;
    const int lo = __ldg(first + m);
    float w[MAX_BAND];
#pragma unroll
    for (int j = 0; j < MAX_BAND; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ws + m * MAX_BAND + j);
      w[j] = v.x, w[j + 1] = v.y, w[j + 2] = v.z, w[j + 3] = v.w;
    }
    float acc[FPI];
#pragma unroll
    for (int q = 0; q < FPI; ++q) acc[q] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_BAND; ++j) {
      const float* p = ps + fq * FPI * PLD + min(lo + j, KPAD - 1);
#pragma unroll
      for (int q = 0; q < FPI; ++q) acc[q] = fmaf(p[q * PLD], w[j], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < FPI; ++q) {
      const int f = f0 + fq * FPI + q;
      if (f < n_frames)
        out[((long long)b * n_frames + f) * n_mels + m] =
            log10f(fmaxf(acc[q], 1e-10f));
    }
  }
}

template <int TF>
int launch(const float* audio, long long n_samples, const float* basis,
           const float* weights, const int* first, float* out, int batch,
           int n_frames, int n_mels, cudaStream_t st) {
  auto kernel = log_mel_kernel<TF>;
  const int bytes = smem_bytes<TF>(n_mels);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  constexpr int F = FG * TF;
  dim3 grid((n_frames + F - 1) / F, batch);
  kernel<<<grid, THREADS, bytes, st>>>(audio, n_samples, basis, weights,
                                       first, out, n_frames, n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

// audio: [B, n_samples] fp32 (n_samples > N_FFT/2), framed as torch's
// centred STFT frames it: reflect-padded by N_FFT/2 at both ends, frame f
// starting at f * HOP of the padded signal; basis: [400, 416] fp32, row n =
// the windowed cos of bins 0..200, zeros to 208, then the windowed sin
// likewise; first: [n_mels] int32, lo_m, the first bin of mel filter m's
// band [lo_m, hi_m] (hi_m - lo_m < MAX_BAND = 16); weights: [n_mels, 16]
// fp32, filter m's values at bins lo_m..hi_m, then zeros; out: [B,
// n_frames, n_mels].
// Requires (n_frames - 1) * HOP <= n_samples.
extern "C" int oh_log_mel(const void* audio, long long n_samples,
                          const void* basis, const void* weights,
                          const void* first, void* out, int batch,
                          int n_frames, int n_mels, void* stream) {
  // 12 frames a CTA when that grid still fits one CTA an SM (a short
  // window, or a reduced audio_ctx), else 24: a 30 s window at B = 1 is
  // then 125 CTAs, one wave.
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool small = (long long)batch * ((n_frames + 11) / 12) <= sms;
  return (small ? launch<3> : launch<6>)(
      (const float*)audio, n_samples, (const float*)basis,
      (const float*)weights, (const int*)first, (float*)out, batch, n_frames,
      n_mels, (cudaStream_t)stream);
}
