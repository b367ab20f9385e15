// Whisper log-mel frontend: framing -> hann-windowed real DFT -> power ->
// mel projection -> log10, one pass per tile of frames.
//
// Replaces the TPU kernel openhush_tpu/ops/frontend_pallas.py:log_mel_pallas
// (body _frontend_kernel). The global max-8 clamp, the (x+4)/4 scale and the
// transpose stay in PyTorch (ops/frontend.py), as they were an XLA epilogue.
//
// Bound on an H100: operations. One 30 s window is about 1.1 GFLOP (two
// [3000,400]@[400,201] products plus [3000,201]@[201,n_mels]) against about
// 4 MB of input and output, and the products must be true fp32: the DFT's
// low bins cancel badly, so TF32 tensor cores are out and the rate to beat is
// the fp32 CUDA-core peak. Design: one CTA owns FRAMES consecutive frames.
// Their samples (one contiguous span of the reflect-padded audio, since
// frame i starts at i*HOP) are staged once in shared memory; each thread
// owns one frequency bin and keeps FRAMES real and imaginary sums in
// registers, so every basis value read from global memory (L2-resident,
// coalesced across threads) feeds 2*FRAMES FMAs. The power spectrum stays in
// shared memory for the mel projection, where each thread owns one mel bin.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQ = N_FFT / 2 + 1;         // 201
constexpr int FRAMES = 16;                    // frames per CTA
constexpr int THREADS = 256;                  // >= N_FREQ and >= n_mels
constexpr int SPAN = (FRAMES - 1) * HOP + N_FFT;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ padded, long long padded_len,
               const float* __restrict__ cos_b,   // [N_FFT, N_FREQ]
               const float* __restrict__ sin_b,   // [N_FFT, N_FREQ]
               const float* __restrict__ fb,      // [N_FREQ, n_mels]
               float* __restrict__ out,           // [B, n_frames, n_mels]
               int n_frames, int n_mels) {
  __shared__ float xs[SPAN];
  __shared__ float pw[FRAMES][N_FREQ];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const long long start = (long long)f0 * HOP;
  const float* a = padded + (long long)b * padded_len + start;
  const long long avail = padded_len - start;
  for (int i = threadIdx.x; i < SPAN; i += THREADS)
    xs[i] = i < avail ? a[i] : 0.f;
  __syncthreads();

  const int k = threadIdx.x;
  if (k < N_FREQ) {
    float re[FRAMES], im[FRAMES];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < N_FFT; ++n) {
      const float c = cos_b[n * N_FREQ + k];
      const float s = sin_b[n * N_FREQ + k];
#pragma unroll
      for (int f = 0; f < FRAMES; ++f) {
        const float x = xs[f * HOP + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) pw[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  const int m = threadIdx.x;
  if (m < n_mels) {
    float acc[FRAMES];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) acc[f] = 0.f;
    for (int j = 0; j < N_FREQ; ++j) {
      const float w = fb[j * n_mels + m];
#pragma unroll
      for (int f = 0; f < FRAMES; ++f) acc[f] = fmaf(pw[f][j], w, acc[f]);
    }
    float* o = out + ((long long)b * n_frames + f0) * n_mels + m;
#pragma unroll
    for (int f = 0; f < FRAMES; ++f)
      if (f0 + f < n_frames) o[(long long)f * n_mels] = log10f(fmaxf(acc[f], 1e-10f));
  }
}

}  // namespace

// padded: [B, padded_len] fp32, reflect-padded by N_FFT/2 on each side.
// Requires (n_frames - 1) * HOP + N_FFT <= padded_len and n_mels <= THREADS.
extern "C" int oh_log_mel(const void* padded, long long padded_len,
                          const void* cos_b, const void* sin_b, const void* fb,
                          void* out, int batch, int n_frames, int n_mels,
                          void* stream) {
  dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)padded, padded_len, (const float*)cos_b,
      (const float*)sin_b, (const float*)fb, (float*)out, n_frames, n_mels);
  return (int)cudaGetLastError();
}
