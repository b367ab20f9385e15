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
// --use_fast_math (ops/_build.py).
//
// Bound on an H100: the dependent chain. A 30 s window is 480,000 steps of
// one lane; each step waits on the last (a multiply, an add and a select:
// about 12 cycles of latency), so one lane takes about 2.9 ms at 1.98 GHz,
// while its bytes (read once, written once: 3.84 MB) take 1.15 us at
// 3.35 TB/s. The design keeps the chain waiting on arithmetic
// only: one CTA per signal; the chain's lanes (one per signal for the
// envelope and the limiter, one per band for the floor) are threads of warp
// 0, and warps 1-3 stream the signal through three shared-memory tiles in
// coalesced loads and stores: while the chain walks tile i, they load tile
// i+1 and store tile i-1. A lane reads its steps 16 at a time into
// registers before it walks them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;      // warp 0: the chain; warps 1-3: the stream
constexpr int TILE = 2048;        // floats in one shared-memory tile
constexpr int UNROLL = 16;        // steps a lane reads ahead into registers

// Both of the envelope's branches are computed and one is selected: the
// same operations on the same values as selecting the coefficient first,
// but the compare no longer heads the chain (multiply, add, select).
struct Envelope {
  float attack, release;
  __device__ float step(float env, float a) const {
    const float up = __fadd_rn(__fmul_rn(attack, env),
                               __fmul_rn(__fsub_rn(1.0f, attack), a));
    const float down = __fadd_rn(__fmul_rn(release, env),
                                 __fmul_rn(__fsub_rn(1.0f, release), a));
    return a > env ? up : down;
  }
};

struct LimiterGain {
  float rc;
  __device__ float step(float g, float tg) const {
    const float r = __fadd_rn(__fmul_rn(rc, g),
                              __fmul_rn(__fsub_rn(1.0f, rc), tg));
    return tg < g ? tg : r;
  }
};

struct NoiseFloor {
  __device__ float step(float floor, float le) const {
    const float rate = le < floor ? 0.3f : 0.003f;
    return __fadd_rn(floor, __fmul_rn(rate, __fsub_rn(le, floor)));
  }
};

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
int launch(const float* x, float* y, long long n_steps, int n_sig, int lanes,
           const float* init, float init_value, Step op, void* stream) {
  if (n_sig < 0 || n_steps < 0 || lanes < 1 || lanes > 32)
    return (int)cudaErrorInvalidValue;
  if (n_sig == 0 || n_steps == 0) return (int)cudaSuccess;
  chain_kernel<Step><<<n_sig, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, n_steps, lanes, init, init_value, op);
  return (int)cudaGetLastError();
}

}  // namespace

// a: |x| [n_sig, n] fp32, env: [n_sig, n] fp32, both contiguous.
extern "C" int oh_envelope(const float* a, float* env, long long n, int n_sig,
                           float attack, float release, void* stream) {
  return launch(a, env, n, n_sig, 1, nullptr, 0.0f,
                Envelope{attack, release}, stream);
}

// tg: target gains [n_sig, n] fp32, g: [n_sig, n] fp32, both contiguous.
extern "C" int oh_limiter_gain(const float* tg, float* g, long long n,
                               int n_sig, float rc, void* stream) {
  return launch(tg, g, n, n_sig, 1, nullptr, 1.0f, LimiterGain{rc}, stream);
}

// le: log band energies [n_sig, n_frames, n_bands] fp32, floor0: [n_sig,
// n_bands] fp32, floor: [n_sig, n_frames, n_bands] fp32 (the floor after
// each frame), all contiguous; n_bands at most 32.
extern "C" int oh_noise_floor(const float* le, const float* floor0,
                              float* floor, int n_frames, int n_sig,
                              int n_bands, void* stream) {
  return launch(le, floor, (long long)n_frames, n_sig, n_bands, floor0, 0.0f,
                NoiseFloor{}, stream);
}
