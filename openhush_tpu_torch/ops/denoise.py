"""Speech denoising: Bark-band spectral gains (RNNoise-style).

Counterpart of openhush_tpu/ops/denoise.py. The denoiser works at 16 kHz on
the Whisper frontend's hop-160/win-400 STFT grid, with two gain
estimators:

- `wiener_gains`: a weight-free adaptive gate. A per-band noise floor
  tracked by an asymmetric EMA (fast down, slow up), Wiener-rule gains. The
  floor's recurrence runs on a hand-written CUDA kernel (csrc/dsp.cu:
  oh_noise_floor) for CUDA tensors, and on its plain version here, a loop
  over frames in torch ops, for CPU tensors; the Wiener rule around it
  stays in PyTorch.
- `rnn_gains`: the RNNoise network shape (dense → GRU 24 → 48 → 96 →
  sigmoid 22) over Bark-band features, an eager loop over frames.

Gains are per Bark band (22 bands, 0-8 kHz), interpolated to FFT bins,
applied to the complex spectrum, and resynthesized by inverse-DFT matmuls
and overlap-add with exact COLA normalization. The overlap-add sums the
three stride-aligned frame families in order, not with a scatter-add (on
CUDA `index_add_` uses atomics, whose order changes from run to run). The
streaming state, `initialized` included, stays on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.ops import _build, dsp
from openhush_tpu_torch.ops import mel as mel_ops

N_BANDS = 22
N_FFT = mel_ops.N_FFT          # 400
HOP = mel_ops.HOP_LENGTH       # 160
N_FREQS = N_FFT // 2 + 1       # 201
SAMPLE_RATE = 16_000
GRU_SIZES = (24, 48, 96)       # rnn_gains' three GRUs; gru_h holds all three


# ---------------------------------------------------------------------------
# Bark bands + synthesis bases (numpy, as the reference builds them)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def bark_bands() -> np.ndarray:
    """Triangular Bark-scale bands [N_FREQS, N_BANDS] over 0-8 kHz, each
    bin's row normalized to sum 1."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FREQS)
    bark = 6.0 * np.arcsinh(freqs / 600.0)
    edges = np.linspace(0.0, bark[-1], N_BANDS + 2)
    fb = np.zeros((N_FREQS, N_BANDS), np.float32)
    for b in range(N_BANDS):
        lo, mid, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (bark - lo) / max(mid - lo, 1e-6)
        down = (hi - bark) / max(hi - mid, 1e-6)
        fb[:, b] = np.clip(np.minimum(up, down), 0.0, 1.0)
    # Edge bins (DC, Nyquist) fall outside the triangles: pin them to the
    # outermost bands so every bin belongs somewhere.
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-6)
    return fb


@functools.lru_cache(maxsize=1)
def _synthesis_bases():
    """Inverse real-DFT bases with the hann window folded in:
    frame = (Re @ icos + Im @ isin) reconstructs window*signal."""
    n = np.arange(N_FFT, dtype=np.float64)
    k = np.arange(N_FREQS, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    ang = 2.0 * np.pi * np.outer(k, n) / N_FFT
    # irfft scaling: bin 0 and Nyquist count once, others twice.
    scale = np.full(N_FREQS, 2.0 / N_FFT)
    scale[0] = 1.0 / N_FFT
    scale[-1] = 1.0 / N_FFT
    icos = (np.cos(ang) * scale[:, None] * window[None, :]).astype(
        np.float32)
    isin = (-np.sin(ang) * scale[:, None] * window[None, :]).astype(
        np.float32)
    return icos, isin


@functools.lru_cache(maxsize=4)
def _ola_norm(n_frames: int) -> np.ndarray:
    """COLA normalization: sum of squared hann windows at each sample."""
    n = np.arange(N_FFT)
    w2 = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))) ** 2
    total = n_frames * HOP + N_FFT
    acc = np.zeros(total, np.float64)
    for f in range(n_frames):
        acc[f * HOP:f * HOP + N_FFT] += w2
    return np.maximum(acc, 1e-6).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _ola_norm_on(n_frames: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ola_norm(n_frames)).to(device)


@functools.lru_cache(maxsize=4)
def _bases(device: torch.device) -> dict:
    """The analysis and synthesis bases and the Bark filter bank on
    `device`."""
    cos_b, sin_b = mel_ops._dft_bases()
    icos, isin = _synthesis_bases()
    return {k: torch.from_numpy(v).to(device) for k, v in (
        ("cos", cos_b), ("sin", sin_b), ("icos", icos), ("isin", isin),
        ("fb", bark_bands()))}


# ---------------------------------------------------------------------------
# STFT analysis / synthesis (fp32 matmuls on the frontend's bases)
# ---------------------------------------------------------------------------

def _stft(audio: torch.Tensor, n_frames: int):
    """audio [>= (n_frames-1)*HOP + N_FFT] → (re, im) [n_frames, N_FREQS]."""
    b = _bases(audio.device)
    frames = audio.unfold(0, N_FFT, HOP)[:n_frames]
    return frames @ b["cos"], frames @ b["sin"]


def _istft(re: torch.Tensor, im: torch.Tensor, n_samples: int) -> torch.Tensor:
    b = _bases(re.device)
    frames = re @ b["icos"] + im @ b["isin"]             # [n_frames, 400]
    n_frames = frames.shape[0]
    # Overlap-add by the 3 stride-aligned families: frame f's samples
    # [160j, 160j+160) land on hop segment f+j. Each output sample sums its
    # frames in frame order (the third family is 80 samples, zero-padded).
    parts = F.pad(frames, (0, 3 * HOP - N_FFT)).view(n_frames, 3, HOP)
    out = torch.zeros(n_frames + 3, HOP, dtype=torch.float32,
                      device=re.device)
    for j in (2, 1, 0):
        out[j:j + n_frames] += parts[:, j]
    out = out.reshape(-1)[:n_frames * HOP + N_FFT]
    return (out / _ola_norm_on(n_frames, re.device))[:n_samples]


# ---------------------------------------------------------------------------
# Gain estimators
# ---------------------------------------------------------------------------

class DenoiseState(NamedTuple):
    noise_floor: torch.Tensor    # [N_BANDS] log-energy floor
    gru_h: torch.Tensor          # [24+48+96] hidden (rnn mode)
    initialized: torch.Tensor    # bool, on the device


def init_state(device=None) -> DenoiseState:
    device = resolve_device(device)
    return DenoiseState(
        torch.full((N_BANDS,), -10.0, dtype=torch.float32, device=device),
        torch.zeros(sum(GRU_SIZES), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.bool, device=device))


def noise_floor_plain(log_e: torch.Tensor, floor0: torch.Tensor) -> torch.Tensor:
    """log_e [..., n_frames, bands], floor0 [..., bands] fp32 → the floor
    after each frame [..., n_frames, bands]: rate = 0.3 where le < floor
    else 0.003, floor = floor + rate*(le - floor)."""
    fast, slow = dsp.fp32_scalar(0.3, log_e), dsp.fp32_scalar(0.003, log_e)
    floor = floor0
    out = []
    for le in log_e.unbind(-2):
        rate = torch.where(le < floor, fast, slow)
        floor = floor + rate * (le - floor)
        out.append(floor)
    return torch.stack(out, dim=-2) if out else torch.empty_like(log_e)


def noise_floor(log_e: torch.Tensor, floor0: torch.Tensor) -> torch.Tensor:
    """The noise floor's recurrence. CPU tensors take the plain version;
    CUDA tensors launch csrc/dsp.cu:oh_noise_floor (one lane per band,
    at most 32 bands)."""
    if log_e.device.type == "cpu":
        return noise_floor_plain(log_e, floor0)
    dsp.check_cuda("noise_floor", log_e, floor0)
    *lead, n_frames, bands = log_e.shape
    if tuple(floor0.shape) != (*lead, bands) or not 1 <= bands <= 32:
        raise ValueError(f"noise_floor: log_e {tuple(log_e.shape)} and floor0 "
                         f"{tuple(floor0.shape)}; the kernel takes [..., "
                         f"n_frames, bands] and [..., bands], bands <= 32")
    log_e, floor0 = log_e.contiguous(), floor0.contiguous()
    out = torch.empty_like(log_e)
    n_sig = floor0.numel() // bands
    if n_frames == 0 or n_sig == 0:
        return out
    err = _build.library().oh_noise_floor(
        log_e.data_ptr(), floor0.data_ptr(), out.data_ptr(), n_frames, n_sig,
        bands, torch.cuda.current_stream(log_e.device).cuda_stream)
    _build.check(err, "oh_noise_floor")
    noise_floor.launches += 1
    return out


noise_floor.launches = 0


def wiener_gains(band_energy: torch.Tensor, state: DenoiseState
                 ) -> tuple[torch.Tensor, DenoiseState]:
    """band_energy [n_frames, N_BANDS] (linear) → (gains, state): the
    asymmetric-EMA noise floor (fast down, slow up), then the Wiener rule on
    the floor after each frame."""
    log_e = torch.log(band_energy + 1e-10)
    floor0 = torch.where(state.initialized, state.noise_floor, log_e[0])
    floors = noise_floor(log_e, floor0)
    snr = torch.exp(torch.clamp(log_e - floors, min=0.0)) - 1.0
    gain = snr / (snr + 1.0)
    return (torch.clamp(gain, min=0.05),
            DenoiseState(floors[-1], state.gru_h,
                         torch.ones((), dtype=torch.bool,
                                    device=band_energy.device)))


# -- RNNoise-shaped network ---------------------------------------------------

def init_rnn_params(generator: torch.Generator, device=None) -> dict:
    """dense(24, tanh) → GRU(24) → GRU(48) → GRU(96) → dense(22, sigmoid),
    the RNNoise topology, over [22 log-band energies + 22 deltas]. Weights
    N(0, 1/fan_in) from `generator` (on `device`), biases zero. The draws
    differ from JAX's PRNG: tests carry the JAX weights over instead."""
    device = resolve_device(device)

    def g(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return w / float(np.sqrt(shape[0]))

    def z(n):
        return torch.zeros(n, device=device)

    def gru(i, h):
        return {"wx": g(i, 3 * h), "wh": g(h, 3 * h), "b": z(3 * h)}

    h1, h2, h3 = GRU_SIZES
    return {
        "in_w": g(2 * N_BANDS, h1), "in_b": z(h1),
        "gru1": gru(h1, h1), "gru2": gru(h1 + h1, h2),
        "gru3": gru(h1 + h2, h3),
        "out_w": g(h3, N_BANDS), "out_b": z(N_BANDS),
        "vad_w": g(h1, 1), "vad_b": z(1),
    }


def _gru_step(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    xg = x @ p["wx"] + p["b"]
    hg = h @ p["wh"]
    n = h.shape[-1]
    z = torch.sigmoid(xg[:n] + hg[:n])
    r = torch.sigmoid(xg[n:2 * n] + hg[n:2 * n])
    c = torch.tanh(xg[2 * n:] + r * hg[2 * n:])
    return (1 - z) * c + z * h


def rnn_gains(params: dict, band_energy: torch.Tensor, state: DenoiseState
              ) -> tuple[torch.Tensor, DenoiseState, torch.Tensor]:
    """band_energy [n_frames, 22] → (gains [n_frames, 22], new state,
    vad [n_frames]), one frame after another (an eager loop)."""
    log_e = torch.log(band_energy + 1e-10)
    deltas = torch.diff(log_e, dim=0, prepend=log_e[:1])
    feats = torch.cat([log_e, deltas], dim=-1)
    # The input layer does not depend on the carried state: one product for
    # every frame.
    xs = torch.tanh(feats @ params["in_w"] + params["in_b"])
    a, b = GRU_SIZES[0], GRU_SIZES[0] + GRU_SIZES[1]
    h1, h2, h3 = state.gru_h[:a], state.gru_h[a:b], state.gru_h[b:]
    gains, vads = [], []
    for x in xs:
        h1 = _gru_step(params["gru1"], x, h1)
        h2 = _gru_step(params["gru2"], torch.cat([x, h1]), h2)
        h3 = _gru_step(params["gru3"], torch.cat([x, h2]), h3)
        gains.append(torch.sigmoid(h3 @ params["out_w"] + params["out_b"]))
        vads.append(torch.sigmoid(h1 @ params["vad_w"] + params["vad_b"])[0])
    n = len(gains)
    return (torch.stack(gains) if n else feats.new_zeros(0, N_BANDS),
            DenoiseState(state.noise_floor, torch.cat([h1, h2, h3]),
                         torch.ones((), dtype=torch.bool,
                                    device=band_energy.device)),
            torch.stack(vads) if n else feats.new_zeros(0))


# ---------------------------------------------------------------------------
# Full denoise pass
# ---------------------------------------------------------------------------

def _denoise_frames(audio: torch.Tensor, state: DenoiseState, strength: float,
                    n_frames: int, params: Optional[dict]):
    pad = N_FFT // 2
    padded = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    re, im = _stft(padded, n_frames)
    power = re * re + im * im
    fb = _bases(audio.device)["fb"]
    band_e = power @ fb                              # [n_frames, 22]
    if params is None:
        gains, state = wiener_gains(band_e, state)
    else:
        gains, state, _ = rnn_gains(params, band_e, state)
    # Interpolate band gains to bins (fb rows sum to 1: a weighted average).
    bin_gains = gains @ fb.T
    # First-frames fade-in (parity: audio.rs denoise first-frame fade).
    fade = torch.clamp((torch.arange(n_frames, dtype=torch.float32,
                                     device=audio.device) + 1.0) / 2.0, 0.0, 1.0)
    bin_gains = bin_gains * fade[:, None]
    out = _istft(re * bin_gains, im * bin_gains, audio.shape[0] + 2 * pad)
    out = out[pad:pad + audio.shape[0]]
    s = dsp.fp32_scalar(strength, audio)
    return audio * (1.0 - s) + out * s, state


def denoise_tensor(audio: torch.Tensor, strength: float = 1.0,
                   state: Optional[DenoiseState] = None,
                   params: Optional[dict] = None
                   ) -> tuple[torch.Tensor, DenoiseState]:
    """`denoise` of a 1-D fp32 tensor, on its device: returns (audio,
    streaming state). The samples past the last whole hop pass through."""
    state = state or init_state(audio.device)
    if strength <= 0.0 or audio.shape[0] < N_FFT:
        return audio, state
    n_frames = audio.shape[0] // HOP
    usable = n_frames * HOP
    head, new_state = _denoise_frames(
        audio[:usable], state, float(np.float32(np.clip(strength, 0, 1))),
        n_frames, params)
    return torch.cat([head, audio[usable:]]), new_state


def denoise(audio: np.ndarray, strength: float = 1.0,
            state: Optional[DenoiseState] = None,
            params: Optional[dict] = None, device=None
            ) -> tuple[np.ndarray, DenoiseState]:
    """Denoise mono 16 kHz audio; returns (audio, streaming state). strength
    mixes dry/wet (parity: audio.rs:249-341). Runs on the state's device,
    else on `device` (CUDA unless "cpu" is asked)."""
    device = state.noise_floor.device if state is not None else \
        resolve_device(device)
    x = torch.from_numpy(np.array(audio, np.float32)).to(device)
    y, state = denoise_tensor(x, strength, state, params)
    return y.cpu().numpy(), state
