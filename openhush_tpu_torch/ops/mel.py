"""Log-mel spectrogram frontend: constants, bases and the plain PyTorch version.

Computes Whisper's 80/128-bin log-mel features: hann-windowed STFT (n_fft=400,
hop=160, centered/reflect-padded), power spectrum, slaney-normalized mel
filterbank (fmax 8 kHz), log10 with dynamic-range clamp, (x+4)/4 scaling.

The DFT is two real matmuls against fixed cos/sin bases (400x201 each), so the
frontend is frame extraction plus three fp32 matmuls. `log_mel_spectrogram`
here is the plain version of the hand-written kernel in ``ops/frontend.py``;
both are held against openhush_tpu/ops/mel.py in the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30                      # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH      # 3000 encoder input frames


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) * logstep, mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


@functools.lru_cache(maxsize=4)
def mel_filter_bank(n_mels: int = 80, n_freqs: int = N_FFT // 2 + 1,
                    sample_rate: int = SAMPLE_RATE,
                    fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Triangular slaney-normalized mel filterbank, shape [n_freqs, n_mels]."""
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    filter_freqs = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]   # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    # Slaney normalization: constant energy per band.
    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_bands(n_mels: int = 80) -> np.ndarray:
    """[n_mels, 2] int32: for each mel filter, the first and last frequency
    bin where `mel_filter_bank(n_mels)` is nonzero (each filter is one
    contiguous band of bins; an empty filter gets (0, -1))."""
    fb = mel_filter_bank(n_mels)
    bands = np.empty((n_mels, 2), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        bands[m] = (nz[0], nz[-1]) if nz.size else (0, -1)
    return bands


@functools.lru_cache(maxsize=2)
def _dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases with the periodic hann window folded in.

    Returns (cos_basis, sin_basis), each [n_fft, n_fft//2+1], such that for a
    frame x: Re = x @ cos, Im = x @ sin, power = Re^2 + Im^2.
    """
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic hann
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """[B, N] → [B, N + n_fft] with n_fft//2 reflected samples on each side
    (centered STFT framing). F.pad's reflect mode needs a channel dim."""
    pad = N_FFT // 2
    return F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]


def frame_signal(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, N + n_fft] reflect-padded audio → [B, n_frames, n_fft] frames,
    frame i starting at sample i * hop."""
    return padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]


def log_mel_energies(audio: torch.Tensor, n_mels: int,
                     n_frames: int) -> torch.Tensor:
    """[B, n_frames*hop] fp32 → log10 mel energies [B, n_frames, n_mels]:
    the part of the frontend that the hand-written kernel computes. Every
    product is true fp32 (no TF32): the DFT's low bins cancel badly."""
    cos_b, sin_b = _dft_bases()
    dev = audio.device
    frames = frame_signal(reflect_pad(audio), n_frames)
    re = frames @ torch.from_numpy(cos_b).to(dev)
    im = frames @ torch.from_numpy(sin_b).to(dev)
    power = re * re + im * im                      # [B, n_frames, n_freqs]
    mel = power @ torch.from_numpy(mel_filter_bank(n_mels)).to(dev)
    return torch.log10(torch.clamp(mel, min=1e-10))


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's dynamic-range clamp and scale on [B, n_frames, n_mels] log10
    energies → [B, n_mels, n_frames]. The max is taken per audio row, as
    the reference computes it for one window at a time."""
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80,
                        n_frames: int = N_FRAMES) -> torch.Tensor:
    """Whisper log-mel features, plain PyTorch.

    audio: [B, n_samples] float32 at 16 kHz, already padded/trimmed so that
    n_samples == n_frames * HOP_LENGTH (e.g. 480_000 for a 30 s window).
    Returns [B, n_mels, n_frames] float32 in Whisper's normalized log scale.
    Whisper drops the final STFT frame; with center padding there are
    n_frames+1 frames, so only the first n_frames are computed."""
    return normalize_log_mel(log_mel_energies(audio, n_mels, n_frames))


def pad_or_trim(audio, length: int = N_SAMPLES):
    """Pad with zeros or trim the last axis to exactly `length` samples.
    Takes a numpy array or a tensor and returns the same kind."""
    n = audio.shape[-1]
    if n > length:
        return audio[..., :length]
    if n < length:
        if isinstance(audio, torch.Tensor):
            return F.pad(audio, (0, length - n))
        return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, length - n)])
    return audio
