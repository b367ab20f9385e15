"""Log-mel frontend on the hand-written CUDA kernel (csrc/frontend.cu).

Counterpart of openhush_tpu/ops/frontend_pallas.py. The kernel computes
log10 mel energies from the audio, reading the centred frames' reflect
padding in place; the dynamic-range clamp,
the (x+4)/4 scale and the transpose stay in PyTorch
(``mel.normalize_log_mel``), as they were an XLA epilogue in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openhush_tpu_torch.ops import _build, mel

KPAD = 208             # the kernel's bins: 201, padded to 52 groups of 4
MAX_BAND = 16          # the kernel's room for one mel filter's bins


@functools.lru_cache(maxsize=8)
def _bases(n_mels: int, device: torch.device):
    """The kernel's constants on `device`: the windowed DFT bases as one
    [400, cos 208 | sin 208] fp32 array (bins past 200 zero), each mel
    filter's weights over its band (mel.mel_bands) [n_mels, MAX_BAND],
    zeros past it, and the band's first bin [n_mels] int32."""
    cos_b, sin_b = mel._dft_bases()
    basis = np.zeros((mel.N_FFT, 2 * KPAD), np.float32)
    basis[:, :cos_b.shape[1]] = cos_b
    basis[:, KPAD:KPAD + sin_b.shape[1]] = sin_b
    fb, bands = mel.mel_filter_bank(n_mels), mel.mel_bands(n_mels)
    if (bands[:, 1] - bands[:, 0]).max(initial=0) >= MAX_BAND:
        raise ValueError(f"log_mel: a filter of the {n_mels}-mel bank spans "
                         f"more than {MAX_BAND} bins")
    weights = np.zeros((n_mels, MAX_BAND), np.float32)
    for m, (lo, hi) in enumerate(bands):
        weights[m, :hi - lo + 1] = fb[lo:hi + 1, m]
    return tuple(torch.from_numpy(a).to(device)
                 for a in (basis, weights, np.ascontiguousarray(bands[:, 0])))


def log_mel_energies(audio: torch.Tensor, n_mels: int,
                     n_frames: int) -> torch.Tensor:
    """[B, n_frames*hop] fp32 → log10 mel energies [B, n_frames, n_mels].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if audio.device.type == "cpu":
        return mel.log_mel_energies(audio, n_mels, n_frames)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {audio.device}")
    if audio.ndim != 2 or n_mels < 1 or audio.shape[1] <= mel.N_FFT // 2:
        raise ValueError(f"log_mel: audio {tuple(audio.shape)} must be "
                         f"[B, N] with N > {mel.N_FFT // 2}, and n_mels >= 1")
    if (n_frames - 1) * mel.HOP_LENGTH > audio.shape[1]:
        raise ValueError(f"log_mel: {audio.shape[1]} samples are fewer "
                         f"than {n_frames} frames need")
    audio = audio.float().contiguous()
    basis, weights, first = _bases(n_mels, audio.device)
    out = torch.empty(audio.shape[0], n_frames, n_mels,
                      dtype=torch.float32, device=audio.device)
    err = _build.library().oh_log_mel(
        audio.data_ptr(), audio.shape[1], basis.data_ptr(),
        weights.data_ptr(), first.data_ptr(), out.data_ptr(), audio.shape[0],
        n_frames, n_mels, torch.cuda.current_stream(audio.device).cuda_stream)
    _build.check(err, "oh_log_mel")
    log_mel_energies.launches += 1
    return out


log_mel_energies.launches = 0


def log_mel(audio: torch.Tensor, n_mels: int = 80,
            n_frames: int = mel.N_FRAMES) -> torch.Tensor:
    """Whisper log-mel features of [B, n_frames*hop] fp32 audio at 16 kHz →
    [B, n_mels, n_frames], the scale of mel.log_mel_spectrogram."""
    return mel.normalize_log_mel(
        log_mel_energies(audio.float(), n_mels, n_frames))
