"""Log-mel frontend on the hand-written CUDA kernel (csrc/frontend.cu).

Counterpart of openhush_tpu/ops/frontend_pallas.py. The kernel computes
log10 mel energies from the reflect-padded audio; the dynamic-range clamp,
the (x+4)/4 scale and the transpose stay in PyTorch
(``mel.normalize_log_mel``), as they were an XLA epilogue in JAX.
"""

from __future__ import annotations

import functools

import torch

from openhush_tpu_torch.ops import _build, mel

THREADS = 256          # the kernel's block size: one thread per mel bin


@functools.lru_cache(maxsize=8)
def _bases(n_mels: int, device: torch.device):
    cos_b, sin_b = mel._dft_bases()
    fb = mel.mel_filter_bank(n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


def log_mel_energies(audio: torch.Tensor, n_mels: int,
                     n_frames: int) -> torch.Tensor:
    """[B, n_frames*hop] fp32 → log10 mel energies [B, n_frames, n_mels].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if audio.device.type == "cpu":
        return mel.log_mel_energies(audio, n_mels, n_frames)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {audio.device}")
    if audio.ndim != 2 or n_mels > THREADS:
        raise ValueError(f"log_mel: audio {tuple(audio.shape)} must be "
                         f"[B, N] and n_mels <= {THREADS}")
    padded = mel.reflect_pad(audio).contiguous()
    if (n_frames - 1) * mel.HOP_LENGTH + mel.N_FFT > padded.shape[1]:
        raise ValueError(f"log_mel: {audio.shape[1]} samples are fewer "
                         f"than {n_frames} frames need")
    cos_b, sin_b, fb = _bases(n_mels, audio.device)
    out = torch.empty(audio.shape[0], n_frames, n_mels,
                      dtype=torch.float32, device=audio.device)
    err = _build.library().oh_log_mel(
        padded.data_ptr(), padded.shape[1], cos_b.data_ptr(),
        sin_b.data_ptr(), fb.data_ptr(), out.data_ptr(), audio.shape[0],
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
