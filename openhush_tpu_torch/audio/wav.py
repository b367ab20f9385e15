"""WAV file loading: any sample rate / bit depth / channel count.

Parity with the reference's `load_wav_file` (src/input/audio.rs:348-434):
decode → mono mix → resample to 16 kHz → pad to Whisper's 1.1 s minimum.
Implemented with the stdlib `wave` module + numpy (no soundfile dependency);
also handles float32 WAVs, which `wave` rejects, via a minimal RIFF parser.
"""

from __future__ import annotations

import struct
import wave

import numpy as np

from openhush_tpu_torch.ops.mel import SAMPLE_RATE
from openhush_tpu_torch.ops.resample import resample

# Whisper needs >= 1.0 s of audio; reference pads to 1.1 s
# (src/input/audio.rs:726-735).
MIN_DURATION_S = 1.1


def _parse_riff_float(path: str):
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3) and other
    cases the stdlib `wave` module cannot handle."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size)
            if size % 2:
                f.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        tag, channels, rate = struct.unpack("<HHI", fmt[:8])
        bits = struct.unpack("<H", fmt[14:16])[0]
        if tag == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
            tag = struct.unpack("<H", fmt[24:26])[0]
        if tag == 3 and bits == 32:
            samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif tag == 3 and bits == 64:
            samples = np.frombuffer(data, dtype="<f8").astype(np.float32)
        elif tag == 1:
            samples = _pcm_to_float(data, bits)
        else:
            raise ValueError(f"{path}: unsupported WAV format tag={tag} bits={bits}")
        return samples, channels, rate


def _pcm_to_float(raw: bytes, bits: int) -> np.ndarray:
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        return val.astype(np.float32) / float(1 << 23)
    raise ValueError(f"unsupported PCM bit depth: {bits}")


def mix_to_mono(samples: np.ndarray, channels: int,
                selected: list[int] | None = None) -> np.ndarray:
    """Interleaved multi-channel → mono mean mix; optionally a channel subset
    (parity: mix_channels_to_mono, src/input/audio.rs:864-902)."""
    if channels <= 1:
        return samples
    n = (len(samples) // channels) * channels
    frames = samples[:n].reshape(-1, channels)
    if selected:
        sel = [c for c in selected if 0 <= c < channels]
        if sel:
            frames = frames[:, sel]
    return frames.mean(axis=1).astype(np.float32)


def load_wav(path: str, target_rate: int = SAMPLE_RATE,
             min_duration_s: float = MIN_DURATION_S) -> np.ndarray:
    """Load a WAV file → mono float32 at target_rate, padded to the minimum
    Whisper duration. Parity: src/input/audio.rs:348-434."""
    try:
        with wave.open(path, "rb") as w:
            channels = w.getnchannels()
            rate = w.getframerate()
            bits = w.getsampwidth() * 8
            raw = w.readframes(w.getnframes())
        samples = _pcm_to_float(raw, bits)
    except wave.Error:
        samples, channels, rate = _parse_riff_float(path)

    mono = mix_to_mono(samples, channels)
    if rate != target_rate:
        mono = resample(mono, rate, target_rate)
    min_samples = int(min_duration_s * target_rate)
    if len(mono) < min_samples:
        mono = np.pad(mono, (0, min_samples - len(mono)))
    return np.ascontiguousarray(mono, dtype=np.float32)


def save_wav(path: str, samples: np.ndarray, rate: int = SAMPLE_RATE) -> None:
    """Write mono float32 samples as 16-bit PCM."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
