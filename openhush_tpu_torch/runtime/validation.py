"""Audio validation guard before device dispatch.

Parity with the reference's pre-FFI validation (src/engine/validation.rs:8-118):
empty check, 0.1 s–300 s duration limits, NaN/Inf counting, 16 kHz-only sample
rate, and RMS/min/max info. Here the "FFI boundary" is the host→GPU transfer;
the checks keep garbage out of compiled graphs (NaNs would poison the KV cache
and every later decode step sharing the batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_AUDIO_DURATION_SECS = 300.0
MIN_AUDIO_DURATION_SECS = 0.1
EXPECTED_SAMPLE_RATE = 16_000


class AudioValidationError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class AudioValidationInfo:
    duration_secs: float
    sample_count: int
    min_value: float
    max_value: float
    rms: float


def validate_audio(samples: np.ndarray,
                   sample_rate: int = EXPECTED_SAMPLE_RATE) -> AudioValidationInfo:
    samples = np.asarray(samples)
    if samples.size == 0:
        raise AudioValidationError("Audio is empty (no samples)")
    if sample_rate != EXPECTED_SAMPLE_RATE:
        raise AudioValidationError(
            f"Unexpected sample rate: {sample_rate}Hz "
            f"(expected {EXPECTED_SAMPLE_RATE}Hz)")
    duration = samples.size / sample_rate
    if duration > MAX_AUDIO_DURATION_SECS:
        raise AudioValidationError(
            f"Audio too long: {duration:.1f}s exceeds maximum "
            f"{MAX_AUDIO_DURATION_SECS:.1f}s")
    if duration < MIN_AUDIO_DURATION_SECS:
        raise AudioValidationError(
            f"Audio too short: {duration:.3f}s below minimum "
            f"{MIN_AUDIO_DURATION_SECS:.3f}s")
    nan_count = int(np.isnan(samples).sum())
    if nan_count:
        raise AudioValidationError(f"Audio contains {nan_count} NaN values")
    inf_count = int(np.isinf(samples).sum())
    if inf_count:
        raise AudioValidationError(
            f"Audio contains {inf_count} infinite values")
    return AudioValidationInfo(
        duration_secs=float(duration),
        sample_count=int(samples.size),
        min_value=float(samples.min()),
        max_value=float(samples.max()),
        rms=float(np.sqrt(np.mean(samples.astype(np.float64) ** 2))),
    )
