"""Voice activity detection: device-side gate + streaming state machine.

Counterpart of openhush_tpu/models/vad.py. Two engines behind one
interface, each a functional step (state, chunk) → (state, prob) on
512-sample (32 ms at 16 kHz) chunks, the state on the device:

- energy: an adaptive noise-floor spectral-energy gate, no weights (the
  default in air-gapped deployments);
- gru: a Silero-like learned model (log-mel features → GRU → sigmoid);
  weights load from npz or come from an explicit generator.

`SileroVad` (models/silero.py) is the third engine. The published
Silero `.onnx` needs the ONNX executor, which the port does not have yet
(ROADMAP A8): `OnnxSileroVad` raises.

The VadState streaming segmenter is a copy of the reference's, which
reproduces src/vad/mod.rs:158-224 exactly: min_silence to end a segment,
min_speech to accept it, average probability reporting, pad handling left
to the caller.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models import silero
from openhush_tpu_torch.models.whisper.weights import (from_numpy_params,
                                                       load_npz)
from openhush_tpu_torch.ops.mel import mel_filter_bank

log = logging.getLogger(__name__)

CHUNK_SIZE = 512          # samples per VAD chunk (32 ms @ 16 kHz)
SAMPLE_RATE = 16_000


@dataclasses.dataclass(frozen=True)
class VadResult:
    probability: float
    is_speech: bool


# ---------------------------------------------------------------------------
# Energy VAD (no weights)
# ---------------------------------------------------------------------------

class EnergyVadState(NamedTuple):
    noise_floor: torch.Tensor    # EMA of non-speech band energy (log domain)
    initialized: torch.Tensor    # bool


@functools.lru_cache(maxsize=1)
def _band_basis():
    """DFT power basis restricted to the speech band (250-3800 Hz) for a
    hann-windowed 512-sample chunk: returns (cos, sin) [512, n_bins] fp32."""
    n = np.arange(CHUNK_SIZE)
    window = 0.5 * (1 - np.cos(2 * np.pi * n / CHUNK_SIZE))
    freqs = np.fft.rfftfreq(CHUNK_SIZE, 1.0 / SAMPLE_RATE)
    keep = (freqs >= 250.0) & (freqs <= 3800.0)
    k = np.nonzero(keep)[0].astype(np.float64)
    ang = 2 * np.pi * np.outer(n, k) / CHUNK_SIZE
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _on(device: torch.device, basis):
    """`basis()`'s arrays as tensors on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in basis())


def energy_vad_init(device=None) -> EnergyVadState:
    device = resolve_device(device)
    return EnergyVadState(
        torch.full((), -12.0, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.bool, device=device))


def energy_vad_step(state: EnergyVadState, chunk: torch.Tensor
                    ) -> tuple[EnergyVadState, torch.Tensor]:
    """chunk [512] fp32 → (state, speech probability). Adaptive noise floor:
    the floor tracks quiet chunks fast and loud chunks very slowly, so
    sustained speech doesn't get absorbed into the floor."""
    cos_b, sin_b = _on(chunk.device, _band_basis)
    re, im = chunk @ cos_b, chunk @ sin_b
    band_energy = torch.log(torch.mean(re * re + im * im) + 1e-10)

    floor = torch.where(state.initialized, state.noise_floor, band_energy)
    over = band_energy - floor
    # ~8 dB (log ≈ 1.8) above the floor → speech; logistic around +0.9.
    prob = torch.sigmoid((over - 0.9) * 2.5)
    rate = torch.where(band_energy < floor, 0.3, 0.005)
    floor = floor + rate * (band_energy - floor)
    return EnergyVadState(floor, torch.ones_like(state.initialized)), prob


# ---------------------------------------------------------------------------
# GRU VAD (Silero-like, trainable/loadable)
# ---------------------------------------------------------------------------

N_FEATS = 40
HIDDEN = 64


class GruVadState(NamedTuple):
    h: torch.Tensor              # [HIDDEN]


def gru_vad_init_params(generator: torch.Generator, dtype=torch.float32,
                        device=None) -> dict:
    """N(0, 1/fan_in) weights from `generator` (on `device`; its draws
    differ from JAX's PRNG), biases zero."""
    device = resolve_device(device)

    def init(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return (w / float(np.sqrt(shape[0]))).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    return {
        "feat_w": init(N_FEATS, HIDDEN),
        "feat_b": zeros(HIDDEN),
        # fused GRU gates: [update, reset, candidate]
        "gru_wx": init(HIDDEN, 3 * HIDDEN),
        "gru_wh": init(HIDDEN, 3 * HIDDEN),
        "gru_b": zeros(3 * HIDDEN),
        "out_w": init(HIDDEN, 1),
        "out_b": zeros(1),
    }


@functools.lru_cache(maxsize=1)
def _mel_basis_512():
    n = np.arange(CHUNK_SIZE)
    window = 0.5 * (1 - np.cos(2 * np.pi * n / CHUNK_SIZE))
    k = np.arange(CHUNK_SIZE // 2 + 1, dtype=np.float64)
    ang = 2 * np.pi * np.outer(n, k) / CHUNK_SIZE
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    fb = mel_filter_bank(N_FEATS, CHUNK_SIZE // 2 + 1, SAMPLE_RATE)
    return cos_b, sin_b, fb


def gru_vad_init_state(device=None) -> GruVadState:
    return GruVadState(torch.zeros(HIDDEN, dtype=torch.float32,
                                   device=resolve_device(device)))


def gru_vad_step(params: dict, state: GruVadState, chunk: torch.Tensor
                 ) -> tuple[GruVadState, torch.Tensor]:
    cos_b, sin_b, fb = _on(chunk.device, _mel_basis_512)
    re, im = chunk @ cos_b, chunk @ sin_b
    mel = torch.log10(torch.clamp((re * re + im * im) @ fb, min=1e-10))
    x = torch.tanh(mel @ params["feat_w"] + params["feat_b"])
    xg = x @ params["gru_wx"] + params["gru_b"]
    hg = state.h @ params["gru_wh"]
    z = torch.sigmoid(xg[:HIDDEN] + hg[:HIDDEN])
    r = torch.sigmoid(xg[HIDDEN:2 * HIDDEN] + hg[HIDDEN:2 * HIDDEN])
    n = torch.tanh(xg[2 * HIDDEN:] + r * hg[2 * HIDDEN:])
    h = (1 - z) * n + z * state.h
    prob = torch.sigmoid((h @ params["out_w"] + params["out_b"])[0])
    return GruVadState(h), prob


# ---------------------------------------------------------------------------
# Engines (stateful wrappers, reference trait parity: src/vad/mod.rs:34-55)
# ---------------------------------------------------------------------------

class VadEngine:
    """Stateful host wrapper over a functional VAD step. Runs on CUDA unless
    `device` says otherwise; gru `params` (tensors) default to
    gru_vad_init_params from a generator seeded 0."""

    def __init__(self, threshold: float = 0.5, kind: str = "energy",
                 params: Optional[dict] = None, device=None):
        self.threshold = threshold
        self.kind = kind
        self.device = resolve_device(device)
        if kind == "gru":
            self.params = params or gru_vad_init_params(
                torch.Generator(device=self.device).manual_seed(0),
                device=self.device)
        self.reset()

    @torch.no_grad()
    def process(self, samples: np.ndarray) -> VadResult:
        chunk = np.zeros(CHUNK_SIZE, np.float32)
        n = min(len(samples), CHUNK_SIZE)
        chunk[:n] = samples[:n]
        x = torch.from_numpy(chunk).to(self.device)
        if self.kind == "gru":
            self._state, prob = gru_vad_step(self.params, self._state, x)
        else:
            self._state, prob = energy_vad_step(self._state, x)
        p = float(prob)
        return VadResult(p, p >= self.threshold)

    def reset(self) -> None:
        if self.kind == "gru":
            self._state = gru_vad_init_state(self.device)
        else:
            self._state = energy_vad_init(self.device)

    @property
    def chunk_size(self) -> int:
        return CHUNK_SIZE

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE


class OnnxSileroVad:
    """Silero VAD from the published .onnx. It needs an ONNX executor, which
    the port does not have yet (ROADMAP A8)."""

    def __init__(self, path: str, threshold: float = 0.5):
        raise NotImplementedError(
            f"OnnxSileroVad({path!r}): the ONNX executor is not ported yet "
            "(ROADMAP A8); convert the model to a Silero .npz instead")


# What a missing or broken model file raises while it is read.
_LOAD_ERRORS = (OSError, ValueError, EOFError, KeyError, IndexError,
                zipfile.BadZipFile)


def create_engine(cfg, device=None):
    """Build the configured VAD engine. A model file that is missing or
    broken falls back to the weight-free energy gate (reference behaviour:
    optional init logs and continues, src/daemon.rs:79-86); the fallback
    covers reading the file only, never a kernel or device error, and an
    `.onnx` Silero raises NotImplementedError (ROADMAP A8)."""
    engine = getattr(cfg, "engine", "energy")
    threshold = getattr(cfg, "threshold", 0.5)
    path = getattr(cfg, "model_path", "")
    if engine == "silero" and path.endswith(".onnx"):
        return OnnxSileroVad(path, threshold)
    params = pad_mode = None
    try:
        if engine == "silero":
            params, pad_mode = silero.load_npz(path)
        elif engine == "gru" and path:
            params = load_npz(path)
    except _LOAD_ERRORS as e:
        log.warning("VAD engine %r unavailable (%s); using energy gate",
                    engine, e)
        return VadEngine(threshold, kind="energy", device=device)
    if engine == "silero":
        return silero.SileroVad.from_numpy(params, threshold, pad_mode, device)
    if engine == "gru":
        return VadEngine(threshold, kind="gru", device=device, params=(
            None if params is None else from_numpy_params(params,
                                                          device=device)))
    return VadEngine(threshold, kind="energy", device=device)


# ---------------------------------------------------------------------------
# Streaming state machine (exact parity: src/vad/mod.rs:158-224)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpeechSegment:
    start: int                # sample position
    end: int
    avg_probability: float


@dataclasses.dataclass
class VadStateConfig:
    threshold: float = 0.5
    min_silence_ms: int = 700
    min_speech_ms: int = 250
    speech_pad_ms: int = 30


class VadState:
    """Tracks speech/silence transitions, emits segments on speech end."""

    def __init__(self, config: Optional[VadStateConfig] = None,
                 sample_rate: int = SAMPLE_RATE):
        self.config = config or VadStateConfig()
        self.sample_rate = sample_rate
        self.reset()

    def reset(self) -> None:
        self._probs: list[float] = []
        self.in_speech = False
        self.speech_start: Optional[int] = None
        self._silence_samples = 0
        self._total_samples = 0

    def update(self, result: VadResult,
               chunk_samples: int) -> Optional[SpeechSegment]:
        self._probs.append(result.probability)
        prev_total = self._total_samples
        self._total_samples += chunk_samples
        min_silence = int(self.config.min_silence_ms / 1000 *
                          self.sample_rate)
        min_speech = int(self.config.min_speech_ms / 1000 * self.sample_rate)

        if result.is_speech:
            self._silence_samples = 0
            if not self.in_speech:
                self.in_speech = True
                self.speech_start = prev_total
            return None

        self._silence_samples += chunk_samples
        if self.in_speech and self._silence_samples >= min_silence:
            self.in_speech = False
            start = self.speech_start or 0
            self.speech_start = None
            end = prev_total       # reference semantics: position at the
            # chunk where the silence threshold was crossed
            if end - start >= min_speech:
                avg = (sum(self._probs) / len(self._probs)
                       if self._probs else 0.0)
                self._probs.clear()
                return SpeechSegment(start, end, avg)
            self._probs.clear()
        return None
