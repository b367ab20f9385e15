"""Silero VAD (v5 family) as a PyTorch model + checkpoint converter.

Counterpart of openhush_tpu/models/silero.py. The reference consumes
Silero through the bundled ONNX model (`model.forward_chunk(chunk,
16000)` at src/vad/silero.rs:54, 512-sample/32 ms chunks at 16 kHz →
speech probability); here the network is a functional step, (params,
state, chunk) → (state, prob).

Architecture (Silero VAD v5, 16 kHz path), matching the published
checkpoint's tensor inventory:

  chunk[512] ── concat(context[64]) ──► x[576]
  STFT: reflect-pad 64, conv1d(basis [258,1,256], stride 128) → 4 frames;
        split 129 re / 129 im → magnitude [129, 4]
  encoder: 4× (conv1d k=3, ReLU), channels 129→128→64→64→128,
           strides 1,2,2,1, pad 1 → [128, 1]
  decoder: LSTMCell(128) carried across chunks → ReLU → conv1x1 → sigmoid

The JAX model runs its convolutions at Precision.HIGHEST. A float32
`conv1d` on the card goes through cuDNN in TF32 by default, so the
convolutions here are unfolded into fp32 matmuls (`conv1d_fp32`), which
the card runs in full fp32.

The converter maps the torch-jit checkpoint's names into the params
pytree (numpy arrays, the layout the npz files hold;
`models/whisper/weights.from_numpy_params` turns them into tensors).
ONNX checkpoints need the ONNX executor, which the port does not have yet
(ROADMAP A8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper.weights import from_numpy_params

CHUNK = 512
CONTEXT = 64
SR = 16_000
N_FFT = 256
HOP = 128
N_BINS = N_FFT // 2 + 1      # 129
HIDDEN = 128

# STFT reflect-pad variants seen across Silero exports.
PAD_MODES = ("left", "right", "both")


class SileroState(NamedTuple):
    h: torch.Tensor           # [HIDDEN] LSTM hidden
    c: torch.Tensor           # [HIDDEN] LSTM cell
    context: torch.Tensor     # [CONTEXT] tail of previous chunk


def init_state(batch: Optional[int] = None, device=None) -> SileroState:
    device = resolve_device(device)
    shape = (HIDDEN,) if batch is None else (batch, HIDDEN)
    ctx = (CONTEXT,) if batch is None else (batch, CONTEXT)
    return SileroState(*(torch.zeros(s, dtype=torch.float32, device=device)
                         for s in (shape, shape, ctx)))


def stft_basis() -> np.ndarray:
    """The real DFT basis the checkpoint stores: [258, 256], cos rows then
    -sin rows, times the periodic hann window."""
    n = np.arange(N_FFT)
    k = np.arange(N_BINS)
    window = np.hanning(N_FFT + 1)[:-1]
    ang = 2 * np.pi * np.outer(k, n) / N_FFT
    return (np.concatenate([np.cos(ang), -np.sin(ang)]) * window
            ).astype(np.float32)


def init_params(generator: torch.Generator, device=None) -> dict:
    """Random-init params with the checkpoint's exact shapes: the real DFT
    basis, the rest N(0, 1/fan_in) from `generator` (on `device`; its draws
    differ from JAX's PRNG), biases zero, the output 1x1 conv at 0.01."""
    device = resolve_device(device)

    def g(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return w * float(1.0 / np.sqrt(np.prod(shape[1:])))

    def z(n):
        return torch.zeros(n, device=device)

    return {
        "stft_basis": torch.from_numpy(stft_basis()).to(device),
        "enc0_w": g(128, N_BINS, 3), "enc0_b": z(128),
        "enc1_w": g(64, 128, 3), "enc1_b": z(64),
        "enc2_w": g(64, 64, 3), "enc2_b": z(64),
        "enc3_w": g(128, 64, 3), "enc3_b": z(128),
        "lstm_wi": g(4 * HIDDEN, HIDDEN),
        "lstm_wh": g(4 * HIDDEN, HIDDEN),
        "lstm_bi": z(4 * HIDDEN),
        "lstm_bh": z(4 * HIDDEN),
        "out_w": torch.full((1, HIDDEN, 1), 0.01, device=device),
        "out_b": z(1),
    }


def conv1d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                stride: int, pad: int) -> torch.Tensor:
    """x [C, T], w [O, C, K] → [O, T'], zero padding `pad` on both sides:
    the windows unfolded and one fp32 matmul (never cuDNN's TF32)."""
    O, C, K = w.shape
    cols = F.pad(x, (pad, pad)).unfold(1, K, stride)      # [C, T', K]
    out = w.reshape(O, C * K) @ cols.permute(0, 2, 1).reshape(C * K, -1)
    return out if b is None else out + b[:, None]


def _stft_magnitude(params: dict, x: torch.Tensor, pad_mode: str
                    ) -> torch.Tensor:
    """x [576] → magnitude [129, 4]."""
    left, right = {"left": (CONTEXT, 0), "right": (0, CONTEXT),
                   "both": (CONTEXT // 2, CONTEXT // 2)}[pad_mode]
    x = F.pad(x[None, None], (left, right), mode="reflect")[0]
    spec = conv1d_fp32(x, params["stft_basis"][:, None, :], None, HOP, 0)
    re, im = spec[:N_BINS], spec[N_BINS:]
    return torch.sqrt(re * re + im * im + 1e-12)


def forward_chunk(params: dict, state: SileroState, chunk: torch.Tensor,
                  pad_mode: str = "left") -> tuple[SileroState, torch.Tensor]:
    """One 512-sample 16 kHz chunk → (new state, speech probability).

    Functional parity surface: silero-vad-rust's
    `model.forward_chunk(chunk, 16000)` (reference src/vad/silero.rs:54).
    """
    x = torch.cat([state.context, chunk])                    # [576]
    mag = _stft_magnitude(params, x, pad_mode)               # [129, T]
    h = torch.relu(conv1d_fp32(mag, params["enc0_w"], params["enc0_b"], 1, 1))
    h = torch.relu(conv1d_fp32(h, params["enc1_w"], params["enc1_b"], 2, 1))
    h = torch.relu(conv1d_fp32(h, params["enc2_w"], params["enc2_b"], 2, 1))
    h = torch.relu(conv1d_fp32(h, params["enc3_w"], params["enc3_b"], 1, 1))
    feat = torch.mean(h, dim=1)                              # [128] (T'→1)

    # torch LSTMCell, gate order i, f, g, o
    gates = (params["lstm_wi"] @ feat + params["lstm_bi"]
             + params["lstm_wh"] @ state.h + params["lstm_bh"])
    i, f, g, o = torch.chunk(gates, 4)
    c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
    hh = torch.sigmoid(o) * torch.tanh(c)

    out = torch.relu(hh)
    prob = torch.sigmoid(params["out_w"][0, :, 0] @ out + params["out_b"])
    return SileroState(hh, c, chunk[-CONTEXT:]), prob[0]


# ---------------------------------------------------------------------------
# Checkpoint conversion (torch-jit names → params pytree)
# ---------------------------------------------------------------------------

_JIT_NAME_MAP = {
    "_model.stft.forward_basis_buffer": ("stft_basis", (258, 1, N_FFT)),
    "_model.encoder.0.reparam_conv.weight": ("enc0_w", (128, N_BINS, 3)),
    "_model.encoder.0.reparam_conv.bias": ("enc0_b", (128,)),
    "_model.encoder.1.reparam_conv.weight": ("enc1_w", (64, 128, 3)),
    "_model.encoder.1.reparam_conv.bias": ("enc1_b", (64,)),
    "_model.encoder.2.reparam_conv.weight": ("enc2_w", (64, 64, 3)),
    "_model.encoder.2.reparam_conv.bias": ("enc2_b", (64,)),
    "_model.encoder.3.reparam_conv.weight": ("enc3_w", (128, 64, 3)),
    "_model.encoder.3.reparam_conv.bias": ("enc3_b", (128,)),
    "_model.decoder.rnn.weight_ih": ("lstm_wi", (4 * HIDDEN, HIDDEN)),
    "_model.decoder.rnn.weight_hh": ("lstm_wh", (4 * HIDDEN, HIDDEN)),
    "_model.decoder.rnn.bias_ih": ("lstm_bi", (4 * HIDDEN,)),
    "_model.decoder.rnn.bias_hh": ("lstm_bh", (4 * HIDDEN,)),
    "_model.decoder.decoder.2.weight": ("out_w", (1, HIDDEN, 1)),
    "_model.decoder.decoder.2.bias": ("out_b", (1,)),
}


def convert_state_dict(sd: dict) -> dict:
    """Map a Silero v5 torch state_dict (jit or eager) to the params pytree
    (fp32 numpy arrays), validating every expected tensor's presence and
    shape."""
    def to_np(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v, np.float32)

    # jit checkpoints carry the _model. prefix; accept both.
    lookup = {}
    for name, v in sd.items():
        lookup[name] = v
        if not name.startswith("_model."):
            lookup["_model." + name] = v

    params = {}
    missing = []
    for src, (dst, shape) in _JIT_NAME_MAP.items():
        if src not in lookup:
            missing.append(src)
            continue
        arr = to_np(lookup[src])
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{src}: expected shape {shape}, checkpoint has "
                f"{tuple(arr.shape)} — not a Silero v5 16 kHz model?")
        params[dst] = arr[:, 0, :] if dst == "stft_basis" else arr
    if missing:
        raise ValueError(
            "checkpoint is missing expected Silero v5 tensors:\n  "
            + "\n  ".join(missing))
    return params


def convert_jit(path: str) -> dict:
    """Convert the official silero_vad.jit checkpoint."""
    model = torch.jit.load(path, map_location="cpu")
    return convert_state_dict(model.state_dict())


def save_npz(params: dict, path: str, pad_mode: str = "left") -> None:
    arrays = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                  else np.asarray(v)) for k, v in params.items()}
    arrays["meta_stft_pad_mode"] = np.asarray(
        PAD_MODES.index(pad_mode), np.int64)
    np.savez(path, **arrays)


def load_npz(path: str) -> tuple[dict, str]:
    """(params as numpy arrays, STFT pad mode)."""
    data = np.load(path)
    pad_mode = "left"
    params = {}
    for k in data.files:
        if k == "meta_stft_pad_mode":
            pad_mode = PAD_MODES[int(data[k])]
        else:
            params[k] = data[k]
    return params, pad_mode


class SileroVad:
    """Stateful host wrapper, drop-in alongside VadEngine kinds. Runs on
    CUDA unless `device` says otherwise; `params` (tensors) default to
    init_params from a generator seeded 0."""

    def __init__(self, params: Optional[dict] = None, threshold: float = 0.5,
                 pad_mode: str = "left", device=None):
        self.device = resolve_device(device)
        self.params = params or init_params(
            torch.Generator(device=self.device).manual_seed(0), self.device)
        self.threshold = threshold
        self.pad_mode = pad_mode
        self._state = init_state(device=self.device)

    @classmethod
    def load(cls, path: str, threshold: float = 0.5,
             device=None) -> "SileroVad":
        params, pad_mode = load_npz(path)
        return cls.from_numpy(params, threshold, pad_mode, device)

    @classmethod
    def from_numpy(cls, params: dict, threshold: float = 0.5,
                   pad_mode: str = "left", device=None) -> "SileroVad":
        device = resolve_device(device)
        return cls(from_numpy_params(params, device=device), threshold,
                   pad_mode, device)

    @torch.no_grad()
    def process(self, samples: np.ndarray):
        from openhush_tpu_torch.models.vad import VadResult
        chunk = np.zeros(CHUNK, np.float32)
        n = min(len(samples), CHUNK)
        chunk[:n] = samples[:n]
        self._state, prob = forward_chunk(
            self.params, self._state, torch.from_numpy(chunk).to(self.device),
            pad_mode=self.pad_mode)
        p = float(prob)
        return VadResult(p, p >= self.threshold)

    def reset(self) -> None:
        self._state = init_state(device=self.device)

    @property
    def chunk_size(self) -> int:
        return CHUNK

    @property
    def sample_rate(self) -> int:
        return SR
