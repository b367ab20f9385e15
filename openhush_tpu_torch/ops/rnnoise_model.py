"""RNNoise: published-model-file parser + the exact network topology.

Counterpart of openhush_tpu/ops/rnnoise_model.py. The reference denoises
with `nnnoiseless` (a Rust port of xiph RNNoise; DenoiseState::process_frame
at src/input/audio.rs:293). RNNoise models are published as whitespace-
separated integer text files (xiph rnnoise's `rnnoise_model_from_file` in
src/rnn_reader.c): a "rnnoise-nu model file version 1" header, then the six
layers in order

    input_dense (Dense), vad_gru, noise_gru, denoise_gru (GRU),
    denoise_output, vad_output (Dense)

each as `nb_inputs nb_neurons <weights…> <bias…> activation`, weights
quantized x256. The compute graph:

    x42 → input_dense(tanh) → d24
    vad_gru(d24) → v24;          vad = vad_output(v24)        (sigmoid)
    noise_gru([d24, v24, x42]) → n48
    denoise_gru([v24, n48, x42]) → dn96
    gains = denoise_output(dn96)                              (sigmoid)

RNNoise's GRU applies the reset gate to the state before the recurrent
matmul (r*state @ Wh, "linear after reset") and updates
state = z*state + (1-z)*h. Weights are scaled by 1/256 at load. A layer's
`act` stays a Python int; `rnn_sequence` is an eager loop over frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openhush_tpu_torch.models.whisper.weights import from_numpy_params

MAGIC = "rnnoise-nu model file version"
WEIGHTS_SCALE = 1.0 / 256.0
_ACTIVATIONS = {0: torch.tanh, 1: torch.sigmoid, 2: torch.relu}


class _Reader:
    def __init__(self, text: str):
        self.toks = text.split()
        self.pos = 0

    def ints(self, n: int) -> np.ndarray:
        out = np.asarray(self.toks[self.pos:self.pos + n], np.float32)
        if out.size != n:
            raise ValueError("model file truncated")
        self.pos += n
        return out

    def int1(self) -> int:
        v = int(self.toks[self.pos])
        self.pos += 1
        return v


def _read_dense(r: _Reader) -> dict:
    m, n = r.int1(), r.int1()
    w = r.ints(m * n).reshape(m, n) * WEIGHTS_SCALE     # out_i = x @ w + b
    b = r.ints(n) * WEIGHTS_SCALE
    act = r.int1()
    return {"w": w, "b": b, "act": act}


def _read_gru(r: _Reader) -> dict:
    m, n = r.int1(), r.int1()
    wx = r.ints(m * 3 * n).reshape(m, 3 * n) * WEIGHTS_SCALE  # [z|r|h] cols
    wh = r.ints(n * 3 * n).reshape(n, 3 * n) * WEIGHTS_SCALE
    b = r.ints(3 * n) * WEIGHTS_SCALE
    act = r.int1()
    return {"wx": wx, "wh": wh, "b": b, "act": act}


def parse_model_file(text: str, device=None) -> dict:
    """Parse the RNNoise text model format into a params pytree of tensors
    on `device` (CUDA unless "cpu" is asked)."""
    header, _, rest = text.partition("\n")
    if not header.startswith(MAGIC):
        raise ValueError(f"not an RNNoise model file (header {header!r})")
    version = int(header[len(MAGIC):].strip())
    if version != 1:
        raise ValueError(f"unsupported RNNoise model version {version}")
    r = _Reader(rest)
    params = {
        "input_dense": _read_dense(r),
        "vad_gru": _read_gru(r),
        "noise_gru": _read_gru(r),
        "denoise_gru": _read_gru(r),
        "denoise_output": _read_dense(r),
        "vad_output": _read_dense(r),
    }
    # Structural validation: the concat pattern must be consistent.
    d = params["input_dense"]["w"].shape[1]
    v = params["vad_gru"]["wx"].shape[1] // 3
    x = params["input_dense"]["w"].shape[0]
    n = params["noise_gru"]["wx"].shape[1] // 3
    if params["noise_gru"]["wx"].shape[0] != d + v + x:
        raise ValueError("noise_gru input dim inconsistent with topology")
    if params["denoise_gru"]["wx"].shape[0] != v + n + x:
        raise ValueError("denoise_gru input dim inconsistent with topology")
    return from_numpy_params(params, device=device)


def load(path: str, device=None) -> dict:
    with open(path) as fh:
        return parse_model_file(fh.read(), device)


def save_npz(params: dict, path: str) -> None:
    flat = {}
    for layer, p in params.items():
        for k, v in p.items():
            flat[f"{layer}.{k}"] = (v.detach().cpu().numpy()
                                    if torch.is_tensor(v) else np.asarray(v))
    np.savez(path, **flat)


def load_npz(path: str, device=None) -> dict:
    data = np.load(path)
    params: dict = {}
    for key in data.files:
        layer, _, k = key.rpartition(".")
        arr = data[key]
        params.setdefault(layer, {})[k] = int(arr) if k == "act" else arr
    return from_numpy_params(params, device=device)


# ---------------------------------------------------------------------------
# Exact compute graph
# ---------------------------------------------------------------------------

class RnnoiseRnnState(NamedTuple):
    vad: torch.Tensor        # [24]
    noise: torch.Tensor      # [48]
    denoise: torch.Tensor    # [96]


def init_rnn_state(params: dict) -> RnnoiseRnnState:
    def z(layer):
        wx = params[layer]["wx"]
        return torch.zeros(wx.shape[1] // 3, dtype=torch.float32,
                           device=wx.device)

    return RnnoiseRnnState(z("vad_gru"), z("noise_gru"), z("denoise_gru"))


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _ACTIVATIONS[p["act"]](x @ p["w"] + p["b"])


def _gru(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """RNNoise GRU: reset applied to state before the recurrent matmul;
    state' = z*state + (1-z)*h_cand (src/rnn.c compute_gru semantics)."""
    n = h.shape[-1]
    xg = x @ p["wx"] + p["b"]
    hg = h @ p["wh"]
    z = torch.sigmoid(xg[..., :n] + hg[..., :n])
    r = torch.sigmoid(xg[..., n:2 * n] + hg[..., n:2 * n])
    cand = _ACTIVATIONS[p["act"]](
        xg[..., 2 * n:] + (r * h) @ p["wh"][:, 2 * n:])
    return z * h + (1 - z) * cand


def rnn_step(params: dict, state: RnnoiseRnnState, features: torch.Tensor
             ) -> tuple[RnnoiseRnnState, torch.Tensor, torch.Tensor]:
    """One 10 ms frame: features [42] → (state, gains [22], vad prob)."""
    d = _dense(params["input_dense"], features)
    v = _gru(params["vad_gru"], d, state.vad)
    vad = _dense(params["vad_output"], v)[0]
    nz = _gru(params["noise_gru"], torch.cat([d, v, features]), state.noise)
    dn = _gru(params["denoise_gru"], torch.cat([v, nz, features]),
              state.denoise)
    gains = _dense(params["denoise_output"], dn)
    return RnnoiseRnnState(v, nz, dn), gains, vad


def rnn_sequence(params: dict, state: RnnoiseRnnState, features: torch.Tensor):
    """features [T, 42] → (state, gains [T, 22], vad [T]), one frame after
    another (an eager loop)."""
    gains, vads = [], []
    for f in features:
        state, g, v = rnn_step(params, state, f)
        gains.append(g)
        vads.append(v)
    if not gains:
        n_out = params["denoise_output"]["w"].shape[1]
        return state, features.new_zeros(0, n_out), features.new_zeros(0)
    return state, torch.stack(gains), torch.stack(vads)
