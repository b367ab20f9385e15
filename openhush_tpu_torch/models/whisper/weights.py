"""Whisper parameters as a dict of torch tensors, in the JAX package's layout.

The layout is openhush_tpu's (models/whisper/model.py:init_params and
convert.py): per-layer weights stacked on a leading [n_layer] axis, linear
weights [in, out] (y = x @ W + b), conv stems HIO [3, in, out]. Weights move
between the two packages as numpy arrays, through `from_numpy_params`, or
as the `.npz` files that `openhush_tpu.models.whisper.convert.save_npz`
writes (`save_npz` and `load_npz` below are copies of its writer and
reader).
"""

from __future__ import annotations

import numpy as np
import torch

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.models.whisper.config import WhisperConfig
from openhush_tpu_torch.models.whisper.model import sinusoids

Params = dict


def save_npz(params: dict, path: str) -> None:
    """Nested dict of arrays → a flat `a/b/c` .npz (the reference's
    convert.save_npz)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = (node.detach().cpu().numpy()
                            if torch.is_tensor(node) else np.asarray(node))

    walk("", params)
    np.savez(path, **flat)


def load_npz(path: str) -> dict:
    """Flat `a/b/c` npz keys → nested dict of numpy arrays."""
    flat = np.load(path)
    params: dict = {}
    for key in flat.files:
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return params


def _to_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16 from jax: no numpy twin
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_params(tree, dtype: torch.dtype = torch.float32,
                      device=None) -> Params:
    """Nested dict of arrays (numpy, or anything np.asarray takes, e.g. the
    JAX `init_params` output) → the same nesting of torch tensors on
    `device`, floating arrays cast to `dtype`. An int8 weight {"q": int8,
    "s": scales} (the reference's quantize_*_weights) keeps int8 levels
    and fp32 scales whatever `dtype` is. A Python int stays an int (the
    RNNoise layers' `act` selectors); so this also carries the aux models'
    weights over: Silero, the GRU VAD, denoise's RNN, the wake-word
    embedding and classifier, and RNNoise."""
    device = resolve_device(device)

    def walk(node, dt=dtype):
        if isinstance(node, dict):
            scale_dt = torch.float32 if set(node) == {"q", "s"} else dt
            return {k: walk(v, scale_dt if k == "s" else dt)
                    for k, v in node.items()}
        if isinstance(node, int):
            return node
        return _to_tensor(node, dt, device)

    return walk(tree)


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random-init parameters in the reference layout: linear weights
    N(0, 1/fan_in), biases zero, layernorms identity, sinusoidal encoder
    positions, vocab padding rows of the embedding zero. The draws come
    from `generator` (on `device`) and differ from JAX's PRNG."""
    device = resolve_device(device)
    d, ffn = cfg.n_audio_state, cfg.ffn_dim

    def lin(*shape):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * shape[-2] ** -0.5).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def layers(L, d, cross):
        out = {
            "ln1_scale": ones(L, d), "ln1_bias": zeros(L, d),
            "q_w": lin(L, d, d), "q_b": zeros(L, d),
            "k_w": lin(L, d, d),
            "v_w": lin(L, d, d), "v_b": zeros(L, d),
            "o_w": lin(L, d, d), "o_b": zeros(L, d),
            "ln2_scale": ones(L, d), "ln2_bias": zeros(L, d),
        }
        if cross:
            out.update({
                "xq_w": lin(L, d, d), "xq_b": zeros(L, d),
                "xk_w": lin(L, d, d),
                "xv_w": lin(L, d, d), "xv_b": zeros(L, d),
                "xo_w": lin(L, d, d), "xo_b": zeros(L, d),
                "ln3_scale": ones(L, d), "ln3_bias": zeros(L, d),
            })
        out.update({"fc1_w": lin(L, d, ffn), "fc1_b": zeros(L, ffn),
                    "fc2_w": lin(L, ffn, d), "fc2_b": zeros(L, d)})
        return out

    dec_d = cfg.n_text_state
    tok_emb = lin(cfg.n_vocab_padded, dec_d)
    tok_emb[cfg.n_vocab:] = 0
    return {
        "encoder": {
            "conv1_w": lin(3, cfg.n_mels, d), "conv1_b": zeros(d),
            "conv2_w": lin(3, d, d), "conv2_b": zeros(d),
            "pos_emb": torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)
                                        ).to(device=device, dtype=dtype),
            "layers": layers(cfg.n_audio_layer, d, cross=False),
            "ln_post_scale": ones(d), "ln_post_bias": zeros(d),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos_emb": lin(cfg.n_text_ctx, dec_d),
            "layers": layers(cfg.n_text_layer, dec_d, cross=True),
            "ln_scale": ones(dec_d), "ln_bias": zeros(dec_d),
        },
    }
