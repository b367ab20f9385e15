"""Encoder self-attention on the hand-written CUDA flash kernel
(csrc/flash_attention.cu).

Counterpart of openhush_tpu/models/whisper/model.py:_attend_full, which runs
the Pallas TPU flash kernel on the chip and the dense `_attend` elsewhere.
`attend` here is a copy of `_attend` and the kernel's plain version.
"""

from __future__ import annotations

import ctypes

import torch

from openhush_tpu_torch.ops import _build

HEAD_DIM = 64          # the only head size the kernel takes (every Whisper)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] → [B, H, Tq, Dh]. Scores and softmax in fp32,
    probabilities cast to the input dtype before the value product."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check(q, k, v):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of {list(_DTYPES)}")
    if q.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; the kernel "
                         f"takes [B, H, T, {HEAD_DIM}]")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1 \
                or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_attention: q, k, v must share a device, "
                             "have a contiguous last dim and 16-byte aligned "
                             "rows")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q [B, H, Tq, 64], k and v [B, H, Tk, 64] (may
    be strided views of [B, T, H*64] projections) → [B, H, Tq, 64], a view
    of a [B, Tq, H, 64] buffer so that merging heads is free. CPU tensors
    take `attend`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attend(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out = torch.empty(B, Tq, H, D, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = _build.library().oh_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Tq,
        Tk, strides, D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "oh_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
