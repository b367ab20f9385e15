"""ONNX graph → PyTorch evaluation: the aux-model import path.

Counterpart of openhush_tpu/models/onnx2jax.py. The reference runs its
auxiliary models (Silero VAD src/vad/silero.rs:54, openWakeWord
src/input/wake_word.rs:121-146, wespeaker/pyannote
src/diarization/mod.rs:266-299) through the ONNX Runtime C++ library; the
rebuild *imports* those published .onnx checkpoints instead: this module
walks the decoded graph (utils/onnx_io.py, the port's copy) and evaluates
each node with PyTorch ops on the model's device.

Evaluation keeps the reference's two kinds of value. Values derived only
from initializers, Constant nodes and inputs given as numpy (shape vectors,
slice indices, reshape targets, a sample rate) are computed with numpy on
the host and stay concrete, so the shape arithmetic of exported graphs
folds away. Everything touched by an input given as a tensor is a tensor on
the model's device; an activation never leaves the device between nodes.
The only host reads are the static places the JAX executor requires too: an
`If` condition, and the clip bounds, ranges and shapes that an op takes as
numbers.

Conv, ConvTranspose, Gemm and MatMul run in true fp32, as the reference's
run at Precision.HIGHEST: convolutions unfold their windows into fp32
matmuls (never cuDNN's TF32). LSTM and GRU are explicit loops over time in
ONNX's own gate orders (iofc; zrh), not nn.LSTM or nn.GRU. Resize computes
jax.image.resize's weight matrices (half-pixel samples, antialiased when
downsampling) and applies them as matmuls.

Unsupported ops fail loudly with the node name and op type, so a gap in
coverage is a clear error, never silent wrong numerics. The reference's
`.jitted` (a jax.jit of the same walk) has no counterpart: the port's walk
is eager PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.utils import onnx_io
from openhush_tpu_torch.utils.onnx_io import OnnxGraph, OnnxModel, OnnxNode


class UnsupportedOnnxOp(NotImplementedError):
    pass


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _all_static(vals) -> bool:
    return all(_is_static(v) for v in vals)


_ONNX_ELEM_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}
# A tensor's Cast: float64 stays float32, as JAX (64-bit mode off) has it.
_ONNX_ELEM_TORCH = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                    6: torch.int32, 7: torch.int64, 9: torch.bool,
                    10: torch.float16, 11: torch.float32}


def _int_list(v) -> list[int]:
    if torch.is_tensor(v):
        v = v.cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _item(v):
    return v.item() if torch.is_tensor(v) else np.asarray(v).item()


def _shape(v) -> tuple:
    return tuple(v.shape) if torch.is_tensor(v) else np.asarray(v).shape


def _ndim(v) -> int:
    return len(_shape(v))


def _str_attr(node: OnnxNode, name: str, default: str) -> str:
    v = node.attrs.get(name) or default
    return v.decode() if isinstance(v, bytes) else v


class _Run:
    """One evaluation: the device, and the uploads of initializer arrays
    (each initializer goes to the device once a model, not once a call)."""

    def __init__(self, device: torch.device, uploads: dict):
        self.device = device
        self._uploads = uploads

    def t(self, v) -> torch.Tensor:
        """`v` as a tensor on the device (a tensor is returned as it is)."""
        if torch.is_tensor(v):
            return v
        cached = self._uploads.get(id(v))
        if cached is not None and cached[0] is v:
            return cached[1]
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a)).to(self.device)
        if id(v) in self._uploads:          # an initializer: keep it
            self._uploads[id(v)] = (v, t)
        return t

    def f32(self, v) -> torch.Tensor:
        return self.t(v).float()


# ---------------------------------------------------------------------------
# Convolution / pooling helpers (ONNX NCHW layouts)
# ---------------------------------------------------------------------------

def _resolve_pads(attrs: dict, spatial: int, in_shape, k_shape,
                  strides, dilations) -> list[tuple[int, int]]:
    auto = attrs.get("auto_pad") or b"NOTSET"
    auto = auto.decode() if isinstance(auto, bytes) else auto
    if auto in ("NOTSET", ""):
        pads = attrs.get("pads") or [0] * (2 * spatial)
        return [(int(pads[i]), int(pads[i + spatial]))
                for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    out = []
    for i in range(spatial):
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_shape[i] // strides[i])
        pad = max(0, (out_dim - 1) * strides[i] + eff_k - in_shape[i])
        if auto == "SAME_UPPER":
            out.append((pad // 2, pad - pad // 2))
        else:  # SAME_LOWER
            out.append((pad - pad // 2, pad // 2))
    return out


def _windows(x: torch.Tensor, k, strides, pads, dilations,
             value: float = 0.0) -> torch.Tensor:
    """[N, C, *S] → [N, C, *O, *k]: every window of every spatial dim,
    after padding with `value` ((lo, hi) a dim; negative crops)."""
    spatial = x.dim() - 2
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
              value=value)
    for i in range(spatial):
        eff = (k[i] - 1) * dilations[i] + 1
        x = x.unfold(2 + i, eff, strides[i])[..., ::dilations[i]]
    return x


def conv_fp32(x: torch.Tensor, w: torch.Tensor, strides, pads, dilations,
              groups: int = 1) -> torch.Tensor:
    """N-d grouped convolution (cross-correlation, ONNX/NCHW): x
    [N, C, *S], w [O, C/groups, *k], pads [(lo, hi)] per spatial dim →
    [N, O, *S']. The windows are unfolded and multiplied in true fp32
    (never cuDNN's TF32)."""
    spatial = x.dim() - 2
    k = list(w.shape[2:])
    cols = _windows(x, k, strides, pads, dilations)   # [N, C, *O, *k]
    N, C = cols.shape[:2]
    out_sp = list(cols.shape[2:2 + spatial])
    O, G = w.shape[0], groups
    ck = (C // G) * math.prod(k)
    cols = cols.reshape(N, G, C // G, *out_sp, *k)
    perm = ([0, 1] + list(range(3, 3 + spatial)) + [2]
            + list(range(3 + spatial, 3 + 2 * spatial)))
    cols = cols.permute(perm).reshape(N, G, math.prod(out_sp), ck)
    wm = w.reshape(G, O // G, ck).transpose(1, 2)      # [G, ck, O/G]
    out = torch.matmul(cols, wm)                        # [N, G, P, O/G]
    return out.permute(0, 1, 3, 2).reshape(N, O, *out_sp)


def _op_conv(c: _Run, node: OnnxNode, vals: list):
    x, w = c.f32(vals[0]), c.f32(vals[1])
    spatial = x.dim() - 2
    strides = _int_list(node.attrs.get("strides") or [1] * spatial)
    dilations = _int_list(node.attrs.get("dilations") or [1] * spatial)
    group = int(node.attrs.get("group") or 1)
    pads = _resolve_pads(node.attrs, spatial, x.shape[2:], w.shape[2:],
                         strides, dilations)
    out = conv_fp32(x, w, strides, pads, dilations, group)
    if len(vals) > 2 and vals[2] is not None:
        out = out + c.t(vals[2]).reshape((1, -1) + (1,) * spatial)
    return out


def _op_conv_transpose(c: _Run, node: OnnxNode, vals: list):
    """The reference's lax.conv_transpose(transpose_kernel=True): the input
    dilated by the strides, padded k-1-pad, and convolved with the kernel
    flipped and its in/out channels swapped."""
    x, w = c.f32(vals[0]), c.f32(vals[1])          # w [C_in, C_out/g, k...]
    spatial = x.dim() - 2
    if int(node.attrs.get("group") or 1) != 1:
        raise UnsupportedOnnxOp("ConvTranspose with group>1")
    strides = _int_list(node.attrs.get("strides") or [1] * spatial)
    pads = node.attrs.get("pads") or [0] * (2 * spatial)
    k = list(w.shape[2:])
    padding = [(k[i] - 1 - int(pads[i]), k[i] - 1 - int(pads[i + spatial]))
               for i in range(spatial)]
    sizes = [(n - 1) * s + 1 for n, s in zip(x.shape[2:], strides)]
    up = x.new_zeros(*x.shape[:2], *sizes)
    up[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                          for s in strides)] = x
    wt = w.flip(list(range(2, 2 + spatial))).transpose(0, 1)
    out = conv_fp32(up, wt, [1] * spatial, padding, [1] * spatial)
    if len(vals) > 2 and vals[2] is not None:
        out = out + c.t(vals[2]).reshape((1, -1) + (1,) * spatial)
    return out


def _pool(c: _Run, node: OnnxNode, x, kind: str):
    x = c.t(x)
    spatial = x.dim() - 2
    k = _int_list(node.attrs["kernel_shape"])
    strides = _int_list(node.attrs.get("strides") or [1] * spatial)
    dilations = _int_list(node.attrs.get("dilations") or [1] * spatial)
    pads = _resolve_pads(node.attrs, spatial, x.shape[2:], k,
                         strides, dilations)
    win_dims = tuple(range(-spatial, 0))
    if kind == "max":
        init = (-math.inf if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        return _windows(x, k, strides, pads, dilations, init).amax(win_dims)
    total = _windows(x.float(), k, strides, pads, dilations).sum(win_dims)
    if int(node.attrs.get("count_include_pad") or 0):
        return total / float(np.prod(k))
    ones = torch.ones(x.shape, dtype=torch.float32, device=x.device)
    counts = _windows(ones, k, strides, pads, dilations).sum(win_dims)
    return total / counts


# ---------------------------------------------------------------------------
# Recurrent ops (ONNX LSTM / GRU semantics incl. gate orders)
# ---------------------------------------------------------------------------

def _rnn_directions(node: OnnxNode) -> list[str]:
    d = _str_attr(node, "direction", "forward")
    return {"forward": ["fwd"], "reverse": ["rev"],
            "bidirectional": ["fwd", "rev"]}[d]


def _rnn_state(c: _Run, vals: list, i: int, D: int, B: int, H: int):
    if len(vals) > i and vals[i] is not None:
        return c.f32(vals[i])
    return torch.zeros(D, B, H, device=c.device)


def _op_lstm(c: _Run, node: OnnxNode, vals: list):
    x = c.f32(vals[0])                                 # [T, B, I]
    W = c.f32(vals[1])                                 # [D, 4H, I]  (iofc)
    R = c.f32(vals[2])                                 # [D, 4H, H]
    D, fourH, _ = W.shape
    H = fourH // 4
    B = x.shape[1]
    Bias = (c.f32(vals[3]) if len(vals) > 3 and vals[3] is not None
            else torch.zeros(D, 8 * H, device=x.device))
    h0, c0 = _rnn_state(c, vals, 5, D, B, H), _rnn_state(c, vals, 6, D, B, H)

    def run_dir(d: int, reverse: bool):
        Wd, Rd = W[d].T, R[d].T                        # [I, 4H], [H, 4H]
        b = Bias[d, :4 * H] + Bias[d, 4 * H:]
        xs = torch.flip(x, [0]) if reverse else x
        xw = xs @ Wd + b                               # [T, B, 4H]
        h, cc, ys = h0[d], c0[d], []
        for xt in xw:
            g = xt + h @ Rd
            i = torch.sigmoid(g[..., :H])
            o = torch.sigmoid(g[..., H:2 * H])
            f = torch.sigmoid(g[..., 2 * H:3 * H])
            cand = torch.tanh(g[..., 3 * H:])
            cc = f * cc + i * cand
            h = o * torch.tanh(cc)
            ys.append(h)
        ys = torch.stack(ys)
        return (torch.flip(ys, [0]) if reverse else ys), h, cc

    outs = [run_dir(i, d == "rev")
            for i, d in enumerate(_rnn_directions(node))]
    Y = torch.stack([o[0] for o in outs], dim=1)       # [T, D, B, H]
    return (Y, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def _op_gru(c: _Run, node: OnnxNode, vals: list):
    x = c.f32(vals[0])                                 # [T, B, I]
    W = c.f32(vals[1])                                 # [D, 3H, I]  (zrh)
    R = c.f32(vals[2])
    D, threeH, _ = W.shape
    H = threeH // 3
    B = x.shape[1]
    Bias = (c.f32(vals[3]) if len(vals) > 3 and vals[3] is not None
            else torch.zeros(D, 6 * H, device=x.device))
    h0 = _rnn_state(c, vals, 5, D, B, H)
    lbr = int(node.attrs.get("linear_before_reset") or 0)

    def run_dir(d: int, reverse: bool):
        Wd, Rd = W[d].T, R[d].T
        wb, rb = Bias[d, :3 * H], Bias[d, 3 * H:]
        xs = torch.flip(x, [0]) if reverse else x
        xw = xs @ Wd + wb
        h, ys = h0[d], []
        for xt in xw:
            hr = h @ Rd
            z = torch.sigmoid(xt[..., :H] + hr[..., :H] + rb[:H])
            r = torch.sigmoid(xt[..., H:2 * H] + hr[..., H:2 * H]
                              + rb[H:2 * H])
            if lbr:
                n = torch.tanh(xt[..., 2 * H:]
                               + r * (hr[..., 2 * H:] + rb[2 * H:]))
            else:
                n = torch.tanh(xt[..., 2 * H:]
                               + (r * h) @ Rd[:, 2 * H:] + rb[2 * H:])
            h = (1 - z) * n + z * h
            ys.append(h)
        ys = torch.stack(ys)
        return (torch.flip(ys, [0]) if reverse else ys), h

    outs = [run_dir(i, d == "rev")
            for i, d in enumerate(_rnn_directions(node))]
    return (torch.stack([o[0] for o in outs], dim=1),
            torch.stack([o[1] for o in outs]))


# ---------------------------------------------------------------------------
# Node dispatch
# ---------------------------------------------------------------------------

def _unary(fn_np, fn_torch=None):
    def op(c, node, vals):
        v = vals[0]
        if _is_static(v):
            return fn_np(np.asarray(v))
        return (fn_torch or fn_np)(v)
    return op


def _binary(fn):
    def op(c, node, vals):
        a, b = vals[0], vals[1]
        if _all_static(vals[:2]):
            return fn(np.asarray(a), np.asarray(b))
        return fn(c.t(a), c.t(b))
    return op


def _fold(np_fn, torch_fn):
    def op(c, node, vals):
        if _all_static(vals):
            return functools.reduce(np_fn, vals)
        return functools.reduce(torch_fn, [c.t(v) for v in vals])
    return op


def _is_float(v) -> bool:
    return (v.is_floating_point() if torch.is_tensor(v)
            else np.asarray(v).dtype.kind == "f")


def _div(a, b):
    return a / b if _is_float(a) or _is_float(b) else a // b


def _axes_arg(node: OnnxNode, vals: list, idx: int = 1):
    """Axes come as an attribute (old opsets) or trailing input (new)."""
    if "axes" in node.attrs and node.attrs["axes"] is not None:
        return _int_list(node.attrs["axes"])
    if len(vals) > idx and vals[idx] is not None:
        return _int_list(vals[idx])
    return None


def _torch_prod(x, axis, keepdims):
    for a in sorted((a % x.dim() for a in axis), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _torch_reduce(fn):
    def op(x, axis, keepdims):
        return fn(x, dim=axis, keepdim=keepdims)
    return op


def _reduce(fn_np, fn_torch):
    def op(c, node, vals):
        axes = _axes_arg(node, vals)
        keep = bool(int(node.attrs.get("keepdims", 1)))
        axes_t = tuple(axes) if axes is not None else None
        if (axes_t is None and
                int(node.attrs.get("noop_with_empty_axes") or 0)):
            return vals[0]
        x = vals[0]
        if _is_static(x):
            return fn_np(np.asarray(x), axis=axes_t, keepdims=keep)
        if axes_t is None:
            axes_t = tuple(range(x.dim()))
        return fn_torch(x, axes_t, keep)
    return op


def _torch_mean(x, axis, keepdims):
    x = x if x.is_floating_point() else x.float()
    return torch.mean(x, dim=axis, keepdim=keepdims)


def _slice_tensor(x: torch.Tensor, ax: int, st: int, en, sp: int):
    if sp > 0:
        sl = [slice(None)] * x.dim()
        sl[ax] = slice(st, en, sp)
        return x[tuple(sl)]
    # torch takes no negative step: the indices numpy's slice would visit.
    idx = range(*slice(st, en, sp).indices(x.shape[ax]))
    return x.index_select(ax, torch.tensor(list(idx), dtype=torch.long,
                                           device=x.device))


def _op_slice(c, node: OnnxNode, vals: list):
    x = vals[0]
    if "starts" in node.attrs:                    # opset < 10
        starts = _int_list(node.attrs["starts"])
        ends = _int_list(node.attrs["ends"])
        axes = _int_list(node.attrs.get("axes")
                         or range(len(starts)))
        steps = [1] * len(starts)
    else:
        starts = _int_list(vals[1])
        ends = _int_list(vals[2])
        axes = (_int_list(vals[3]) if len(vals) > 3 and vals[3] is not None
                else list(range(len(starts))))
        steps = (_int_list(vals[4]) if len(vals) > 4 and vals[4] is not None
                 else [1] * len(starts))
    nd = _ndim(x)
    if _is_static(x):
        sl = [slice(None)] * nd
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            # ONNX clamps out-of-range ends (INT64_MAX conventions)
            sl[ax % nd] = slice(st, None if en >= 2 ** 31 else en, sp)
        return np.asarray(x)[tuple(sl)]
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        x = _slice_tensor(x, ax % nd, st, None if en >= 2 ** 31 else en, sp)
    return x


def _op_gemm(c, node: OnnxNode, vals: list):
    a, b = c.f32(vals[0]), c.f32(vals[1])
    if int(node.attrs.get("transA") or 0):
        a = a.T
    if int(node.attrs.get("transB") or 0):
        b = b.T
    alpha = float(node.attrs.get("alpha") or 1.0)
    beta = float(node.attrs.get("beta") or 1.0)
    out = alpha * (a @ b)
    if len(vals) > 2 and vals[2] is not None:
        out = out + beta * c.t(vals[2])
    return out


def _op_batchnorm(c, node: OnnxNode, vals: list):
    x = c.t(vals[0])
    scale, bias, mean, var = (c.f32(v) for v in vals[1:5])
    eps = float(node.attrs.get("epsilon") or 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) \
        + bias.reshape(shape)


def _op_layernorm(c, node: OnnxNode, vals: list):
    x = c.f32(vals[0])
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon") or 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mean = torch.mean(x, axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    out = out * c.t(vals[1])
    if len(vals) > 2 and vals[2] is not None:
        out = out + c.t(vals[2])
    return out


def _op_instancenorm(c, node: OnnxNode, vals: list):
    x = c.f32(vals[0])
    eps = float(node.attrs.get("epsilon") or 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, axes, keepdim=True)
    var = torch.mean((x - mean) ** 2, axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + eps)
            * c.t(vals[1]).reshape(shape) + c.t(vals[2]).reshape(shape))


def _op_pad(c, node: OnnxNode, vals: list):
    x = vals[0]
    if "pads" in node.attrs:
        pads = _int_list(node.attrs["pads"])
        cval = float(node.attrs.get("value") or 0.0)
    else:
        pads = _int_list(vals[1])
        cval = (float(np.asarray(_item(vals[2])))
                if len(vals) > 2 and vals[2] is not None else 0.0)
    mode = _str_attr(node, "mode", "constant")
    nd = _ndim(x)
    pairs = [(pads[i], pads[i + nd]) for i in range(nd)]
    if _is_static(x):
        if mode == "constant":
            return np.pad(x, pairs, constant_values=cval)
        return np.pad(x, pairs, mode={"reflect": "reflect",
                                      "edge": "edge"}[mode])
    if mode == "constant":
        return F.pad(x, [p for lo_hi in reversed(pairs) for p in lo_hi],
                     value=cval)
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:       # numpy's own index map for this mode
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = x.index_select(ax, torch.from_numpy(idx).to(x.device))
    return x


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """jax.image's compute_weight_mat for scale n/m, no translation,
    antialiased: [m, n] fp32."""
    dt = np.float32
    inv_scale = dt(1.0) / dt(n / m)
    kernel_scale = max(inv_scale, dt(1.0))
    sample_f = (np.arange(n, dtype=dt) + dt(0.5)) * inv_scale - dt(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=dt)[:, None]) \
        / kernel_scale
    w = kernel(x).astype(dt)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(dt)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(dt)


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _op_resize(c, node: OnnxNode, vals: list):
    """jax.image.resize (the reference's): nearest samples floor((i + 0.5)
    · m / n); linear and cubic contract each resized dim with its weight
    matrix."""
    x = c.t(vals[0])
    mode = _str_attr(node, "mode", "nearest")
    sizes = None
    if len(vals) > 3 and vals[3] is not None:
        sizes = _int_list(vals[3])
    elif len(vals) > 2 and vals[2] is not None:
        s = vals[2]
        scales = np.asarray(s.cpu() if torch.is_tensor(s) else s,
                            np.float64).reshape(-1)
        if scales.size:
            sizes = [int(round(s * d)) for s, d in zip(scales, x.shape)]
    if sizes is None:
        return x
    kernel = {"nearest": None, "linear": _triangle,
              "cubic": _keys_cubic}[mode]
    if kernel is not None and not x.is_floating_point():
        x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, sizes)):
        if m == n:
            continue
        if kernel is None:
            offs = (np.arange(n, dtype=np.float32) + 0.5) * m / n
            idx = np.floor(offs.astype(np.float32)).astype(np.int64)
            x = x.index_select(d, torch.from_numpy(idx).to(x.device))
        else:
            w = torch.from_numpy(_resize_weights(m, n, kernel)).to(
                x.device, x.dtype)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _clip(c, n, v):
    lo = (_item(v[1]) if len(v) > 1 and v[1] is not None
          else n.attrs.get("min"))
    hi = (_item(v[2]) if len(v) > 2 and v[2] is not None
          else n.attrs.get("max"))
    if _is_static(v[0]):
        return np.clip(v[0], lo, hi)
    return torch.clamp(v[0], lo, hi)


def _cast(c, n, v):
    to = int(n.attrs["to"])
    if _is_static(v[0]):
        return np.asarray(v[0]).astype(_ONNX_ELEM_NP[to])
    return v[0].to(_ONNX_ELEM_TORCH[to])


def _where(c, n, v):
    if _all_static(v):
        return np.where(v[0], v[1], v[2])
    return torch.where(c.t(v[0]).bool(), c.t(v[1]), c.t(v[2]))


def _global_pool(reduce):
    def op(c, n, v):
        x = c.t(v[0])
        return reduce(x, tuple(range(2, x.dim())), True)
    return op


_OPS: dict[str, Callable[[_Run, OnnxNode, list], Any]] = {
    "Add": _binary(lambda a, b: a + b),
    "Sub": _binary(lambda a, b: a - b),
    "Mul": _binary(lambda a, b: a * b),
    "Div": _binary(_div),
    "Pow": _binary(lambda a, b: a ** b),
    "Min": _fold(np.minimum, torch.minimum),
    "Max": _fold(np.maximum, torch.maximum),
    "Sqrt": _unary(np.sqrt, torch.sqrt),
    "Exp": _unary(np.exp, torch.exp),
    "Log": _unary(np.log, torch.log),
    "Neg": _unary(lambda x: -x),
    "Abs": _unary(np.abs, torch.abs),
    "Floor": _unary(np.floor, torch.floor),
    "Ceil": _unary(np.ceil, torch.ceil),
    "Round": _unary(np.round, torch.round),
    "Reciprocal": _unary(lambda x: 1.0 / x, torch.reciprocal),
    "Erf": _unary(lambda x: np.vectorize(math.erf)(x).astype(np.float32),
                  torch.erf),
    "Relu": _unary(lambda x: np.maximum(x, 0), torch.relu),
    "Sigmoid": _unary(lambda x: 1 / (1 + np.exp(-x)), torch.sigmoid),
    "Tanh": _unary(np.tanh, torch.tanh),
    "Softplus": _unary(lambda x: np.log1p(np.exp(x)), _softplus),
    "Identity": lambda c, n, v: v[0],
    "Dropout": lambda c, n, v: v[0],
    "Not": _unary(np.logical_not, torch.logical_not),
    "And": _binary(lambda a, b: a & b),
    "Or": _binary(lambda a, b: a | b),
    "Equal": _binary(lambda a, b: a == b),
    "Greater": _binary(lambda a, b: a > b),
    "GreaterOrEqual": _binary(lambda a, b: a >= b),
    "Less": _binary(lambda a, b: a < b),
    "LessOrEqual": _binary(lambda a, b: a <= b),
    "Where": _where,
    "MatMul": lambda c, n, v: torch.matmul(c.f32(v[0]), c.f32(v[1])),
    "Gemm": _op_gemm,
    "Conv": _op_conv,
    "ConvTranspose": _op_conv_transpose,
    "BatchNormalization": _op_batchnorm,
    "LayerNormalization": _op_layernorm,
    "InstanceNormalization": _op_instancenorm,
    "LSTM": _op_lstm,
    "GRU": _op_gru,
    "MaxPool": lambda c, n, v: _pool(c, n, v[0], "max"),
    "AveragePool": lambda c, n, v: _pool(c, n, v[0], "avg"),
    "GlobalAveragePool": _global_pool(
        lambda x, d, k: torch.mean(x, dim=d, keepdim=k)),
    "GlobalMaxPool": _global_pool(
        lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
    "Softmax": lambda c, n, v: torch.softmax(
        c.f32(v[0]), dim=int(n.attrs.get("axis", -1))),
    "LogSoftmax": lambda c, n, v: torch.log_softmax(
        c.f32(v[0]), dim=int(n.attrs.get("axis", -1))),
    "LeakyRelu": lambda c, n, v: F.leaky_relu(
        c.t(v[0]), float(n.attrs.get("alpha") or 0.01)),
    "PRelu": lambda c, n, v: torch.where(c.t(v[0]) >= 0, c.t(v[0]),
                                         c.t(v[1]) * c.t(v[0])),
    "Elu": lambda c, n, v: F.elu(c.t(v[0]),
                                 float(n.attrs.get("alpha") or 1.0)),
    "HardSigmoid": lambda c, n, v: torch.clamp(
        float(n.attrs.get("alpha") or 0.2) * c.t(v[0])
        + float(n.attrs.get("beta") or 0.5), 0.0, 1.0),
    "ReduceMean": _reduce(np.mean, _torch_mean),
    "ReduceSum": _reduce(np.sum, _torch_reduce(torch.sum)),
    "ReduceMax": _reduce(np.max, _torch_reduce(torch.amax)),
    "ReduceMin": _reduce(np.min, _torch_reduce(torch.amin)),
    "ReduceProd": _reduce(np.prod, _torch_prod),
    "ReduceL2": _reduce(lambda x, axis, keepdims:
                        np.sqrt(np.sum(x * x, axis=axis, keepdims=keepdims)),
                        lambda x, axis, keepdims:
                        torch.sqrt(torch.sum(x * x, dim=axis,
                                             keepdim=keepdims))),
    "ArgMax": lambda c, n, v: (
        np.argmax(v[0], axis=int(n.attrs.get("axis", 0)))
        if _is_static(v[0])
        else torch.argmax(v[0], dim=int(n.attrs.get("axis", 0)))),
    "Slice": _op_slice,
    "Pad": _op_pad,
    "Resize": _op_resize,
    "Clip": _clip,
    "Cast": _cast,
}


def _op_shape(c, node, vals):
    shape = _shape(vals[0])
    start = int(node.attrs.get("start") or 0)
    end = node.attrs.get("end")
    sl = shape[start: int(end) if end is not None else None]
    return np.asarray(sl, np.int64)


def _op_reshape(c, node, vals):
    target = _int_list(vals[1])
    x = vals[0]
    in_shape = _shape(x)
    if int(node.attrs.get("allowzero") or 0) == 0:
        target = [in_shape[i] if t == 0 else t
                  for i, t in enumerate(target)]
    if _is_static(x):
        return np.reshape(x, target)
    return torch.reshape(x, target)


def _op_concat(c, node, vals):
    axis = int(node.attrs.get("axis", 0))
    if _all_static(vals):
        return np.concatenate([np.asarray(v) for v in vals], axis=axis)
    return torch.cat([c.t(v) for v in vals], dim=axis)


def _op_gather(c, node, vals):
    axis = int(node.attrs.get("axis", 0))
    x, idx = vals[0], vals[1]
    if _all_static(vals[:2]):
        return np.take(np.asarray(x), np.asarray(idx, np.int64), axis=axis)
    x, idx = c.t(x), c.t(idx).long()
    axis %= x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


def _op_squeeze(c, node, vals):
    axes = _axes_arg(node, vals)
    x = vals[0]
    nd = _ndim(x)
    if _is_static(x):
        return np.squeeze(x, axis=None if axes is None
                          else tuple(a % nd for a in axes))
    if axes is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(a % nd for a in axes))


def _op_unsqueeze(c, node, vals):
    axes = sorted(_axes_arg(node, vals) or [0])
    x = vals[0]
    for a in axes:
        x = np.expand_dims(x, a) if _is_static(x) else torch.unsqueeze(x, a)
    return x


def _op_transpose(c, node, vals):
    x = vals[0]
    perm = node.attrs.get("perm")
    if _is_static(x):
        return np.transpose(x, perm if perm is None else _int_list(perm))
    perm = (list(reversed(range(x.dim()))) if perm is None
            else _int_list(perm))
    return x.permute(perm)


def _op_flatten(c, node, vals):
    x = vals[0]
    axis = int(node.attrs.get("axis", 1))
    shape = _shape(x)
    lead = int(np.prod(shape[:axis])) if axis else 1
    if _is_static(x):
        return np.reshape(x, (lead, -1))
    return torch.reshape(x, (lead, -1))


def _op_expand(c, node, vals):
    target = _int_list(vals[1])
    x = vals[0]
    shape = _shape(x)
    # ONNX Expand uses numpy broadcasting; dims of 1 in target keep input
    ndiff = len(target) - len(shape)
    full = list(target)
    for i, s in enumerate(shape):
        t = full[ndiff + i]
        full[ndiff + i] = s if t == 1 else t
    if _is_static(x):
        return np.broadcast_to(x, tuple(full))
    return torch.broadcast_to(x, tuple(full))


def _op_tile(c, node, vals):
    reps = _int_list(vals[1])
    if _is_static(vals[0]):
        return np.tile(vals[0], reps)
    return torch.tile(vals[0], reps)


def _op_split(c, node, vals):
    x = vals[0]
    axis = int(node.attrs.get("axis", 0))
    shape = _shape(x)
    if "split" in node.attrs and node.attrs["split"] is not None:
        sizes = _int_list(node.attrs["split"])
    elif len(vals) > 1 and vals[1] is not None:
        sizes = _int_list(vals[1])
    else:
        n = int(node.attrs.get("num_outputs") or len(node.outputs))
        base = shape[axis] // n
        sizes = [base] * n
        sizes[-1] += shape[axis] - base * n
    offs = np.cumsum([0] + sizes)
    out = []
    for i in range(len(sizes)):
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(int(offs[i]), int(offs[i + 1]))
        out.append(x[tuple(sl)])
    return tuple(out)


def _op_constant_of_shape(c, node, vals):
    shape = _int_list(vals[0])
    fill = node.attrs.get("value")
    if fill is None:
        return np.zeros(shape, np.float32)
    fill = np.asarray(fill).reshape(-1)
    return np.full(shape, fill[0], fill.dtype)


def _op_range(c, node, vals):
    s, e, d = (_item(v) for v in vals[:3])
    return np.arange(s, e, d)


_OPS.update({
    "Shape": _op_shape,
    "Size": lambda c, n, v: np.asarray(int(np.prod(_shape(v[0]))), np.int64),
    "Reshape": _op_reshape,
    "Concat": _op_concat,
    "Gather": _op_gather,
    "Squeeze": _op_squeeze,
    "Unsqueeze": _op_unsqueeze,
    "Transpose": _op_transpose,
    "Flatten": _op_flatten,
    "Expand": _op_expand,
    "Tile": _op_tile,
    "Split": _op_split,
    "ConstantOfShape": _op_constant_of_shape,
    "Range": _op_range,
})


# ---------------------------------------------------------------------------
# Graph evaluation
# ---------------------------------------------------------------------------

def _eval_graph(c: _Run, graph: OnnxGraph, env: dict[str, Any]) -> list:
    for node in graph.nodes:
        if node.op_type == "Constant":
            val = node.attrs.get("value")
            if val is None:
                for k in ("value_float", "value_int"):
                    if k in node.attrs:
                        val = np.asarray(node.attrs[k])
                if "value_ints" in node.attrs:
                    val = np.asarray(node.attrs["value_ints"], np.int64)
                if "value_floats" in node.attrs:
                    val = np.asarray(node.attrs["value_floats"], np.float32)
            env[node.outputs[0]] = val
            continue
        if node.op_type == "If":
            cond = env[node.inputs[0]]
            if not _is_static(cond):
                raise UnsupportedOnnxOp(
                    f"If node '{node.name}' with traced condition")
            branch = (node.attrs["then_branch"] if np.asarray(cond).item()
                      else node.attrs["else_branch"])
            sub_env = dict(env)
            sub_env.update(branch.initializers)
            results = _eval_graph(c, branch, sub_env)
            for out_name, res in zip(node.outputs, results):
                env[out_name] = res
            continue
        fn = _OPS.get(node.op_type)
        if fn is None:
            raise UnsupportedOnnxOp(
                f"op '{node.op_type}' (node '{node.name}') is not in the "
                f"importer's op set; supported: {sorted(_OPS)}")
        vals = [env.get(name) if name else None for name in node.inputs]
        result = fn(c, node, vals)
        if isinstance(result, tuple):
            for out_name, res in zip(node.outputs, result):
                if out_name:
                    env[out_name] = res
        else:
            env[node.outputs[0]] = result
    return [env[vi.name] for vi in graph.outputs]


def _initializer_arrays(graph: OnnxGraph):
    yield from graph.initializers.values()
    for node in graph.nodes:
        for v in node.attrs.values():
            if isinstance(v, OnnxGraph):
                yield from _initializer_arrays(v)


class OnnxTorchModel:
    """A decoded ONNX model evaluated with PyTorch ops on `device` (CUDA
    unless the caller asks for the CPU).

    `model(x, y, ...)` runs the graph (inputs in graph-input order,
    initializers excluded); keyword arguments name inputs. An input given
    as a tensor is traced on the device (move it there first); one given as
    numpy stays static, as in the reference (a sample rate that an `If`
    reads). Outputs are tensors on the device. Each initializer is copied
    to the device once, at its first use."""

    def __init__(self, model: OnnxModel, device=None):
        self.model = model
        self.device = resolve_device(device)
        graph = model.graph
        init_names = set(graph.initializers)
        self.input_names = [vi.name for vi in graph.inputs
                            if vi.name not in init_names]
        self.output_names = [vi.name for vi in graph.outputs]
        self._uploads = {id(a): None for a in _initializer_arrays(graph)}

    @classmethod
    def load(cls, path: str, device=None) -> "OnnxTorchModel":
        return cls(onnx_io.load(path), device)

    def __call__(self, *args, **kwargs):
        env: dict[str, Any] = dict(self.model.graph.initializers)
        if kwargs:
            env.update(kwargs)
        for name, val in zip(self.input_names, args):
            env[name] = val
        missing = [n for n in self.input_names if n not in env]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        run = _Run(self.device, self._uploads)
        outs = [run.t(o) for o in _eval_graph(run, self.model.graph, env)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    # Persistence: the original .onnx bytes are the canonical format; a
    # converted copy is written next to the npz weights for provenance.
    def save(self, path: str) -> None:
        onnx_io.save(self.model, path)
