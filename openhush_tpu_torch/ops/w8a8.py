"""The W8A8 encoder layer's two hand-written CUDA kernels (csrc/w8a8.cu):
the per-row int8 quantize of an activation, fused with the layer norm
before it where there is one, and the int8 x int8 product whose epilogue
folds both scales, the bias, the cast, GELU and the residual add.

Counterpart of openhush_tpu/models/whisper/model.py:_quantize_rows and
:_mm_i8 as `block_i8` uses them, with the layer norm, bias, cast, GELU and
residual around them. No Pallas kernel: the reference keeps both in XLA,
which fuses the quantize into the layer norm and GELU beside it and folds
the scales into the int8 dot; eager PyTorch fuses nothing, and these
kernels do what that fusion does.

- `quantize_rows(x, ln=None)`: x [..., D] bf16 or fp32 → (int8 levels
  [..., D], fp32 scales [...]), scale = max|x| * float32(1/127), floored at
  1e-10; with ln = (scale, bias), of layer_norm(x) rounded to x's dtype.
- `mm_w8a8(x8, xs, w, bias, gelu, residual, out_dtype)`: float(x8 @ q) *
  xs * s (+ bias) in fp32, rounded to out_dtype; then GELU ("erf" or
  "tanh") and residual + y, each in out_dtype. No options: fp32 out, the
  plain `_mm_i8`.
- `mm_w8a8_group(x8, xs, members, out_dtype)`: up to three products of one
  x8 (q, k and v), one launch, each member into its own output.

Each has a plain PyTorch version here (`*_plain`): the CPU path and the
card's yardstick. A CUDA tensor launches the kernel or raises; nothing
falls back. Refused on every device: a dtype the kernel does not take, a
non-contiguous operand, an inner width that is not a multiple of 32 (of 8
for the quantize, at most 6144), an output width not a multiple of 16, a
group of more than three members. On the card the levels must be stored
column-major (int8 wgmma's B operand is K-major, and
model.quantize_encoder_weights stores them so); the CPU's plain version
also takes row-major levels, as the reference's `_mm_i8` takes any. The
kernels have no backward: on the card a product refuses a bias or
residual that needs a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openhush_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU = {None: 0, "erf": 1, "tanh": 2}
_MAX_MEMBERS = 3                  # products a group launch takes
_MAX_ROW = 6144                   # the quantize's widest row
LN_EPS = 1e-5                     # model.layer_norm's eps
_EMPTY = (None, None, None, None, None, 0)   # a launch's unused member slot


def quantize_rows_plain(x: torch.Tensor, ln=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8, as the reference's `_quantize_rows`: x [...,
    D] → (int8 values, fp32 scales [...]), scale = max|x| *
    float32(1/127) (a reciprocal multiply), floored at 1e-10. With ln =
    (scale, bias) x is first layer-normed in fp32 and rounded to its dtype,
    as model.layer_norm does."""
    if ln is not None:
        scale, bias = ln
        x = F.layer_norm(x.float(), x.shape[-1:], scale.float(),
                         bias.float(), LN_EPS).to(x.dtype)
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) * torch.tensor(1.0 / 127.0,
                                                  dtype=torch.float32)
    safe = torch.clamp(scale, min=1e-10)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return q.to(torch.int8), safe


def mm_w8a8_plain(x8: torch.Tensor, xs: torch.Tensor, w: dict,
                  bias: torch.Tensor | None = None, gelu: str | None = None,
                  residual: torch.Tensor | None = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """torch._int_mm of x8 [..., I] and the levels, to fp32, times the row
    scales, times the column scales (left to right, as the reference's
    `_mm_i8`), + bias in fp32, cast to out_dtype; then GELU and residual +
    y in out_dtype, as `block_i8` writes them."""
    q = w["q"]
    y = torch._int_mm(x8.reshape(-1, x8.shape[-1]), q).view(
        *x8.shape[:-1], q.shape[-1]).float()
    y = y * xs[..., None] * w["s"].float()
    if bias is not None:
        y = y + bias
    y = y.to(out_dtype)
    if gelu is not None:
        y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
    return y if residual is None else residual + y


def mm_w8a8_group_plain(x8: torch.Tensor, xs: torch.Tensor, members,
                        out_dtype: torch.dtype = torch.float32) -> tuple:
    """The plain version of `mm_w8a8_group`: each member (w, bias) through
    `mm_w8a8_plain`."""
    return tuple(mm_w8a8_plain(x8, xs, w, b, out_dtype=out_dtype)
                 for w, b in members)


def _same_device(name: str, ref: torch.Tensor, *ts) -> None:
    dev, cuda = ref.get_device(), ref.is_cuda
    for t in ts:
        if t is not None and (t.get_device() != dev or t.is_cuda != cuda):
            raise ValueError(f"{name}: operands on {ref.device} and "
                             f"{t.device}")


def _check_quantize(x: torch.Tensor, ln) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_rows: x is {x.dtype}; the kernel takes "
                         f"bfloat16 or float32")
    if not x.is_contiguous():
        raise ValueError(f"quantize_rows: x {list(x.shape)} with strides "
                         f"{x.stride()} is not contiguous")
    D = x.shape[-1] if x.dim() else 0
    if D == 0 or D % 8 or D > _MAX_ROW:
        raise ValueError(f"quantize_rows: x {list(x.shape)}; the kernel takes "
                         f"rows of a multiple of 8 values, at most "
                         f"{_MAX_ROW}")
    if ln is not None:
        scale, bias = ln
        if (scale.dtype != bias.dtype or scale.dtype not in _DTYPES
                or scale.shape != (D,) or bias.shape != (D,)
                or not scale.is_contiguous() or not bias.is_contiguous()):
            raise ValueError(f"quantize_rows: the layer norm's scale and bias "
                             f"must be contiguous [{D}] of one dtype, "
                             f"bfloat16 or float32, not {scale.dtype} "
                             f"{list(scale.shape)} and {bias.dtype} "
                             f"{list(bias.shape)}")
        _same_device("quantize_rows", x, scale, bias)


def quantize_rows(x: torch.Tensor, ln=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same function as `quantize_rows_plain`: x [..., D] (bf16 or fp32,
    contiguous, D a multiple of 8 up to 6144), ln None or (scale, bias) [D]
    → (int8 [..., D], fp32 [...]). CPU tensors take the plain version; CUDA
    tensors launch the kernel once."""
    _check_quantize(x, ln)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return quantize_rows_plain(x, ln)
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    D = x.shape[-1]
    q = x.new_empty(x.shape, dtype=torch.int8)
    scale = x.new_empty(x.shape[:-1], dtype=torch.float32)
    gamma, beta = (None, None) if ln is None else ln
    ptrs = x.data_ptr() | q.data_ptr()
    if ln is not None:
        ptrs |= gamma.data_ptr() | beta.data_ptr()
    if ptrs % 16:
        raise ValueError("quantize_rows: x, the layer norm and the levels "
                         "must be 16-byte aligned")
    err = (_build._lib or _build.library()).oh_w8a8_quantize(
        x.data_ptr(), None if ln is None else gamma.data_ptr(),
        None if ln is None else beta.data_ptr(), q.data_ptr(),
        scale.data_ptr(), x.numel() // D, D, _DTYPES[x.dtype],
        0 if ln is None else _DTYPES[gamma.dtype], LN_EPS,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "oh_w8a8_quantize")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def _check_mm(x8, xs, members, out_dtype, gelu) -> None:
    """Raise on what the kernel does not take: x8, its scales, and each
    member (q, s, bias, residual) of a launch."""
    shape = x8.shape
    if x8.dtype != torch.int8 or not x8.is_contiguous():
        raise ValueError(f"mm_w8a8: x8 must be contiguous int8, not "
                         f"{x8.dtype} {list(shape)} with strides "
                         f"{x8.stride()}")
    I = shape[-1] if x8.dim() else 0
    if I == 0 or I % 32:
        raise ValueError(f"mm_w8a8: x8 {list(shape)}; the kernel takes an "
                         f"inner width that is a multiple of 32")
    if (xs.dtype != torch.float32 or xs.shape != shape[:-1]
            or not xs.is_contiguous()):
        raise ValueError(f"mm_w8a8: the row scales must be contiguous fp32 "
                         f"{list(shape[:-1])}, not {xs.dtype} "
                         f"{list(xs.shape)}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"mm_w8a8: out_dtype {out_dtype}; the kernel writes "
                         f"bfloat16 or float32")
    if gelu not in _GELU:
        raise ValueError(f"mm_w8a8: gelu {gelu!r}; None, 'erf' or 'tanh'")
    bias_dtypes = {b.dtype for _, _, b, _ in members if b is not None}
    if len(bias_dtypes) > 1:
        raise ValueError(f"mm_w8a8: the members' biases must share a dtype, "
                         f"not {sorted(map(str, bias_dtypes))}")
    for q, s, bias, res in members:
        if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != I:
            raise ValueError(f"mm_w8a8: x8 {list(shape)} x levels {q.dtype} "
                             f"{list(q.shape)}; the levels must be int8 "
                             f"[{I}, O]")
        O = q.shape[1]
        if O == 0 or O % 16:
            raise ValueError(f"mm_w8a8: levels {list(q.shape)}; the kernel "
                             f"takes an output width that is a multiple of 16")
        column_major = q.stride() == (1, I)
        if not (column_major or q.is_contiguous()):
            raise ValueError(f"mm_w8a8: the levels [{I}, {O}] with strides "
                             f"{q.stride()} are neither row- nor column-major")
        if q.is_cuda and not column_major:
            raise ValueError(f"mm_w8a8: the levels [{I}, {O}] must be stored "
                             f"column-major on the card (strides (1, {I}), "
                             f"as quantize_encoder_weights stores them), not "
                             f"{q.stride()}")
        if (s.dtype != torch.float32 or s.shape != (O,)
                or not s.is_contiguous()):
            raise ValueError(f"mm_w8a8: the scales must be contiguous fp32 "
                             f"[{O}], not {s.dtype} {list(s.shape)}")
        if bias is not None and (bias.dtype not in _DTYPES
                                 or bias.shape != (O,)
                                 or not bias.is_contiguous()):
            raise ValueError(f"mm_w8a8: the bias must be contiguous bfloat16 "
                             f"or float32 [{O}], not {bias.dtype} "
                             f"{list(bias.shape)}")
        if res is not None and (res.dtype != out_dtype
                                or res.shape != (*shape[:-1], O)
                                or not res.is_contiguous()):
            raise ValueError(f"mm_w8a8: the residual must be contiguous "
                             f"{out_dtype} {[*shape[:-1], O]}, not "
                             f"{res.dtype} {list(res.shape)}")
        _same_device("mm_w8a8", x8, xs, q, s, bias, res)


def _no_grad(*ts) -> None:
    """The kernel has no backward: on the card, refuse a bias or residual
    that needs a gradient (the plain version would carry it) rather than
    return an output cut from the graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise ValueError("mm_w8a8: the W8A8 kernel has no backward; a bias "
                         "or residual that needs a gradient runs only on "
                         "the CPU")


def _launch(x8, xs, operands, out_dtype, gelu) -> tuple:
    """One launch of the product for checked members (q, s, bias,
    residual), one to three, into fresh outputs; the C entry's unused slots
    get null pointers."""
    I = x8.shape[-1]
    lead = x8.shape[:-1]
    ys = tuple(x8.new_empty((*lead, q.shape[1]), dtype=out_dtype)
               for q, _, _, _ in operands)
    slots, ptrs = [], x8.data_ptr()
    for (q, s, b, r), y in zip(operands, ys):
        ptrs |= q.data_ptr() | (0 if r is None else r.data_ptr())
        slots += (q.data_ptr(), s.data_ptr(),
                  None if b is None else b.data_ptr(),
                  None if r is None else r.data_ptr(), y.data_ptr(),
                  q.shape[1])
    slots += _EMPTY * (_MAX_MEMBERS - len(operands))
    if ptrs % 16:
        raise ValueError("mm_w8a8: x8, the levels and the residuals must be "
                         "16-byte aligned")
    bias_bf16 = any(b is not None and b.dtype == torch.bfloat16
                    for _, _, b, _ in operands)
    err = (_build._lib or _build.library()).oh_w8a8_mm(
        x8.data_ptr(), xs.data_ptr(), *slots, len(operands),
        x8.numel() // I, I, _DTYPES[out_dtype], int(bias_bf16), _GELU[gelu],
        torch._C._cuda_getCurrentRawStream(x8.get_device()))
    _build.check(err, "oh_w8a8_mm")
    mm_w8a8.launches += 1
    return ys


def mm_w8a8(x8: torch.Tensor, xs: torch.Tensor, w: dict,
            bias: torch.Tensor | None = None, gelu: str | None = None,
            residual: torch.Tensor | None = None,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Same function as `mm_w8a8_plain`: x8 int8 [..., I] (contiguous, I a
    multiple of 32), xs fp32 [...], w {"q": int8 [I, O], "s": fp32 [O]},
    bias bf16 or fp32 [O] or None, gelu None, "erf" or "tanh", residual
    out_dtype [..., O] or None → [..., O] in out_dtype (bf16 or fp32). CPU
    tensors take the plain version; CUDA tensors launch the kernel once,
    everything after the int32 sums in its epilogue."""
    operands = ((w["q"], w["s"], bias, residual),)
    _check_mm(x8, xs, operands, out_dtype, gelu)
    if not x8.is_cuda:
        if x8.device.type == "cpu":
            return mm_w8a8_plain(x8, xs, w, bias, gelu, residual, out_dtype)
        raise ValueError(f"mm_w8a8: unsupported device {x8.device}")
    _no_grad(bias, residual)
    return _launch(x8, xs, operands, out_dtype, gelu)[0]


def mm_w8a8_group(x8: torch.Tensor, xs: torch.Tensor, members,
                  out_dtype: torch.dtype = torch.float32) -> tuple:
    """Up to three products of one x8: members [(w, bias or None), ...],
    each as `mm_w8a8` takes it (no GELU, no residual), all of x8's width →
    a tuple of their outputs [..., O_k] in out_dtype, each its own tensor.
    CPU tensors take `mm_w8a8_group_plain`; CUDA tensors launch the kernel
    once for all members (one launch counted)."""
    members = tuple(members)
    if not 1 <= len(members) <= _MAX_MEMBERS:
        raise ValueError(f"mm_w8a8_group: 1 to {_MAX_MEMBERS} members, not "
                         f"{len(members)}")
    operands = tuple((w["q"], w["s"], b, None) for w, b in members)
    _check_mm(x8, xs, operands, out_dtype, None)
    if not x8.is_cuda:
        if x8.device.type == "cpu":
            return mm_w8a8_group_plain(x8, xs, members, out_dtype)
        raise ValueError(f"mm_w8a8: unsupported device {x8.device}")
    _no_grad(*(b for _, b in members))
    return _launch(x8, xs, operands, out_dtype, None)


mm_w8a8.launches = 0
