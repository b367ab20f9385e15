"""The int8 decoder weights' product on a hand-written CUDA kernel
(csrc/w8a16.cu): y = to_x_dtype((x @ q) * s) (+ bias, rounded again).

Counterpart of openhush_tpu/models/whisper/model.py:_mm for an int8 weight
{"q": int8 [I, O], "s": fp32 [O]}: the reference's dot with
preferred_element_type=f32, which XLA fuses with the levels' convert. No
Pallas kernel: the kernel reads the levels once, as int8, and widens them in
registers, where the plain version (`mm_w8a16_plain`, the CPU path and the
card's yardstick) writes a copy of them in x's dtype first.

The wrapper refuses, on every device, what the kernel does not take: x
neither bf16 nor fp32, a non-contiguous x, I or O not a multiple of 16, q
not int8 [I, O] contiguous, s not fp32 [O], a bias not x's dtype [O]. So a
CPU run shows what the card would refuse.

`mm_w8a16_group` runs up to three products of one x (q, k and v of a
decoder layer; the cross-KV's xk and xv) in one launch, each member into
its own output. On the card with grad enabled and an input that needs a
gradient, `mm_w8a16` goes through an autograd Function whose backward is
plain PyTorch (the reference's gradient is an XLA dot); inference launches
directly.
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_MEMBERS = 3                  # products a group launch takes
_U32 = 2.0 ** -24                 # fp32's unit roundoff
_EMPTY = (None, None, None, None, 0)  # a launch's unused member slot


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., I] @ w [I, O] of x's dtype with fp32 sums: an fp32 x as it
    is; a bf16 x on the card through torch.mm's fp32 output, so nothing
    rounds to bf16; on the CPU in fp32. The result is fp32."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32
                        ).view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def mm_w8a16_plain(x: torch.Tensor, w: dict,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., I] @ the levels with fp32 sums (`matmul_f32` on the levels
    cast to x's dtype), times the scales in fp32, cast to x's dtype, then +
    bias in x's dtype."""
    y = (matmul_f32(x, w["q"].to(x.dtype)) * w["s"].float()).to(x.dtype)
    return y if bias is None else y + bias


def mm_w8a16_group_plain(x: torch.Tensor, members) -> tuple:
    """The plain version of `mm_w8a16_group`: each member (w, bias) through
    `mm_w8a16_plain`."""
    return tuple(mm_w8a16_plain(x, w, b) for w, b in members)


def _check(x: torch.Tensor, members) -> None:
    """Raise on what the kernel does not take, for x and each member (q, s,
    bias) of a launch: one pass, x's properties read once. On the decode
    path this runs 192 times a large-v3 decoder call."""
    shape = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"mm_w8a16: x is {x.dtype}; the kernel takes "
                         f"bfloat16 or float32")
    if not x.is_contiguous():
        raise ValueError(f"mm_w8a16: x {list(shape)} with strides "
                         f"{x.stride()} is not contiguous")
    dev, cuda = x.get_device(), x.is_cuda
    for q, s, bias in members:
        qshape = q.shape
        if len(qshape) != 2:
            raise ValueError(f"mm_w8a16: the levels must be [I, O], not "
                             f"{list(qshape)}")
        I, O = qshape
        if (not shape or shape[-1] != I or I % 16 or O % 16 or I == 0
                or O == 0):
            raise ValueError(f"mm_w8a16: x {list(shape)} x levels "
                             f"{list(qshape)}; the kernel takes I and O that "
                             f"are multiples of 16")
        if q.dtype != torch.int8 or not q.is_contiguous():
            raise ValueError(f"mm_w8a16: the levels must be contiguous int8 "
                             f"[{I}, {O}], not {q.dtype} with strides "
                             f"{q.stride()}")
        if (s.dtype != torch.float32 or s.shape != (O,)
                or not s.is_contiguous()):
            raise ValueError(f"mm_w8a16: the scales must be contiguous fp32 "
                             f"[{O}], not {s.dtype} {list(s.shape)}")
        if bias is not None:
            if (bias.dtype != x.dtype or bias.shape != (O,)
                    or not bias.is_contiguous()):
                raise ValueError(f"mm_w8a16: the bias must be contiguous "
                                 f"{x.dtype} [{O}], not {bias.dtype} "
                                 f"{list(bias.shape)}")
            if bias.get_device() != dev or bias.is_cuda != cuda:
                raise ValueError(f"mm_w8a16: x on {x.device}, the bias on "
                                 f"{bias.device}")
        if (q.get_device() != dev or s.get_device() != dev
                or q.is_cuda != cuda or s.is_cuda != cuda):
            raise ValueError(f"mm_w8a16: x on {x.device}, the levels on "
                             f"{q.device}, the scales on {s.device}")


def _launch(x: torch.Tensor, operands) -> tuple:
    """One launch of the kernel for checked members (q, s, bias) of x, one
    to three, into fresh outputs; the C entry's unused slots get null
    pointers. The raw stream handle: torch.cuda.current_stream() builds a
    Stream object, ~7 us of host time on the card's machine, for each of a
    large-v3 decoder call's 192 launches."""
    I = x.shape[-1]
    lead = x.shape[:-1]
    ys = tuple(x.new_empty((*lead, q.shape[1])) for q, _, _ in operands)
    slots, ptrs = [], x.data_ptr()
    for (q, s, b), y in zip(operands, ys):
        qp, yp = q.data_ptr(), y.data_ptr()
        ptrs |= qp | yp
        slots += (qp, s.data_ptr(), None if b is None else b.data_ptr(), yp,
                  q.shape[1])
    slots += _EMPTY * (_MAX_MEMBERS - len(operands))
    if ptrs % 16:
        raise ValueError("mm_w8a16: x, the levels and the outputs must be "
                         "16-byte aligned")
    err = (_build._lib or _build.library()).oh_w8a16_group(
        x.data_ptr(), *slots, len(operands), x.numel() // I, I,
        _DTYPES[x.dtype], torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "oh_w8a16_group")
    mm_w8a16.launches += 1
    return ys


class _W8A16(torch.autograd.Function):
    """The kernel's product with a gradient: forward launches the kernel,
    backward is plain PyTorch, as `jax.grad` of the reference's `_mm(x, w)
    + b` gives it: dx = ((dy in fp32) * s) @ levels^T cast to x's dtype,
    dbias = dy summed over the rows."""

    @staticmethod
    def forward(ctx, x, q, s, bias):
        ctx.save_for_backward(q, s)
        return _launch(x, ((q, s, bias),))[0]

    @staticmethod
    def backward(ctx, dy):
        q, s = ctx.saved_tensors
        dx = dbias = None
        if ctx.needs_input_grad[0]:
            dx = ((dy.float() * s) @ q.float().t()).to(dy.dtype)
        if ctx.needs_input_grad[3]:
            dbias = dy.reshape(-1, dy.shape[-1]).sum(0)
        return dx, None, None, dbias


def _needs_grad(x: torch.Tensor, bias: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or (bias is not None and bias.requires_grad))


def mm_w8a16(x: torch.Tensor, w: dict,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """Same function as `mm_w8a16_plain`: x [..., I] (bf16 or fp32,
    contiguous), w {"q": int8 [I, O], "s": fp32 [O]}, bias x's dtype [O] or
    None → [..., O] in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel once (the bias folded into its epilogue),
    through `_W8A16` where x or the bias needs a gradient."""
    q, s = w["q"], w["s"]
    _check(x, ((q, s, bias),))
    if not x.is_cuda:
        if x.device.type == "cpu":
            return mm_w8a16_plain(x, w, bias)
        raise ValueError(f"mm_w8a16: unsupported device {x.device}")
    if _needs_grad(x, bias):
        return _W8A16.apply(x, q, s, bias)
    return _launch(x, ((q, s, bias),))[0]


def mm_w8a16_group(x: torch.Tensor, members) -> tuple:
    """Up to three products of one x: members [(w, bias or None), ...],
    each as `mm_w8a16` takes it, all of x's width I → a tuple of their
    outputs [..., O_k] in x's dtype, each its own tensor. CPU tensors take
    `mm_w8a16_group_plain`; CUDA tensors launch the kernel once for all
    members (one launch counted), except where x or a bias needs a
    gradient: then each member goes through `mm_w8a16`."""
    members = tuple(members)
    if not 1 <= len(members) <= _MAX_MEMBERS:
        raise ValueError(f"mm_w8a16_group: 1 to {_MAX_MEMBERS} members, not "
                         f"{len(members)}")
    operands = tuple((w["q"], w["s"], b) for w, b in members)
    _check(x, operands)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return mm_w8a16_group_plain(x, members)
        raise ValueError(f"mm_w8a16: unsupported device {x.device}")
    if any(_needs_grad(x, b) for _, b in members):
        return tuple(mm_w8a16(x, w, b) for w, b in members)
    return _launch(x, operands)


mm_w8a16.launches = 0


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of `dtype`'s values at |v| (fp32 tensor in, fp32 out);
    at least its smallest normal's spacing."""
    info = torch.finfo(dtype)
    _, e = torch.frexp(v.abs().clamp(min=info.tiny))
    return torch.ldexp(torch.full_like(v, info.eps), e - 1)


def tolerance(x: torch.Tensor, w: dict, bias: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(reference, tolerance) for an output in x's dtype: the reference is
    the fp32 product (torch.mm in fp32 of x and the levels, times the
    scales, plus the bias); the tolerance is twice the fp32 sum-error bound
    gamma_I * sum_i |x_i * q_i| * s (the reference's sum and the checked
    one each lie within one bound of the exact sum, in any order) plus an
    fp32 ulp of the scale multiply, plus half an ulp of x's dtype (the
    final rounding; one more half ulp with a bias, its second rounding),
    the ulp taken at the largest value the checked sum can reach. Both fp32
    tensors [..., O]."""
    dtype = x.dtype
    I = w["q"].shape[0]
    x2 = x.reshape(-1, I).float()
    q = w["q"].float()
    s = w["s"].float()
    ref = (x2 @ q) * s
    mag = (x2.abs() @ q.abs()) * s
    gamma = I * _U32 / (1 - I * _U32)
    tol = 2 * gamma * mag + _ulp(ref.abs() + 2 * gamma * mag, torch.float32)
    tol = tol + 0.5 * _ulp(ref.abs() + tol, dtype)
    if bias is not None:
        ref = ref + bias.float()
        tol = tol + 0.5 * _ulp(ref.abs() + tol, dtype)
    shape = (*x.shape[:-1], ref.shape[-1])
    return ref.view(shape), tol.view(shape)


def within_tolerance(y: torch.Tensor, x: torch.Tensor, w: dict,
                     bias: torch.Tensor | None = None
                     ) -> tuple[bool, float]:
    """(every element of y within `tolerance` of the fp32 reference, the
    largest |y - reference| over the tolerance). The tests and
    chip_smoke.py hold the kernel and the plain version to it."""
    ref, tol = tolerance(x, w, bias)
    err = (y.float() - ref).abs()
    ratio = (err / tol).max().item() if err.numel() else 0.0
    return bool((err <= tol).all()), ratio
