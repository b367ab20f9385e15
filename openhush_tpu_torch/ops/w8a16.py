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
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 2.0 ** -24                 # fp32's unit roundoff


def mm_w8a16_plain(x: torch.Tensor, w: dict,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., I] @ the levels with fp32 sums, times the scales in fp32,
    cast to x's dtype, then + bias in x's dtype. On the card a bf16 x takes
    torch.mm's fp32 output on the levels cast to bf16, so nothing rounds to
    bf16 before the scale; on the CPU the product runs in fp32."""
    q = w["q"].to(x.dtype)
    if x.dtype == torch.float32:
        y = x @ q
    elif x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), q, out_dtype=torch.float32
                     ).view(*x.shape[:-1], q.shape[-1])
    else:
        y = x.float() @ q.float()
    y = (y * w["s"].float()).to(x.dtype)
    return y if bias is None else y + bias


def _check(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
           bias: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take. On the decode path this runs
    256 times a large-v3 decoder call, so it reads each property once."""
    shape, qshape = x.shape, q.shape
    if len(qshape) != 2:
        raise ValueError(f"mm_w8a16: the levels must be [I, O], not "
                         f"{list(qshape)}")
    I, O = qshape
    if x.dtype not in _DTYPES:
        raise ValueError(f"mm_w8a16: x is {x.dtype}; the kernel takes "
                         f"bfloat16 or float32")
    if (not shape or shape[-1] != I or I % 16 or O % 16 or I == 0
            or O == 0):
        raise ValueError(f"mm_w8a16: x {list(shape)} x levels "
                         f"{list(qshape)}; the kernel takes I and O that are "
                         f"multiples of 16")
    if not x.is_contiguous():
        raise ValueError(f"mm_w8a16: x {list(shape)} with strides "
                         f"{x.stride()} is not contiguous")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"mm_w8a16: the levels must be contiguous int8 "
                         f"[{I}, {O}], not {q.dtype} with strides "
                         f"{q.stride()}")
    if s.dtype != torch.float32 or s.shape != (O,) or not s.is_contiguous():
        raise ValueError(f"mm_w8a16: the scales must be contiguous fp32 "
                         f"[{O}], not {s.dtype} {list(s.shape)}")
    dev = x.get_device()
    if bias is not None:
        if (bias.dtype != x.dtype or bias.shape != (O,)
                or not bias.is_contiguous()):
            raise ValueError(f"mm_w8a16: the bias must be contiguous "
                             f"{x.dtype} [{O}], not {bias.dtype} "
                             f"{list(bias.shape)}")
        if bias.get_device() != dev:
            raise ValueError(f"mm_w8a16: x on {x.device}, the bias on "
                             f"{bias.device}")
    if q.get_device() != dev or s.get_device() != dev:
        raise ValueError(f"mm_w8a16: x on {x.device}, the levels on "
                         f"{q.device}, the scales on {s.device}")


def mm_w8a16(x: torch.Tensor, w: dict,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """Same function as `mm_w8a16_plain`: x [..., I] (bf16 or fp32,
    contiguous), w {"q": int8 [I, O], "s": fp32 [O]}, bias x's dtype [O] or
    None → [..., O] in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel once (the bias folded into its epilogue)."""
    q, s = w["q"], w["s"]
    _check(x, q, s, bias)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return mm_w8a16_plain(x, w, bias)
        raise ValueError(f"mm_w8a16: unsupported device {x.device}")
    I, O = q.shape
    y = x.new_empty((*x.shape[:-1], O))
    if (x.data_ptr() | q.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("mm_w8a16: x, the levels and the output must be "
                         "16-byte aligned")
    # The raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, ~7 us of host time on the card's machine, 256 times a call.
    err = (_build._lib or _build.library()).oh_w8a16(
        x.data_ptr(), q.data_ptr(), s.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        x.numel() // I, I, O, _DTYPES[x.dtype],
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(err, "oh_w8a16")
    mm_w8a16.launches += 1
    return y


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
