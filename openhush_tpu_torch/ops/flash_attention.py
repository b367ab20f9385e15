"""Encoder self-attention on the hand-written CUDA flash kernels, forward
(csrc/flash_attention_tc.cu: K2) and backward (csrc/flash_attention_bwd_tc.cu:
K6 for dK and dV, K7 for dQ), all on the tensor cores. fp32 inputs keep
fp32 accuracy there through bf16x3 split products: a split pass
(csrc/flash_split.cu, `split_planes`) writes each fp32 operand's three bf16
parts as planes, and every product is six bf16 partial products with fp32
sums (never plain TF32).

Counterpart of openhush_tpu/models/whisper/model.py:_attend_full, which runs
the Pallas TPU flash kernel on the chip and the dense `_attend` elsewhere;
in training, JAX differentiates the Pallas kernel through its custom_vjp:
the forward keeps per-row residuals and two more Pallas kernels compute the
gradients. `attend` here is a copy of `_attend` and the forward's plain
version; `attend_lse` adds the residual, and `attend_backward` is the
backward's plain version, an explicit formula (`backward_dkv_plain` and
`backward_dq_plain`, one for each backward kernel).

`flash_attention` is what the encoder calls. On CPU tensors it is `attend`,
which autograd differentiates. On CUDA tensors it launches K2, and when a
gradient is wanted it goes through `FlashAttention`, an autograd Function
whose forward launches K2 in residual mode and whose backward launches K6
and K7 on one shared split of q, k, v and dO: a kernel or an error, never a
fallback.
"""

from __future__ import annotations

import ctypes

import torch

from openhush_tpu_torch.ops import _build

HEAD_DIM = 64          # the only head size the kernels take (every Whisper)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, mask):
    """fp32 q kᵀ·Dh^-0.5 [B, H, Tq, Tk], masked entries at finfo(f32).min."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    return scores


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] → [B, H, Tq, Dh]. Scores and softmax in fp32,
    probabilities cast to the input dtype before the value product."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def attend_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """`attend` and the per-row log-sum-exp of its scaled scores, fp32
    [B, H, Tq]: the plain version of K2's residual mode."""
    return attend(q, k, v, mask), torch.logsumexp(_scores(q, k, mask), dim=-1)


def _probs_and_dscores(q, k, v, do, lse, delta, mask):
    """P = exp(S − lse) and dS = P∘(dO vᵀ − D), fp32 [B, H, Tq, Tk]: what
    both backward kernels recompute tile by tile. Masked keys get P = 0."""
    p = torch.exp(_scores(q, k, mask) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def backward_dkv_plain(q, k, v, do, lse, delta, mask=None):
    """K6's plain version: dk = dSᵀ q·Dh^-0.5, dv = Pᵀ dO, from q, k, v,
    dO and the fp32 [B, H, Tq] residual lse and D = rowsum(o∘dO)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * q.shape[-1] ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def backward_dq_plain(q, k, v, do, lse, delta, mask=None):
    """K7's plain version: dq = dS k·Dh^-0.5 from the same inputs."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, mask)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def delta_rows(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(o∘dO), contiguous fp32 [B, H, Tq]: the backward kernels'
    third residual, a PyTorch expression as the TPU path's `di` is XLA."""
    return (o.float() * do.float()).sum(-1).contiguous()


def attend_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of `attend` (q, k, v → o, with residual lse) for an
    output gradient `do`, by the explicit flash formula, not autograd:
    D = rowsum(o∘dO), P = exp(S − lse), dV = Pᵀ dO, dS = P∘(dO vᵀ − D),
    dQ = dS k·Dh^-0.5, dK = dSᵀ q·Dh^-0.5. The plain version of K6 and K7,
    all in fp32, the outputs cast to the inputs' dtype."""
    delta = delta_rows(o, do)
    dk, dv = backward_dkv_plain(q, k, v, do, lse, delta, mask)
    return backward_dq_plain(q, k, v, do, lse, delta, mask), dk, dv


def _aligned(t: torch.Tensor, vec: int) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _check(name, q, k, v, *more):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES \
            or any(t.dtype != q.dtype for t in more):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         f"the kernel takes one of {list(_DTYPES)}")
    if q.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != HEAD_DIM or k.shape[-1] != HEAD_DIM \
            or any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}; the kernel "
                         f"takes [B, H, T, {HEAD_DIM}]")
    vec = 16 // q.element_size()
    for t in (q, k, v, *more):
        if t.device != q.device or not _aligned(t, vec):
            raise ValueError(f"{name}: inputs must share a device, have a "
                             f"contiguous last dim and 16-byte aligned rows")


def _check_rows(name, q, *rows):
    """lse and delta: contiguous fp32 [B, H, Tq] on q's device."""
    for r in rows:
        if r.dtype != torch.float32 or r.shape != q.shape[:3] \
                or not r.is_contiguous() or r.device != q.device:
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"fp32 {tuple(q.shape[:3])} on {q.device}")


def _cuda_only(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def _heads_like(x: torch.Tensor, T: int) -> torch.Tensor:
    """An empty [B, H, T, 64] tensor that is a view of a [B, T, H, 64]
    buffer, so that merging heads (or the projection's gradient) is free."""
    B, H = x.shape[:2]
    return torch.empty(B, T, H, x.shape[-1], dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _strides(*ts):
    """The (b, h, t) strides of each tensor, in order; zeros for None."""
    flat = [s for t in ts
            for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _n_plane_elems(q, k, do) -> int:
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    return 3 * B * H * D * (Tq + 2 * Tk + (Tq if do is not None else 0))


def split_planes_plain(q, k, v, do=None) -> torch.Tensor:
    """The split pass's plain version: each fp32 operand x as three bf16
    parts, x = hi + mid + lo, each the bf16 rounding of what the earlier
    parts leave; operand [B, H, T, 64] becomes planes [3 * B, H, T, 64]
    (part p of batch row b is row b + p * B), and q's, k's, v's and dO's
    planes follow one another in one flat buffer."""
    out = []
    for x in (q, k, v) + (() if do is None else (do,)):
        hi = x.to(torch.bfloat16)
        r = x - hi.float()
        mid = r.to(torch.bfloat16)
        lo = (r - mid.float()).to(torch.bfloat16)
        out.append(torch.stack((hi, mid, lo)).reshape(-1))
    return torch.cat(out)


def split_planes(q, k, v, do=None) -> torch.Tensor | None:
    """The split pass of the fp32 kernels (csrc/flash_split.cu): the three
    bf16 parts of fp32 q, k, v and, for the backward, dO, as one flat bf16
    buffer of contiguous planes, which K2 (q, k, v) and K6 and K7 (all
    four) read instead of the fp32 tensors (`split_planes_plain` has the
    layout). None for bf16 inputs, which the kernels read in place. CPU
    tensors take the plain version."""
    if q.dtype != torch.float32:
        return None
    if q.device.type == "cpu":
        return split_planes_plain(q, k, v, do)
    _cuda_only("split_planes", q)
    _check("split_planes", q, k, v, *(() if do is None else (do,)))
    B, H, Tq, _ = q.shape
    planes = torch.empty(_n_plane_elems(q, k, do), dtype=torch.bfloat16,
                         device=q.device)
    err = _build.library().oh_flash_attention_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if do is None else do.data_ptr(), planes.data_ptr(), B, H, Tq,
        k.shape[2], _strides(q, k, v, do), _stream(q))
    _build.check(err, "oh_flash_attention_split")
    split_planes.launches += 1
    return planes


def _planes_for(name, q, k, v, do, planes):
    """`planes` checked against the inputs, or made by `split_planes` when
    not given; None for bf16."""
    if q.dtype != torch.float32:
        return None
    if planes is None:
        return split_planes(q, k, v, do)
    if planes.dtype != torch.bfloat16 or planes.device != q.device \
            or planes.numel() != _n_plane_elems(q, k, do):
        raise ValueError(f"{name}: planes must be split_planes' buffer for "
                         f"these inputs")
    return planes


def _launch_forward(q, k, v, lse):
    B, H, Tq, D = q.shape
    out = _heads_like(q, Tq)
    planes = _planes_for("oh_flash_attention", q, k, v, None, None)
    err = _build.library().oh_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if planes is None else planes.data_ptr(), B, H, Tq, k.shape[2],
        _strides(q, k, v, out), D ** -0.5, _DTYPES[q.dtype], _stream(q))
    _build.check(err, "oh_flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q [B, H, Tq, 64], k and v [B, H, Tk, 64] (may
    be strided views of [B, T, H*64] projections) → [B, H, Tq, 64], a view
    of a [B, Tq, H, 64] buffer so that merging heads is free. CPU tensors
    take `attend`; CUDA tensors launch K2, through `FlashAttention` (K2 in
    residual mode, K6 and K7 backward) when an input needs a gradient."""
    if q.device.type == "cpu":
        return attend(q, k, v)
    _cuda_only("flash_attention", q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    _check("flash_attention", q, k, v)
    out = _launch_forward(q, k, v, None)
    flash_attention.launches += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 in residual mode: `flash_attention`'s output and the per-row
    log-sum-exp, fp32 [B, H, Tq]. CPU tensors take `attend_lse`."""
    if q.device.type == "cpu":
        return attend_lse(q, k, v)
    _cuda_only("flash_attention_lse", q)
    _check("flash_attention_lse", q, k, v)
    B, H, Tq, _ = q.shape
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    out = _launch_forward(q, k, v, lse)
    flash_attention_lse.launches += 1
    return out, lse


def _launch_backward(fn_name, q, k, v, do, lse, delta, planes, dq=None,
                     dk=None, dv=None):
    """K6 (dk and dv given) or K7 (dq given); both entry points take the
    strides of q, k, v, dO, dq, dk, dv in that order, and for fp32 inputs
    the split pass's planes of q, k, v and dO."""
    B, H, Tq, D = q.shape
    planes = _planes_for(fn_name, q, k, v, do, planes)
    grads = [g.data_ptr() for g in (dq, dk, dv) if g is not None]
    err = getattr(_build.library(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *grads,
        None if planes is None else planes.data_ptr(), B, H, Tq, k.shape[2],
        _strides(q, k, v, do, dq, dk, dv), D ** -0.5, _DTYPES[q.dtype],
        _stream(q))
    _build.check(err, fn_name)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, planes=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: dk, dv [B, H, Tk, 64] (views of [B, Tk, H, 64] buffers) from q,
    k, v, the output gradient `do`, and the fp32 [B, H, Tq] residual `lse`
    and `delta` = rowsum(o∘dO). CPU tensors take the plain version. On the
    card the four products run on the tensor cores, fp32 operands as the
    sums of three bf16 parts (six partial products each, fp32 sums):
    `planes` is `split_planes(q, k, v, do)`, made here when not given."""
    if q.device.type == "cpu":
        return backward_dkv_plain(q, k, v, do, lse, delta)
    _cuda_only("flash_attention_bwd_dkv", q)
    _check("flash_attention_bwd_dkv", q, k, v, do)
    _check_rows("flash_attention_bwd_dkv", q, lse, delta)
    dk, dv = _heads_like(k, k.shape[2]), _heads_like(v, v.shape[2])
    _launch_backward("oh_flash_attention_bwd_dkv", q, k, v, do, lse, delta,
                     planes, dk=dk, dv=dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, planes=None
                           ) -> torch.Tensor:
    """K7: dq [B, H, Tq, 64] (a view of a [B, Tq, H, 64] buffer) from the
    same inputs as K6, on the tensor cores as K6 is (the same `planes`).
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return backward_dq_plain(q, k, v, do, lse, delta)
    _cuda_only("flash_attention_bwd_dq", q)
    _check("flash_attention_bwd_dq", q, k, v, do)
    _check_rows("flash_attention_bwd_dq", q, lse, delta)
    dq = _heads_like(q, q.shape[2])
    _launch_backward("oh_flash_attention_bwd_dq", q, k, v, do, lse, delta,
                     planes, dq=dq)
    flash_attention_bwd_dq.launches += 1
    return dq


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward on K2 in residual mode,
    backward on K6 (dk, dv) and K7 (dq), with D = rowsum(o∘dO) in PyTorch
    between them and one split pass of q, k, v and dO for both (fp32). On
    CPU tensors the wrappers take their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if not _aligned(do, 16 // do.element_size()):
            do = do.contiguous()     # e.g. an expanded gradient of a sum
        delta = delta_rows(out, do)
        planes = split_planes(q, k, v, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, planes)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, planes)
        return dq, dk, dv


flash_attention.launches = 0
flash_attention_lse.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
split_planes.launches = 0
