"""The split-product arithmetic of K2's fp32 path
(csrc/flash_attention_tc.cu at NP = 3) and of K7, the dQ backward
(csrc/flash_attention_bwd_tc.cu), modelled in PyTorch on the CPU, against
the port's plain versions (`flash_attention.attend_lse`,
`backward_dq_plain`) and the JAX model's `_attend` in fp32 on the same
inputs, made from a seed with numpy: its output with the `logsumexp` of its
scaled scores, and jax.vjp of it with respect to q.

Both kernels read each fp32 operand as three bf16 parts (`_split3`, the
split pass's planes) and take each product as six partial products, smallest
first, with fp32 sums (`_product`); both walk the keys in tiles of 64.
- K2: S = q kᵀ, scaled by Dh^-0.5·log2 e; a running max and sum per row
  (exp2 in fp32); the unnormalised P split into three parts as the A
  operand of O += P v; at the end O / l and lse = (m + log2 l)·ln 2.
- K7: S = q kᵀ and dP = dO vᵀ; P = exp(S·Dh^-0.5 − lse) and
  dS = P∘(dP − D) in fp32, split into three parts for dQ += dS k; at the
  end dQ·Dh^-0.5.
Keys at or past Tk are not there (the kernels mask by length): with key
masking on, the models take the first n_valid keys. Tolerance: 1e-5 of
max|plain| per output (the six partial products leave out terms of about
2^-24 of each product; fp32 sums in another order)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_bwd_tc import _product, _split3

B, H, D = 1, 2, 64
BK = 64                               # the kernels' key tile


def _k2_fp32_model(q, k, v):
    """K2's fp32 arithmetic: q [B, H, Tq, 64], k and v [B, H, Tk, 64] →
    (o [B, H, Tq, 64], lse [B, H, Tq])."""
    scale_log2 = D ** -0.5 * math.log2(math.e)
    qp = _split3(q)
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for j in range(0, k.shape[2], BK):
        kp, vp = _split3(k[:, :, j:j + BK]), _split3(v[:, :, j:j + BK])
        s = _product(qp, kp, "bhqd,bhkd->bhqk") * scale_log2
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _product(_split3(p), vp,
                                            "bhqk,bhkd->bhqd")
        m = m_new
    return o * (1.0 / l)[..., None], (m + torch.log2(l)) * math.log(2.0)


def _k7_model(q, k, v, do, lse, delta):
    """K7's arithmetic: fp32 q, dO [B, H, Tq, 64], k, v [B, H, Tk, 64],
    lse and D [B, H, Tq] → dq [B, H, Tq, 64]."""
    scale = D ** -0.5
    qp, op = _split3(q), _split3(do)
    dq = torch.zeros_like(q)
    for j in range(0, k.shape[2], BK):
        kp, vp = _split3(k[:, :, j:j + BK]), _split3(v[:, :, j:j + BK])
        s = _product(qp, kp, "bhqd,bhkd->bhqk")
        dp = _product(op, vp, "bhqd,bhkd->bhqk")
        p = torch.exp(s * scale - lse[..., None])
        ds = p * (dp - delta[..., None])
        dq = dq + _product(_split3(ds), kp, "bhqk,bhkd->bhqd")
    return dq * scale


def _inputs(T, masked, seed):
    n_valid = T - 37 if masked else T
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, T, D)).astype(np.float32)
              for _ in range(4)]
    mask = np.arange(T)[None, None, None, :] < n_valid
    return n_valid, arrays, mask


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1500, 333])
def test_k2_fp32_split_product_model(T, masked):
    """T = 1500 (the encoder's) and 333 end on a ragged key tile; with
    masking, keys past n_valid are not attended to."""
    n_valid, (q, k, v, _), mask = _inputs(T, masked, T + masked)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = torch.from_numpy(mask) if masked else None
    o, lse = _k2_fp32_model(tq, tk[:, :, :n_valid], tv[:, :, :n_valid])
    plain_o, plain_lse = fa.attend_lse(tq, tk, tv, tmask)
    jm = jnp.asarray(mask) if masked else None
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_o = np.asarray(jax_model._attend(jq, jk, jv, jm))
    scores = jnp.einsum("bhqd,bhkd->bhqk", jq, jk) * D ** -0.5
    if masked:
        scores = jnp.where(jm, scores, jnp.finfo(jnp.float32).min)
    ref_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    for ours, others in ((o.numpy(), (plain_o.numpy(), ref_o)),
                         (lse.numpy(), (plain_lse.numpy(), ref_lse))):
        for other in others:
            assert _rel(ours, other) <= 1e-5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1500, 333])
def test_k7_split_product_model(T, masked):
    n_valid, (q, k, v, do), mask = _inputs(T, masked, 10 * T + masked)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = torch.from_numpy(mask) if masked else None
    o, lse = fa.attend_lse(tq, tk, tv, tmask)
    delta = fa.delta_rows(o, tdo)
    ours = _k7_model(tq, tk[:, :, :n_valid], tv[:, :, :n_valid], tdo, lse,
                     delta).numpy()
    plain = fa.backward_dq_plain(tq, tk, tv, tdo, lse, delta, tmask).numpy()
    jm = jnp.asarray(mask) if masked else None
    _, vjp = jax.vjp(lambda a: jax_model._attend(a, jnp.asarray(k),
                                                 jnp.asarray(v), jm),
                     jnp.asarray(q))
    ref = np.asarray(vjp(jnp.asarray(do))[0])
    for other in (plain, ref):
        assert _rel(ours, other) <= 1e-5


@pytest.mark.parametrize("with_do", [False, True])
def test_split_planes_layout(with_do):
    """The split pass's buffer (`split_planes`; its plain version on CPU
    tensors, which the kernel matches bit for bit on the card): q's, k's,
    v's (and dO's) three parts as planes [3·B, H, T, 64] one after another,
    part p of batch row b at row b + p·B, each the `_split3` part, summing
    back to the operand exactly. Strided [B, T, H·64] views as encode()
    gives them; bf16 operands have no planes."""
    rng = np.random.default_rng(7 + with_do)
    b, tq, tk = 2, 5, 7
    views = [torch.from_numpy(rng.standard_normal((b, t, H * D)).astype(
        np.float32)).view(b, t, H, D).transpose(1, 2)
        for t in (tq, tk, tk, tq)]
    ops = views if with_do else views[:3]
    planes = fa.split_planes(*ops)
    assert planes.dtype == torch.bfloat16
    assert planes.numel() == 3 * sum(x.numel() for x in ops)
    offset = 0
    for x in ops:
        n = 3 * x.numel()
        got = planes[offset:offset + n].view(3 * b, *x.shape[1:]).float()
        offset += n
        for p, part in enumerate(_split3(x)):
            assert torch.equal(got[p * b:(p + 1) * b], part)
        total = sum(got[p * b:(p + 1) * b].double() for p in range(3))
        assert torch.equal(total, x.double())
    assert fa.split_planes(*(x.bfloat16() for x in ops)) is None
