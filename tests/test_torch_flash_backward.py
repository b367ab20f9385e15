"""Backward of the port's encoder attention (openhush_tpu_torch.ops.
flash_attention) against the JAX model's `_attend` differentiated by
jax.vjp (on the CPU the reference takes its dense `_attend`; the Pallas
flash kernel and its backward kernels are TPU-only), and against torch
autograd of the port's own `attend`.

`attend_backward` is the plain version of the backward kernels K6 and K7:
an explicit formula from the forward's residual (the per-row log-sum-exp
that K2 writes in residual mode; `attend_lse` is its plain version), not
autograd. The wrappers K2-with-lse, K6 and K7 take their plain versions on
CPU tensors, so `FlashAttention` (the autograd Function the encoder uses on
the GPU) runs here end to end on them.

Key-length masking: the reference pads T to a multiple of 128 and masks the
pad keys; here a boolean key mask on padded inputs, with the padded query
rows' output gradient zero.

Tolerances: fp32 atol 1e-5 on gradients of magnitude ~1 (fp32 sums in
another order); bf16 2e-2 of the largest gradient (the reference rounds the
probabilities to bf16 before the value product, and its vjp rounds its
intermediates; the port's backward sums in fp32 and rounds only the
outputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu_torch.ops import flash_attention as fa

B, H, T, D = 2, 3, 50, 64


def _inputs(seed, T_q=T, T_k=T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T_q, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, T_k, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, T_q, D)).astype(np.float32)
    return q, k, v, do


def _key_mask(T_pad, n_valid):
    """[1, 1, 1, T_pad] bool: keys before n_valid visible."""
    return np.arange(T_pad)[None, None, None, :] < n_valid


def _jax_vjp(q, k, v, do, mask, dtype):
    jd = jnp.dtype(dtype)
    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: jax_model._attend(a, b, c, m), *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jd))]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_attend_backward_matches_jax_vjp(dtype, rtol, masked):
    T_pad, n_valid = (64, 50) if masked else (T, T)
    q, k, v, do = _inputs(0, T_pad, T_pad)
    mask = _key_mask(T_pad, n_valid) if masked else None
    if masked:
        do[:, :, n_valid:] = 0      # padded query rows: no gradient flows
    ref = _jax_vjp(q, k, v, do, mask, dtype)
    tq, tk, tv, tdo = _torch((q, k, v, do), dtype)
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.attend_lse(tq, tk, tv, tmask)
    ours = fa.attend_backward(tq, tk, tv, o, lse, tdo, tmask)
    for name, a, b in zip("qkv", ours, ref):
        assert a.dtype == getattr(torch, dtype)
        scale = np.abs(b).max()
        err = np.abs(a.float().numpy() - b).max()
        assert err <= rtol * max(scale, 1.0), (name, err, scale)
    if masked:
        # The pad keys get no gradient; their k and v rows are zero-grad.
        assert float(ours[1][:, :, n_valid:].abs().max()) == 0
        assert float(ours[2][:, :, n_valid:].abs().max()) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_attend_backward_matches_torch_autograd(masked):
    q, k, v, do = _inputs(1, 40, 70)
    mask = (torch.from_numpy(np.random.default_rng(2).random((B, 1, 40, 70))
                             > 0.3) if masked else None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    fa.attend(tq, tk, tv, mask).backward(tdo)
    with torch.no_grad():
        o, lse = fa.attend_lse(tq, tk, tv, mask)
        ours = fa.attend_backward(tq, tk, tv, o, lse, tdo, mask)
    for a, t in zip(ours, (tq, tk, tv)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=1e-5)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    q, k, v, _ = _inputs(3, 30, 45)
    tq, tk, tv = _torch((q, k, v), "float32")
    o, lse = fa.attend_lse(tq, tk, tv)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * D ** -0.5
    ref = np.log(np.exp(s).sum(-1))
    assert lse.dtype == torch.float32 and lse.shape == (B, H, 30)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(o.numpy(), fa.attend(tq, tk, tv).numpy())


def test_flash_attention_function_gradients_on_strided_heads():
    """FlashAttention (K2 residual mode, K6, K7 as the encoder runs them on
    the GPU; their plain versions here) on [B, T, H*64] projection views
    gives autograd's gradients of `attend`."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, T, H * D))
                         .astype(np.float32))

    def run(attn):
        xg = x.clone().requires_grad_()
        q, k, v = (t.view(B, T, H, D).transpose(1, 2)
                   for t in xg.split(H * D, dim=-1))
        out = attn(q, k, v)
        (out.transpose(1, 2).reshape(B, T, H * D) * w).sum().backward()
        return out.detach(), xg.grad

    out, grad = run(fa.FlashAttention.apply)
    ref_out, ref_grad = run(fa.attend)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), atol=1e-5)


def test_cpu_wrappers_are_the_plain_versions():
    q, k, v, do = _torch(_inputs(5), "float32")
    o, lse = fa.flash_attention_lse(q, k, v)
    ref_o, ref_lse = fa.attend_lse(q, k, v)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    delta = fa.delta_rows(o, do)
    dq, dk, dv = fa.attend_backward(q, k, v, o, lse, do)
    got_dk, got_dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    for a, b in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        assert torch.equal(a, b)
    launches = (fa.flash_attention_lse.launches,
                fa.flash_attention_bwd_dkv.launches,
                fa.flash_attention_bwd_dq.launches)
    assert launches == (0, 0, 0)        # no kernel runs on the CPU


def test_backward_wrappers_never_fall_back_off_the_cpu():
    q = torch.empty(1, 2, 8, 64, device="meta")
    r = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_lse(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd_dkv(q, q, q, q, r, r)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd_dq(q, q, q, q, r, r)


def test_decode_attention_refuses_a_gradient():
    """The decode kernels have no backward: with grad mode on and an input
    that needs a gradient they raise, on the CPU too, instead of returning
    an output that silently drops it; under no_grad they run."""
    from openhush_tpu_torch.ops import decode_attention as da
    q = torch.randn(1, 1, 128, requires_grad=True)
    k = torch.randn(1, 5, 128)
    for fn in (da.attend_decode, da.attend_decode_pipelined):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, k, k, None, 2)
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q.detach(), k.requires_grad_(), k, None, 2)
        k = k.detach()
        with torch.no_grad():
            assert fn(q, k, k, None, 2).shape == (1, 1, 128)
