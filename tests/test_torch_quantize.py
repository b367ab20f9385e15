"""Port per-head int8 quantization (openhush_tpu_torch.ops.quantize) against
the JAX model's _quantize_heads (its XLA branch on the CPU) and the Pallas
kernel in interpret mode, as tests/test_quantize_pallas.py runs them. On
the CPU the port's wrapper runs the kernel's plain version.

Tolerance: scales bit-identical; int8 values off by at most one level, on
at most 1e-3 of the elements, and only where x / scale sits on a .5 tie
(the division's last bit can differ between implementations there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.ops import quantize_pallas as qp
from openhush_tpu_torch.ops import quantize


def _to_torch_bf16(x_jax):
    return torch.from_numpy(np.asarray(x_jax, np.float32)).to(torch.bfloat16)


def _assert_matches(q, s, q_ref, s_ref, x32, head_dim):
    np.testing.assert_array_equal(s, s_ref)
    qn, qrn = q.astype(np.int32), q_ref.astype(np.int32)
    diff = np.argwhere(qn != qrn)
    assert len(diff) <= qn.size * 1e-3
    for b, t, i in diff:
        assert abs(qn[b, t, i] - qrn[b, t, i]) == 1
        ratio = x32[b, t, i // head_dim, i % head_dim] / s_ref[
            b, t, i // head_dim]
        assert abs(ratio * 2 - round(ratio * 2)) < 1e-4, ratio


@pytest.mark.parametrize("B,T,n_head,head_dim", [
    (2, 128, 4, 64),        # whisper-ish
    (1, 500, 20, 64),       # large-v3 cross-KV block shape
    (3, 192, 2, 128),
])
def test_matches_xla_and_pallas(B, T, n_head, head_dim):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, T, n_head * head_dim)) * 3,
                    jnp.bfloat16)
    q, s = quantize.quantize_heads(_to_torch_bf16(x), n_head)
    assert q.dtype == torch.int8 and q.shape == (B, T, n_head * head_dim)
    assert s.dtype == torch.float32 and s.shape == (B, T, n_head)
    x32 = np.asarray(x, np.float32).reshape(B, T, n_head, head_dim)
    for ref in (jax_model._quantize_heads(x, n_head),
                qp.quantize_heads_pallas(x, n_head, interpret=True)):
        _assert_matches(q.numpy(), s.numpy(), np.asarray(ref[0]),
                        np.asarray(ref[1]), x32, head_dim)


def test_fp32_input_matches_xla():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 96, 256)).astype(np.float32)
    q, s = quantize.quantize_heads(torch.from_numpy(x), 4)
    q_ref, s_ref = jax_model._quantize_heads(jnp.asarray(x), 4)
    _assert_matches(q.numpy(), s.numpy(), np.asarray(q_ref),
                    np.asarray(s_ref), x.reshape(2, 96, 4, 64), 64)


def test_zeros_and_extremes():
    q, s = quantize.quantize_heads(torch.zeros(1, 128, 256,
                                               dtype=torch.bfloat16), 4)
    assert int(q.abs().sum()) == 0
    assert bool((s == torch.tensor(1e-10, dtype=torch.float32)).all())
    q, _ = quantize.quantize_heads(torch.full((1, 128, 256), 3.0e4,
                                              dtype=torch.bfloat16), 4)
    assert bool((q == 127).all())


@pytest.mark.parametrize("dtype,n_head,head_dim", [
    (jnp.bfloat16, 20, 64),     # large-v3's cross K and V
    (jnp.float32, 2, 32),       # the test config's
])
def test_kv_into_stacked_slices_matches_xla(dtype, n_head, head_dim):
    """quantize_heads_kv writes K's and V's int8 values and scales into
    slice 1 of stacked [3, B, T, ...] buffers, each as the JAX model's
    _quantize_heads gives it; slices 0 and 2 keep what they held."""
    rng = np.random.default_rng(3)
    B, T = 2, 96
    k, v = (jnp.asarray(rng.standard_normal((B, T, n_head * head_dim))
                        * scale, dtype) for scale in (3.0, 0.5))
    to_torch = lambda x: torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    vals = lambda: torch.full((3, B, T, n_head * head_dim), 7, dtype=torch.int8)
    scales = lambda: torch.full((3, B, T, n_head), 7.0)
    out = [vals(), scales(), vals(), scales()]
    quantize.quantize_heads_kv(to_torch(k), to_torch(v), n_head,
                               tuple(t[1] for t in out))
    for x, q, s in ((k, out[0], out[1]), (v, out[2], out[3])):
        q_ref, s_ref = jax_model._quantize_heads(x, n_head)
        x32 = np.asarray(x, np.float32).reshape(B, T, n_head, head_dim)
        _assert_matches(q[1].numpy(), s[1].numpy(), np.asarray(q_ref),
                        np.asarray(s_ref), x32, head_dim)
        for t in (q, s):
            assert bool((t[0] == 7).all()) and bool((t[2] == 7).all())


def test_kv_checks_what_the_kernel_takes():
    """The wrapper's checks: a head_dim the kernel's lanes cannot split and
    outputs of the wrong shape are refused before any launch, head dims of
    a multiple of 16 bytes up to 512 are taken (the meta device stands in
    for a card)."""
    x = torch.empty(1, 4, 60, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quantize.quantize_heads_kv(x, x, 2, ())
    with pytest.raises(ValueError, match="head_dim"):
        quantize._check("quantize_heads_kv", (x, x), (), 2)
    x = torch.empty(1, 4, 64, dtype=torch.bfloat16)
    q, s = torch.empty(1, 4, 64, dtype=torch.int8), torch.empty(1, 4, 2)
    quantize._check("quantize_heads_kv", (x, x), (q, s, q, s), 2)
    with pytest.raises(ValueError, match="outputs"):
        quantize._check("quantize_heads_kv", (x, x), (q, s, q, s[..., :1]), 2)
    for dtype, head_dim in ((torch.bfloat16, 80), (torch.bfloat16, 96),
                            (torch.bfloat16, 256), (torch.float32, 4),
                            (torch.float32, 80), (torch.float32, 128)):
        x = torch.empty(1, 4, 2 * head_dim, dtype=dtype, device="meta")
        q = torch.empty(1, 4, 2 * head_dim, dtype=torch.int8, device="meta")
        s = torch.empty(1, 4, 2, device="meta")
        quantize._check("quantize_heads_kv", (x, x), (q, s, q, s), 2)
    for dtype, head_dim in ((torch.bfloat16, 264), (torch.float32, 132)):
        x = torch.empty(1, 4, 2 * head_dim, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="head_dim"):
            quantize._check("quantize_heads_kv", (x, x), (), 2)
