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
