"""The rounding of K2's bf16 tensor-core kernel (csrc/flash_attention_tc.cu),
modelled in PyTorch on the CPU, against the port's plain version
`flash_attention.attend` / `attend_lse` and the JAX model's `_attend` at
bf16 on the same inputs, made from a seed with numpy.

The kernel takes fp32 scores from bf16 q·k, scales them by Dh^-0.5·log2 e,
keeps a running max and sum per row over key tiles (exp2 in fp32, keys past
Tk masked), rounds the unnormalised probabilities of each tile to bf16 as
the value product's operand, sums O in fp32, and multiplies by 1/l at the
end. The reference rounds the normalised probabilities to bf16 instead.
Tolerance 1e-2 absolute on bf16 outputs of magnitude ~1 (the same relative
rounding of P, 2^-9, in another place, and one bf16 rounding of the output,
up to 2^-8 at 1); lse within 1e-4 (fp32 sums in another order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu_torch.ops import flash_attention

H, DH = 4, 64


def _tc_model(q, k, v, tile):
    """K2's bf16 arithmetic: q, k, v bf16 [B, H, T, 64] → (o bf16, lse fp32)."""
    Tk = k.shape[2]
    scale_log2 = torch.tensor(DH ** -0.5 * math.log2(math.e), dtype=torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_log2
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], DH)
    for j in range(0, Tk, tile):
        x = s[..., j:j + tile]
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            v[:, :, j:j + tile].float())
        m = m_new
    out = (o * (1.0 / l)[..., None]).to(torch.bfloat16)
    return out, (m + torch.log2(l)) * math.log(2.0)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("T", [1500, 333])
def test_tensor_core_rounding_model(T, tile):
    """The kernel's key tile is 64; 128 shows the rounding does not hinge
    on it. T = 1500 (the encoder's) and 333 end on a ragged tile."""
    rng = np.random.default_rng(T + tile)
    q, k, v = (rng.standard_normal((1, H, T, DH)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours, lse = _tc_model(tq, tk, tv, tile)
    plain, plain_lse = flash_attention.attend_lse(tq, tk, tv)
    ref = np.asarray(jax_model._attend(jq, jk, jv), np.float32)
    assert ours.dtype == plain.dtype == torch.bfloat16
    for other in (plain.float().numpy(), ref):
        np.testing.assert_allclose(ours.float().numpy(), other, atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), atol=1e-4)
