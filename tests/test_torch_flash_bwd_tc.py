"""The split-product arithmetic of K6, the dK/dV backward on the tensor cores
(csrc/flash_attention_bwd_tc.cu), modelled in PyTorch on the CPU, against
the port's plain version `flash_attention.backward_dkv_plain` and jax.vjp of
the JAX model's `_attend` in fp32 on the same inputs, made from a seed with
numpy.

The kernel writes each fp32 operand as three bf16 parts, x = x1 + x2 + x3
(each part the bf16 rounding of what the earlier parts leave), and takes
each product as the six partial products whose parts sum to at most the
third, smallest first ((3,1), (2,2), (1,3), (2,1), (1,2), (1,1)), summed in
fp32; P and dS are computed in fp32 and split the same way; dV and dK
accumulate over query tiles of 64 in order. Keys at or past Tk are not
there (the kernel masks by length): with key masking on, the model takes
the first n_valid keys and is compared on their rows. Tolerance: 1e-5 of
max|plain| per gradient (the six partial products leave out terms of about
2^-24 relative to the product; fp32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu_torch.ops import flash_attention as fa

B, H, D = 1, 2, 64
BQ = 64                               # the kernel's query tile
PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _split3(x: torch.Tensor) -> list[torch.Tensor]:
    """x (fp32) as three bf16 parts, each held in fp32."""
    x1 = x.to(torch.bfloat16).float()
    r = x - x1
    x2 = r.to(torch.bfloat16).float()
    x3 = (r - x2).to(torch.bfloat16).float()
    return [x1, x2, x3]


def _product(a_parts, b_parts, eq):
    """The six partial products of einsum `eq`, smallest first, fp32 sums."""
    out = None
    for i, j in PAIRS:
        term = torch.einsum(eq, a_parts[i], b_parts[j])
        out = term if out is None else out + term
    return out


def _k6_model(q, k, v, do, lse, delta):
    """K6's arithmetic: fp32 q, k, v, dO [B, H, T, 64], lse and D [B, H, Tq]
    → dk, dv [B, H, Tk, 64]."""
    scale = D ** -0.5
    kp, vp = _split3(k), _split3(v)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for q0 in range(0, q.shape[2], BQ):
        qt, ot = q[:, :, q0:q0 + BQ], do[:, :, q0:q0 + BQ]
        qp, op = _split3(qt), _split3(ot)
        s_t = _product(kp, qp, "bhkd,bhqd->bhkq")            # S^T
        dp_t = _product(vp, op, "bhkd,bhqd->bhkq")           # dP^T
        p_t = torch.exp(s_t * scale - lse[:, :, None, q0:q0 + BQ])
        ds_t = p_t * (dp_t - delta[:, :, None, q0:q0 + BQ])
        dv = dv + _product(_split3(p_t), op, "bhkq,bhqd->bhkd")
        dk = dk + _product(_split3(ds_t), qp, "bhkq,bhqd->bhkd")
    return dk * scale, dv


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1500, 333])
def test_split_product_model(T, masked):
    """T = 1500 (the encoder's) and 333 end on a ragged query tile; with
    masking, keys past n_valid are not attended to."""
    n_valid = T - 37 if masked else T
    rng = np.random.default_rng(T + masked)
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                   for _ in range(4))
    mask = np.arange(T)[None, None, None, :] < n_valid
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = torch.from_numpy(mask) if masked else None
    o, lse = fa.attend_lse(tq, tk, tv, tmask)
    delta = fa.delta_rows(o, tdo)
    ours = _k6_model(tq, tk[:, :, :n_valid], tv[:, :, :n_valid], tdo, lse,
                     delta)
    plain = fa.backward_dkv_plain(tq, tk, tv, tdo, lse, delta, tmask)
    jm = jnp.asarray(mask) if masked else None
    _, vjp = jax.vjp(lambda a, b, c: jax_model._attend(a, b, c, jm),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))[1:]]
    for name, a, p, r in zip(("dk", "dv"), ours, plain, ref):
        p, r = p[:, :, :n_valid].numpy(), r[:, :, :n_valid]
        a = a.numpy()
        for other in (p, r):
            err = np.abs(a - other).max() / np.abs(other).max()
            assert err <= 1e-5, (name, err)


def test_split3_is_exact_to_fp32():
    """The three parts add back to x within 2^-24 of |x| (the third part's
    rounding), and the first part is x rounded to bf16."""
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(4096)
                          * 10.0 ** np.arange(-3, 5).repeat(512)
                          ).astype(np.float32))
    x1, x2, x3 = _split3(x)
    assert torch.equal(x1, x.to(torch.bfloat16).float())
    back = (x1.double() + x2.double() + x3.double())
    assert ((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
