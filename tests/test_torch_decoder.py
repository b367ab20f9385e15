"""Port decoder (openhush_tpu_torch.models.whisper.model.decode) against JAX
`decode` on the same weights and the same cross-KV, fp and int8, in the
three branches of the main path: the S=1 step and the short prefill (S=3)
of `_decode_flat_ro`, and the long prefill (S=80, S·H > 128) on head views,
at one shared pos and at per-row pos (S=70).

Both sides get the SAME cross-KV arrays (JAX's, carried over), so the int8
cases compare attention and not quantization. fp32 weights throughout.
Tolerances: logits atol 2e-4 (O(1) logits; fp32 sums in another order, and
with int8 cross-KV the probs' int8 rounding can move one level at a tie);
written cache rows atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.ops import quantize

CFG = CONFIGS["test"]
LOGIT_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _erf_gelu(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


@pytest.fixture(scope="module")
def setup():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    feats = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    xkv = {"fp": jax_model.compute_cross_kv(CFG, jparams, feats),
           "int8": jax_model.compute_cross_kv_quant(CFG, jparams, feats)}
    return jparams, params, feats, xkv


def _port_cross(jkv):
    t = lambda a: torch.from_numpy(np.array(a))
    if isinstance(jkv, jax_model.QuantKVCache):
        return model.QuantKVCache(t(jkv.k), t(jkv.k_scale), t(jkv.v),
                                  t(jkv.v_scale))
    return model.KVCache(t(jkv.k), t(jkv.v))


_decode_jit = jax.jit(jax_model.decode, static_argnums=0)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("S,steps", [(3, 2), (80, 1)])
def test_decode_matches_jax(setup, kind, S, steps):
    """Prefill S tokens at pos 0, then `steps - 1` single-token steps."""
    jparams, params, _, xkv = setup
    rng = np.random.default_rng(S)
    B, max_len = 2, 96
    jcache = jax_model.init_kv_cache(CFG, B, jnp.float32, max_len)
    cache = model.init_kv_cache(CFG, B, torch.float32, max_len)
    cross = _port_cross(xkv[kind])
    pos = 0
    for step in range(steps):
        n = S if step == 0 else 1
        toks = rng.integers(0, 50257, (B, n)).astype(np.int32)
        jl, jcache = _decode_jit(CFG, jparams, jnp.asarray(toks),
                                 jnp.int32(pos), jcache, xkv[kind])
        with torch.no_grad():
            tl, cache = model.decode(CFG, params,
                                     torch.from_numpy(toks).long(), pos,
                                     cache, cross)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape == (B, n, CFG.n_vocab_padded)
        np.testing.assert_allclose(tl.numpy()[..., :CFG.n_vocab],
                                   jl[..., :CFG.n_vocab], atol=LOGIT_ATOL)
        np.testing.assert_array_equal(tl.numpy()[..., CFG.n_vocab:],
                                      jl[..., CFG.n_vocab:])
        pos += n
        for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
            np.testing.assert_allclose(a.numpy()[:, :, :pos],
                                       np.asarray(b)[:, :, :pos], atol=1e-5)
            assert float(a[:, :, pos:].abs().sum()) == 0.0


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_long_prefill_per_row_pos_matches_jax(setup, kind):
    """The long prefill (S·H > 128: S = 70 on 2 heads) with per-row `pos`
    over a cache that already holds rows: the per-row causal mask and the
    per-row cache writes. Row 1's pos + S passes max_len, so its write
    starts at max_len - S (JAX's dynamic_update_slice clamps the start;
    the mask keeps the unclamped pos)."""
    jparams, params, _, xkv = setup
    rng = np.random.default_rng(70)
    B, S, max_len = 2, 70, 96
    pos = np.array([5, 40], np.int32)
    assert S * CFG.n_text_head > 128 and pos[1] + S > max_len
    shape = (CFG.n_text_layer, B, max_len, CFG.n_text_state)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    toks = rng.integers(0, 50257, (B, S)).astype(np.int32)
    jl, jcache = _decode_jit(CFG, jparams, jnp.asarray(toks),
                             jnp.asarray(pos), jax_model.KVCache(
                                 jnp.asarray(k0), jnp.asarray(v0)),
                             xkv[kind])
    cache = model.KVCache(torch.from_numpy(k0.copy()),
                          torch.from_numpy(v0.copy()))
    with torch.no_grad():
        tl, cache = model.decode(CFG, params, torch.from_numpy(toks).long(),
                                 torch.from_numpy(pos), cache,
                                 _port_cross(xkv[kind]))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (B, S, CFG.n_vocab_padded)
    np.testing.assert_allclose(tl.numpy()[..., :CFG.n_vocab],
                               jl[..., :CFG.n_vocab], atol=LOGIT_ATOL)
    for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # Rows before each write are untouched; row 1 was written from 26 on.
    np.testing.assert_array_equal(cache.k.numpy()[:, 0, :5], k0[:, 0, :5])
    np.testing.assert_array_equal(cache.k.numpy()[:, 1, :max_len - S],
                                  k0[:, 1, :max_len - S])


def test_single_step_after_prefill_int8(setup):
    """The S=1 cross path (_attend_decode_flat) after a prefill, int8."""
    jparams, params, _, xkv = setup
    B, max_len = 2, 64
    toks = np.array([[50258, 50259, 50359], [50258, 50260, 50359]], np.int32)
    nxt = np.array([[50364], [440]], np.int32)
    jcache = jax_model.init_kv_cache(CFG, B, jnp.float32, max_len)
    _, jcache = _decode_jit(CFG, jparams, jnp.asarray(toks), jnp.int32(0),
                            jcache, xkv["int8"])
    jl, _ = _decode_jit(CFG, jparams, jnp.asarray(nxt), jnp.int32(3),
                        jcache, xkv["int8"])
    cache = model.init_kv_cache(CFG, B, torch.float32, max_len)
    cross = _port_cross(xkv["int8"])
    with torch.no_grad():
        _, cache = model.decode(CFG, params, torch.from_numpy(toks).long(),
                                0, cache, cross)
        tl, _ = model.decode(CFG, params, torch.from_numpy(nxt).long(), 3,
                             cache, cross)
    np.testing.assert_allclose(tl.numpy()[..., :CFG.n_vocab],
                               np.asarray(jl)[..., :CFG.n_vocab],
                               atol=LOGIT_ATOL)


def test_cross_kv_matches_jax(setup):
    """compute_cross_kv and compute_cross_kv_quant on the same features:
    fp atol 1e-5; int8 scales rtol 1e-6, values within one level."""
    jparams, params, feats, xkv = setup
    f = torch.from_numpy(np.array(feats))
    with torch.no_grad():
        fp = model.compute_cross_kv(CFG, params, f)
        q = model.compute_cross_kv_quant(CFG, params, f)
    np.testing.assert_allclose(fp.k.numpy(), np.asarray(xkv["fp"].k),
                               atol=1e-5)
    np.testing.assert_allclose(fp.v.numpy(), np.asarray(xkv["fp"].v),
                               atol=1e-5)
    jq = xkv["int8"]
    for ours, ref in ((q.k_scale, jq.k_scale), (q.v_scale, jq.v_scale)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    for ours, ref in ((q.k, jq.k), (q.v, jq.v)):
        d = np.abs(ours.numpy().astype(np.int32)
                   - np.asarray(ref).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_cross_kv_quant_is_one_stacked_cache(setup):
    """compute_cross_kv_quant quantizes layer by layer into one stacked
    cache: layer l's slices are the per-head quantize of layer l's K and V
    (compute_cross_kv's), bit for bit, and the whole cache holds to JAX's
    compute_cross_kv_quant (scales rtol 1e-6, values within one level)."""
    jparams, params, feats, xkv = setup
    f = torch.from_numpy(np.array(feats))
    with torch.no_grad():
        fp = model.compute_cross_kv(CFG, params, f)
        q = model.compute_cross_kv_quant(CFG, params, f)
    L, H = CFG.n_text_layer, CFG.n_text_head
    assert q.k.shape == q.v.shape == fp.k.shape and q.k.dtype == torch.int8
    assert q.k_scale.shape == (L, *fp.k.shape[1:3], H)
    assert q.k.is_contiguous() and q.v_scale.is_contiguous()
    for l in range(L):
        for x, vals, scales in ((fp.k[l], q.k[l], q.k_scale[l]),
                                (fp.v[l], q.v[l], q.v_scale[l])):
            ref_q, ref_s = quantize.quantize_heads_plain(x, H)
            assert torch.equal(vals, ref_q) and torch.equal(scales, ref_s)
    jq = xkv["int8"]
    for ours, ref in ((q.k_scale, jq.k_scale), (q.v_scale, jq.v_scale)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    for ours, ref in ((q.k, jq.k), (q.v, jq.v)):
        d = np.abs(ours.numpy().astype(np.int32)
                   - np.asarray(ref).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_unported_options_raise(setup):
    """Beam groups (cross_group > 1) are ported: decode raises the
    reference's ValueErrors for a batch the group does not divide and for
    a group past one lane tile (parity in tests/test_torch_beam.py)."""
    _, params, _, xkv = setup
    cross = _port_cross(xkv["fp"])
    toks = torch.zeros(3, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        model.decode(CFG, params, toks, 0,
                     model.init_kv_cache(CFG, 3, torch.float32, 8),
                     model.KVCache(cross.k[:, :1], cross.v[:, :1]),
                     cross_group=2)
    big = 128 // CFG.n_text_head + 1
    with pytest.raises(ValueError, match="128"):
        model.decode(CFG, params, torch.zeros(big, 1, dtype=torch.long), 0,
                     model.init_kv_cache(CFG, big, torch.float32, 8),
                     model.KVCache(cross.k[:, :1], cross.v[:, :1]),
                     cross_group=big)
