"""Port encoder (openhush_tpu_torch.models.whisper.model.encode) and its
attention against the JAX model. On the CPU the port's flash-attention
wrapper runs the kernel's plain version `attend`, a copy of model._attend;
JAX on the CPU takes its dense `_attend` too (the Pallas flash kernel is
TPU-only, see tests/test_flash_encoder.py).

Tolerances: attention 1e-5 in fp32 and 2e-2 in bf16 (one bf16 rounding of
O(1) outputs in either framework); encode in fp32 atol 1e-4 on
layer-normed features (fp32 sums in another order through the conv stem and
two blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.ops import flash_attention


@pytest.fixture(autouse=True)
def _erf_gelu(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_attend_matches_reference(dtype, atol, masked):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 3, 50, 64)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 1, 50, 50)) > 0.3 if masked else None
    jd = jnp.dtype(dtype)
    ref = jax_model._attend(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            None if mask is None else jnp.asarray(mask))
    td = getattr(torch, dtype)
    args = [torch.from_numpy(np.array(jnp.asarray(a, jd), np.float32)
                             ).to(td) for a in (q, k, v)]
    ours = flash_attention.attend(
        *args, None if mask is None else torch.from_numpy(mask))
    assert ours.dtype == td
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)
    if not masked:
        np.testing.assert_array_equal(
            flash_attention.flash_attention(*args).float().numpy(),
            ours.float().numpy())


def test_encode_fp32_matches_jax():
    cfg = CONFIGS["test"]
    jparams = jax_model.init_params(cfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    mel = np.random.default_rng(0).standard_normal(
        (1, 80, 3000)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_model.encode, static_argnums=0)(
        cfg, jparams, jnp.asarray(mel)))
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    with torch.no_grad():
        ours = model.encode(cfg, params, torch.from_numpy(mel))
    assert ours.shape == (1, cfg.n_audio_ctx, cfg.n_audio_state)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_weights_carry_over_and_init_layout():
    """from_numpy_params keeps the reference pytree; torch init_params
    builds the same names and shapes, with zero vocab padding rows."""
    cfg = CONFIGS["test"]
    jparams = jax_model.init_params(cfg, jax.random.PRNGKey(0),
                                    dtype=jnp.bfloat16)
    carried = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                        torch.bfloat16, "cpu")
    fresh = weights.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.bfloat16, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        a, b = carried, fresh
        for k in keys:
            a, b = a[k], b[k]
        assert a.dtype == b.dtype == torch.bfloat16
        assert tuple(a.shape) == tuple(b.shape) == leaf.shape, keys
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert float(fresh["decoder"]["tok_emb"][cfg.n_vocab:].abs().sum()) == 0
    np.testing.assert_array_equal(model.sinusoids(1500, 64),
                                  jax_model.sinusoids(1500, 64))
