"""Port M2M-100 (openhush_tpu_torch.models.m2m100) against the JAX
package's openhush_tpu/models/m2m100.py, at the reference test's tiny
config (tests/test_m2m100.py), both converted by their own
from_hf_state_dict from one seeded transformers
M2M100ForConditionalGeneration.

Tolerances: encoder features within atol 1e-5 on the non-pad positions
(padded rows differ only where masked out); decode logits within 1e-4
(|logits| up to ~10; fp32 sums in another order); greedy tokens equal; the
language table and positions equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from openhush_tpu.models import m2m100 as jm
from openhush_tpu_torch.models import m2m100 as m


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    hf_cfg = transformers.M2M100Config(
        vocab_size=1000, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128, max_position_embeddings=64,
        pad_token_id=1, bos_token_id=0, eos_token_id=2,
        decoder_start_token_id=2, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, scale_embedding=True)
    torch.manual_seed(0)
    hf = transformers.M2M100ForConditionalGeneration(hf_cfg).eval()
    kw = dict(name="paritytest", vocab_size=1000, d_model=64, n_heads=2,
              n_enc_layers=2, n_dec_layers=2, ffn_dim=128, max_positions=64,
              lang_token_base=900)
    sd = hf.state_dict()
    jcfg, cfg = jm.M2MConfig(**kw), m.M2MConfig(**kw)
    return (hf, jcfg, jm.from_hf_state_dict(sd, jcfg), cfg,
            m.from_hf_state_dict(sd, cfg, device="cpu"))


def _src(seed, B, S, pad_from=None):
    tokens = np.random.default_rng(seed).integers(3, 900, (B, S))
    if pad_from is not None:
        tokens[1, pad_from:] = m.PAD
    return tokens.astype(np.int64)


def test_conversion_matches_jax(pair):
    _, _, jparams, _, params = pair
    ref = jax.tree_util.tree_leaves_with_path(jparams)
    for path, r in ref:
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(r))
    assert params["tok_emb"].shape == (1024, 64)


def test_encode_matches_jax(pair):
    hf, jcfg, jparams, cfg, params = pair
    tokens = _src(0, 2, 10, pad_from=7)
    ref = np.asarray(jm.encode(jcfg, jparams, tokens.astype(np.int32)))
    with torch.no_grad():
        ours = m.encode(cfg, params, torch.from_numpy(tokens)).numpy()
    mask = tokens != m.PAD
    np.testing.assert_allclose(ours[mask], ref[mask], atol=1e-5)
    with torch.no_grad():
        theirs = hf.model.encoder(
            torch.from_numpy(tokens),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
        ).last_hidden_state.numpy()
    np.testing.assert_allclose(ours[mask], theirs[mask], atol=3e-4)


def test_decode_logits_match_jax(pair):
    """A prefill of 5 tokens and two single-token steps on the cache, with
    a padded source row: logits and the written cache."""
    _, jcfg, jparams, cfg, params = pair
    src = _src(1, 2, 8, pad_from=5)
    dec_in = _src(2, 2, 7)
    jsrc = jnp.asarray(src, jnp.int32)
    jfeats = jm.encode(jcfg, jparams, jsrc)
    jxkv = jm.compute_cross_kv(jcfg, jparams, jfeats)
    jcache = jm.init_kv_cache(jcfg, 2, max_len=8)
    with torch.no_grad():
        feats = m.encode(cfg, params, torch.from_numpy(src))
        xkv = m.compute_cross_kv(cfg, params, feats)
        cache = m.init_kv_cache(cfg, 2, max_len=8, device="cpu")
        for pos, (a, b) in ((0, (0, 5)), (5, (5, 6)), (6, (6, 7))):
            jl, jcache = jm.decode(jcfg, jparams,
                                   jnp.asarray(dec_in[:, a:b], jnp.int32),
                                   jnp.int32(pos), jcache, jxkv, jsrc)
            ours, cache = m.decode(cfg, params,
                                   torch.from_numpy(dec_in[:, a:b]), pos,
                                   cache, xkv, torch.from_numpy(src))
            assert ours.dtype == torch.float32
            assert ours.shape == (2, b - a, cfg.vocab_padded)
            np.testing.assert_allclose(ours[..., :1000].numpy(),
                                       np.asarray(jl)[..., :1000], atol=1e-4)
            assert bool((ours[..., 1000:] == m.NEG).all())
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)
    with pytest.raises(ValueError, match="past a cache"):
        m.decode(cfg, params, torch.from_numpy(dec_in[:, :2]), 7, cache,
                 xkv, torch.from_numpy(src))


def test_greedy_translate_matches_jax(pair):
    """Two rows, the second with a padded source: the same tokens."""
    _, jcfg, jparams, cfg, params = pair
    src = _src(3, 2, 9, pad_from=6)
    ref = np.asarray(jm.greedy_translate(jcfg, jparams,
                                         jnp.asarray(src, jnp.int32),
                                         jnp.int32(905), max_new=24))
    ours = m.greedy_translate(cfg, params, torch.from_numpy(src), 905,
                              max_new=24).numpy()
    assert ours.shape == (2, 24)
    np.testing.assert_array_equal(ours, ref)


def test_greedy_stops_once_every_row_has_emitted_eos(pair, monkeypatch):
    """With EOS the argmax at every step, both loops emit EOS then PAD, and
    the port's runs one decode after the prefill (the reference's
    while_loop body), not max_new."""
    _, jcfg, jparams, cfg, params = pair
    jparams = jax.tree.map(np.array, jparams)
    dec = jparams["decoder"]
    dec["ln_scale"][:] = 0
    dec["ln_bias"][:] = jparams["tok_emb"][m.EOS] * 50
    jparams["tok_emb"][m.EOS] *= 3
    tparams = m.from_numpy_params(jparams, device="cpu")
    src = _src(4, 2, 6)
    ref = np.asarray(jm.greedy_translate(jcfg, jparams,
                                         jnp.asarray(src, jnp.int32),
                                         jnp.int32(901), max_new=12))
    calls = []
    decode = m.decode
    monkeypatch.setattr(m, "decode", lambda *a: calls.append(1) or decode(*a))
    ours = m.greedy_translate(cfg, tparams, torch.from_numpy(src), 901,
                              max_new=12).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == m.EOS).all() and (ours[:, 1:] == m.PAD).all()
    assert len(calls) == 2


def test_language_table_and_positions():
    for code in ("af", "de", "zu", "ast"):
        assert (m.lang_token_id(m.CONFIGS["418M"], code)
                == jm.lang_token_id(jm.CONFIGS["418M"], code))
    assert m.lang_token_id(m.CONFIGS["418M"], "af") == 128004
    assert m.LANG_CODES == jm.LANG_CODES and len(m.LANG_CODES) == 100
    with pytest.raises(ValueError, match="unknown M2M-100 language"):
        m.lang_token_id(m.CONFIGS["418M"], "xx")
    for name, cfg in m.CONFIGS.items():
        assert cfg == m.M2MConfig(**vars(jm.CONFIGS[name]))
    assert m.CONFIGS["418M"].vocab_padded == 128128
    for n, d in ((10, 8), (7, 9), (66, 64)):
        np.testing.assert_array_equal(m.sinusoidal_positions(n, d),
                                      jm.sinusoidal_positions(n, d))
    tokens = np.asarray([[5, 6, 1, 1], [1, 7, 8, 9]])
    np.testing.assert_array_equal(
        m._position_ids(torch.from_numpy(tokens), 3).numpy(),
        np.asarray(jm._position_ids(jnp.asarray(tokens), 3)))


def test_init_params_layout_matches_jax():
    cfg = m.CONFIGS["test"]
    ours = m.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(lambda: jm.init_params(jm.CONFIGS["test"],
                                                jax.random.PRNGKey(0)))
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        node = ours
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == r.shape, path
    assert not ours["tok_emb"][cfg.vocab_size:].any()
    assert not ours["tok_emb"][m.PAD].any()


def test_translator_needs_a_converted_checkpoint(tmp_path, monkeypatch):
    """Without m2m100.npz in the models directory both packages'
    translators raise, naming the conversion command."""
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))

    class Cfg:
        target_language = "de"

    for translator in (m.M2M100Translator, jm.M2M100Translator):
        with pytest.raises(FileNotFoundError, match="convert-m2m100"):
            translator(Cfg())
