"""The port's one-shot speculative decoding (models/whisper/speculative.py,
the engine's draft model, the CLI's --draft) against the JAX package's
speculative loop and the port's own greedy loop, on the "test" config and
the 1-layer "test-draft" in fp32 (JAX's weights carried over).

Every emitted token is the big model's filtered argmax, so the output is
the greedy loop's for any draft: a random one (which rarely matches) and
the big model itself (which matches nearly always, so the accept chain,
the window write and the rollback run several tokens deep). Tolerances
are the JAX package's tests/test_speculative.py's: tokens and lengths
exact, sum_logprob atol 2e-3, no_speech_prob atol 1e-5."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper import speculative as jax_spec
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu_torch.models.whisper import (decoding, model, speculative,
                                               weights)
from openhush_tpu_torch.runtime import engine
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
DCFG = CONFIGS["test-draft"]
TOK = WhisperTokenizer(CFG.n_langs)
BLANK = TOK.encode(" ")[0]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the loops run many tiny ops, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))
    monkeypatch.delenv("OPENHUSH_DRAFT_MODEL", raising=False)
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))


def _to_torch(jparams):
    return weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     torch.float32, "cpu")


@pytest.fixture(scope="module")
def setup():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    jdraft = jax_model.init_params(DCFG, jax.random.PRNGKey(7),
                                   dtype=jnp.float32)
    feats = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    return (jparams, _to_torch(jparams), jdraft, _to_torch(jdraft), feats)


def _port_kv(kv):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if isinstance(kv, jax_model.QuantKVCache):
        return model.QuantKVCache(t(kv.k), t(kv.k_scale), t(kv.v),
                                  t(kv.v_scale))
    return model.KVCache(t(kv.k), t(kv.v))


def _common(prompt_len, max_new, timestamps):
    return dict(prompt_len=prompt_len, max_new=max_new,
                use_timestamps=timestamps, suppress_blank=True,
                max_initial_index=50, blank_token=int(BLANK))


def _suppress(timestamps):
    opts = decoding.DecodingOptions(without_timestamps=not timestamps)
    return decoding.build_suppress_mask(TOK, CFG, opts)


def _port_loops(params, dcfg, dparams, xkv, dxkv, prompt, suppress, *,
                max_new, timestamps, k_spec):
    """The port's greedy and speculative loops on the same inputs →
    (greedy outputs, speculative outputs, verify passes)."""
    B, P = prompt.shape
    L = P + max_new + k_spec
    common = _common(P, max_new, timestamps)
    sup = torch.from_numpy(suppress)
    with torch.no_grad():
        g = decoding.greedy_loop(
            CFG, params, xkv, model.init_kv_cache(CFG, B, max_len=L),
            prompt, sup, 0.0, None, **common)
        before = speculative.speculative_greedy_loop.verifies
        s = speculative.speculative_greedy_loop(
            CFG, params, dcfg, dparams, xkv, dxkv,
            model.init_kv_cache(CFG, B, max_len=L),
            model.init_kv_cache(dcfg, B, max_len=L), prompt, sup,
            k_spec=k_spec, **common)
    return g, s, speculative.speculative_greedy_loop.verifies - before


@pytest.mark.parametrize("B,k_spec", [(1, 6), (2, 4), (2, 5)])
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("timestamps", [False, True])
def test_loop_matches_jax_and_greedy(setup, timestamps, kind, B, k_spec):
    """The port's speculative loop gives the JAX speculative loop's tokens,
    lengths, sum_logprob and no_speech_prob on the same weights and
    cross-KV (fp or int8), and the port's greedy loop's tokens."""
    jparams, params, jdraft, dparams, feats = setup
    feats = feats[:B]
    jxkv = (jax_model.compute_cross_kv_quant(CFG, jparams, feats)
            if kind == "int8" else
            jax_model.compute_cross_kv(CFG, jparams, feats))
    jdxkv = jax_model.compute_cross_kv(DCFG, jdraft, feats)
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=timestamps)
    parr = np.tile(np.asarray(prompt, np.int32), (B, 1))
    suppress = _suppress(timestamps)
    max_new = 28
    L = len(prompt) + max_new + k_spec
    ref = jax_spec.speculative_greedy_loop(
        CFG, jparams, DCFG, jdraft, jxkv, jdxkv,
        jax_model.init_kv_cache(CFG, B, max_len=L),
        jax_model.init_kv_cache(DCFG, B, max_len=L), jnp.asarray(parr),
        jnp.asarray(suppress), k_spec=k_spec,
        **_common(len(prompt), max_new, timestamps))
    g, s, _ = _port_loops(params, DCFG, dparams, _port_kv(jxkv),
                          _port_kv(jdxkv), torch.from_numpy(parr).long(),
                          suppress, max_new=max_new, timestamps=timestamps,
                          k_spec=k_spec)
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(s[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(s[1].numpy(), np.asarray(ref[1]), atol=2e-3)
    np.testing.assert_allclose(s[3].numpy(), np.asarray(ref[3]), atol=1e-5)
    np.testing.assert_array_equal(s[0].numpy(), g[0].numpy())
    np.testing.assert_array_equal(s[2].numpy(), g[2].numpy())
    np.testing.assert_allclose(s[1].numpy(), g[1].numpy(), atol=2e-3)


def _fp_inputs(setup, B=2, timestamps=True):
    jparams, params, jdraft, dparams, feats = setup
    xkv = _port_kv(jax_model.compute_cross_kv(CFG, jparams, feats[:B]))
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=timestamps)
    parr = torch.tensor([prompt] * B)
    return params, xkv, parr


def test_different_drafts_same_output(setup):
    """The output does not depend on the draft's weights."""
    jparams, params, jdraft, dparams, feats = setup
    other = _to_torch(jax_model.init_params(DCFG, jax.random.PRNGKey(99),
                                            dtype=jnp.float32))
    params, xkv, parr = _fp_inputs(setup)
    outs = []
    for dp in (dparams, other):
        dxkv = model.compute_cross_kv(DCFG, dp, torch.from_numpy(
            np.array(feats)))
        outs.append(_port_loops(params, DCFG, dp, xkv, dxkv, parr,
                                _suppress(True), max_new=28, timestamps=True,
                                k_spec=4)[1])
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][2].numpy(), outs[1][2].numpy())


@pytest.mark.parametrize("timestamps", [False, True])
def test_self_draft_emits_blocks(setup, timestamps):
    """The big model as its own draft: the same tokens as greedy, and more
    than 2 tokens emitted per verify pass on average (the multi-token
    accept chain, window write and rollback, which a random draft rarely
    reaches)."""
    params, xkv, parr = _fp_inputs(setup, timestamps=timestamps)
    g, s, verifies = _port_loops(params, CFG, params, xkv, xkv, parr,
                                 _suppress(timestamps), max_new=40,
                                 timestamps=timestamps, k_spec=4)
    np.testing.assert_array_equal(s[0].numpy(), g[0].numpy())
    np.testing.assert_array_equal(s[2].numpy(), g[2].numpy())
    # Every token but each row's first comes out of a verify pass.
    per_verify = float((s[2] - 1).sum()) / (verifies * parr.shape[0])
    assert verifies > 0 and per_verify > 2.0, per_verify


def test_long_prompt_cache_past_n_text_ctx(setup):
    """A long previous-text prompt and a max-length decode (EOT suppressed:
    prompt 228, max_new 219, K=5) write blocks up to prompt + max_new + 3,
    past n_text_ctx; decode_speculative's sizing (no n_text_ctx clamp)
    gives a 512-row cache, and the tokens are greedy's to the last."""
    jparams, params, jdraft, dparams, feats = setup
    params, xkv, _ = _fp_inputs(setup, B=1, timestamps=False)
    dxkv = model.compute_cross_kv(DCFG, dparams,
                                  torch.from_numpy(np.array(feats[:1])))
    sot = TOK.sot_sequence("en", "transcribe", timestamps=False)
    prev = np.random.default_rng(3).integers(100, 5000,
                                             228 - len(sot)).tolist()
    prompt = torch.tensor([prev + sot])
    k_spec = 5
    max_new = CFG.n_text_ctx - prompt.shape[1] - 1            # 219
    suppress = _suppress(False)
    suppress[TOK.special.eot] = True
    P = prompt.shape[1]
    cache_len = ((P + max_new + k_spec + 63) // 64) * 64
    assert cache_len == 512 > CFG.n_text_ctx
    common = _common(P, max_new, False)
    sup = torch.from_numpy(suppress)
    with torch.no_grad():
        g = decoding.greedy_loop(
            CFG, params, xkv, model.init_kv_cache(CFG, 1, max_len=P + max_new),
            prompt, sup, 0.0, None, **common)
        s = speculative.speculative_greedy_loop(
            CFG, params, DCFG, dparams, xkv, dxkv,
            model.init_kv_cache(CFG, 1, max_len=cache_len),
            model.init_kv_cache(DCFG, 1, max_len=cache_len), prompt, sup,
            k_spec=k_spec, **common)
    np.testing.assert_array_equal(s[0].numpy(), g[0].numpy())
    assert int(s[2][0]) == int(g[2][0]) == max_new


def _audio(secs, seed):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal(int(16000 * secs))).astype(np.float32)


def _save_npz(path, jparams):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(jparams, "")
    np.savez(path, **flat)


def test_engine_with_draft_matches_plain(setup, monkeypatch, tmp_path):
    """WhisperEngine(draft_model="test-draft"): the seek loop, the T=0 rung
    through decode_speculative, the segments; the same text and segment
    tokens as the plain engine. The draft loads from
    OPENHUSH_MODEL_DIR/test-draft.npz (else random weights seeded 1 under
    allow_random_init; OPENHUSH_DRAFT_MODEL names it too)."""
    jparams, params, jdraft, dparams, feats = setup
    calls = []
    decode_spec = speculative.decode_speculative
    monkeypatch.setattr(speculative, "decode_speculative", lambda *a, **k: (
        calls.append(1), decode_spec(*a, **k))[1])
    audio = _audio(4.0, 11)
    plain = engine.WhisperEngine("test", params=params, device="cpu",
                                 language="en")
    _save_npz(tmp_path / "test-draft.npz", jdraft)
    spec = engine.WhisperEngine("test", params=params, device="cpu",
                                language="en", draft_model="test-draft")
    assert spec.draft_cfg.n_text_layer == 1
    np.testing.assert_array_equal(
        spec.draft_params["decoder"]["tok_emb"].numpy(),
        dparams["decoder"]["tok_emb"].numpy())
    r1 = plain.transcribe(audio, max_new_tokens=48)
    r2 = spec.transcribe(audio, max_new_tokens=48)
    assert calls and r1.windows == r2.windows
    assert r1.text == r2.text
    assert [s.tokens for s in r1.segments] == [s.tokens for s in r2.segments]
    # The variable names the draft; random weights need allow_random_init.
    os.remove(tmp_path / "test-draft.npz")
    monkeypatch.setenv("OPENHUSH_DRAFT_MODEL", "test-draft")
    rnd = engine.WhisperEngine("test", params=params, device="cpu",
                               allow_random_init=True)
    assert rnd.draft_cfg.name == "test-draft"
    assert rnd.draft_params is not None
    assert engine.WhisperEngine("test", params=params,
                                device="cpu").draft_params is None


def test_engine_incompatible_draft_degrades(setup, caplog):
    """A draft whose vocab or encoder differs ("base") is disabled with
    the reference's warning; the plain path runs."""
    params = setup[1]
    with caplog.at_level(logging.WARNING):
        eng = engine.WhisperEngine("test", params=params, device="cpu",
                                   allow_random_init=True,
                                   draft_model="base")
    assert eng.draft_params is None and eng.draft_cfg is None
    assert "incompatible" in caplog.text
    assert eng.transcribe(_audio(1.0, 2), max_new_tokens=8) is not None


def test_cli_draft_one_file(monkeypatch, capsys):
    """`transcribe FILE --draft test-draft` runs the one-shot engine with
    the draft (its T=0 rung speculative); the transcript equals the one
    without --draft."""
    from openhush_tpu_torch import cli
    calls = []
    decode_spec = speculative.decode_speculative
    monkeypatch.setattr(speculative, "decode_speculative", lambda *a, **k: (
        calls.append(1), decode_spec(*a, **k))[1])
    path = os.path.join(REPO, "tests", "data", "speechlike.wav")
    outs = []
    for extra in ([], ["--draft", "test-draft"]):
        rc = cli.main(["transcribe", path, "--model", "test",
                       "--random-init", "--dtype", "float32", "--device",
                       "cpu", "--format", "json", *extra])
        assert rc == 0
        outs.append(capsys.readouterr().out)
    assert len(calls) >= 1
    import json
    a, b = (json.loads(o) for o in outs)
    assert a["text"] == b["text"] and a["language"] == b["language"]
