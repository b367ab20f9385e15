"""The port's int8 rungs against the JAX package on the same numpy weights
("test" config, fp32): int8 decoder weights, the W8A8 encoder and the int8
self-cache, from the quantizers up through decode, the batcher and the
one-shot engine. JAX on the CPU takes its XLA branches (its Pallas
quantize kernel is TPU-only); the port's kernels run their plain versions.

Tolerances: weight and row scales rtol 1e-6 and int8 levels within one on
at most 1e-3 of the elements (the reference's /127 may compile to a
reciprocal multiply, one ulp off); _mm and _mm_i8 atol 1e-5 on the same
int8 inputs; W8A8 features median 1e-4, max 5e-2 (see its test);
logits atol 2e-4 (as tests/test_torch_decoder.py); written self-cache
levels within one, scales rtol 1e-5 (the new keys come out of layers of
fp32 sums in another order, ~1e-6 relative; the scale is their max / 127)
and, after a batcher's steps, rtol 1e-3 (an int8 prob level moved at a .5
tie moves the next layer's keys by ~1e-4); tokens and texts exact. Where a function takes quantized weights, both sides get
JAX's, carried over by from_numpy_params, so the comparison is of the
function and not of two quantizations."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import batcher as jax_batcher
from openhush_tpu.runtime import engine as jax_engine
from openhush_tpu_torch.models.whisper import decoding, model, weights
from openhush_tpu_torch.runtime import batcher, engine, longform, server
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small-shape tests: the decode
    loops run thousands of tiny ops, and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")
    monkeypatch.setattr(jax_engine, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))


def _carry(tree):
    return weights.from_numpy_params(jax.tree.map(np.asarray, tree),
                                     torch.float32, "cpu")


@pytest.fixture(scope="module")
def weights_pair():
    """(JAX params, the port's copy): fp32, and JAX's int8 rungs of them
    carried over."""
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    jq = jax_model.quantize_encoder_weights(
        jax_model.quantize_decoder_weights(jparams))
    return jparams, _carry(jparams), jq, _carry(jq)


@pytest.fixture(scope="module")
def cross_pair(weights_pair):
    """JAX's int8 cross-KV of two random feature windows (on the int8
    decoder weights), carried over."""
    _, _, jq, _ = weights_pair
    feats = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    jkv = jax_model.compute_cross_kv_quant(CFG, jq, feats)
    t = lambda a: torch.from_numpy(np.array(a))
    return jkv, model.QuantKVCache(t(jkv.k), t(jkv.k_scale), t(jkv.v),
                                   t(jkv.v_scale))


def assert_levels(ours, ref):
    """int8 levels within one, on at most 1e-3 of the elements."""
    d = np.abs(np.asarray(ours, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def assert_quantized_like(ours, ref):
    """An int8 weight dict against JAX's: levels and scales."""
    assert ours["q"].dtype == torch.int8 and ours["s"].dtype == torch.float32
    assert tuple(ours["q"].shape) == ref["q"].shape
    np.testing.assert_allclose(ours["s"].numpy(), np.asarray(ref["s"]),
                               rtol=1e-6)
    assert_levels(ours["q"].numpy(), ref["q"])


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_quantize_weights_match_jax(weights_pair, part):
    """quantize_{decoder,encoder}_weights quantize every *_w matrix of that
    part's layers as JAX does, leave every other leaf (and the other part)
    the same tensor, and a second call changes nothing."""
    jparams, params, _, _ = weights_pair
    fn = {"decoder": model.quantize_decoder_weights,
          "encoder": model.quantize_encoder_weights}[part]
    jfn = {"decoder": jax_model.quantize_decoder_weights,
           "encoder": jax_model.quantize_encoder_weights}[part]
    ours, ref = fn(params), jfn(jparams)
    layers = ours[part]["layers"]
    for name, w in layers.items():
        if name.endswith("_w"):
            assert_quantized_like(w, ref[part]["layers"][name])
        else:
            assert w is params[part]["layers"][name]
    assert {n for n, w in layers.items() if isinstance(w, dict)} == {
        n for n, w in ref[part]["layers"].items() if isinstance(w, dict)}
    other = "encoder" if part == "decoder" else "decoder"
    assert ours[other] is params[other]
    for name, leaf in ours[part].items():
        if name != "layers":
            assert leaf is params[part][name]
    again = fn(ours)
    assert all(again[part]["layers"][n] is w for n, w in layers.items())
    # The server's budgeter counts an int8 weight at one byte a level plus
    # its fp32 scales.
    saved = sum(3 * w["q"].numel() - w["s"].numel() * 4
                for w in layers.values() if isinstance(w, dict))
    assert server._nbytes(ours) == server._nbytes(params) - saved
    # The carried JAX tree keeps int8 levels and fp32 scales.
    carried = weights.from_numpy_params(
        jax.tree.map(np.asarray, ref), torch.bfloat16, "cpu")
    w = carried[part]["layers"]["q_w"]
    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32


def test_quantize_rows_and_products_match_jax(weights_pair):
    """_quantize_rows (levels within one, scales rtol 1e-6); _mm_i8 and _mm
    on an int8 weight, on the same int8 inputs (atol 1e-5)."""
    _, _, jq, pq = weights_pair
    x = (np.random.default_rng(1).standard_normal((2, 37, 64)) * 3
         ).astype(np.float32)
    x8, xs = model._quantize_rows(torch.from_numpy(x))
    j8, js = jax_model._quantize_rows(jnp.asarray(x))
    assert x8.dtype == torch.int8 and xs.dtype == torch.float32
    assert_levels(x8.numpy(), j8)
    np.testing.assert_allclose(xs.numpy(), np.asarray(js), rtol=1e-6)
    for name in ("q_w", "fc1_w", "fc2_w"):
        jw = jax.tree.map(lambda a: a[0], jq["encoder"]["layers"][name])
        w = model._layers(pq["encoder"]["layers"])[0][name]
        rows = (x8 if name != "fc2_w"
                else torch.from_numpy(np.array(j8)).repeat(1, 1, 4))
        jrows = jnp.asarray(rows.numpy())
        ours = model._mm_i8(rows, xs, w)
        ref = jax_model._mm_i8(jrows, js, jw)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        xf = torch.from_numpy(np.asarray(jrows, np.float32) / 100)
        np.testing.assert_allclose(
            model._mm(xf, w).numpy(),
            np.asarray(jax_model._mm(jnp.asarray(xf.numpy()), jw)),
            atol=1e-5)


def test_encode_w8a8_matches_jax(weights_pair):
    """encode with int8 encoder weights runs the W8A8 block on both sides.
    Features: median abs error <= 1e-4 (8e-6 here) and max <= 5e-2
    (2.5e-2 here); the W8A8 features lie 6e-3 (median) from the dense ones,
    so both bounds sit well inside the rung's own error. The tail is level
    flips, not another function: fp32 sums in another order (~1e-7) move
    an activation's int8 level at a .5 tie, which moves its row by one
    level of the row's scale, and the next layer's attention spreads that
    to every row (JAX jit against JAX eager, on this input, already differ
    by 1.6e-3)."""
    _, _, jq, pq = weights_pair
    mel = np.random.default_rng(0).standard_normal(
        (1, 80, 3000)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_model.encode, static_argnums=0)(
        CFG, jq, jnp.asarray(mel)))
    with torch.no_grad():
        ours = model.encode(CFG, pq, torch.from_numpy(mel))
    assert ours.shape == (1, CFG.n_audio_ctx, CFG.n_audio_state)
    err = np.abs(ours.numpy() - ref)
    assert np.median(err) <= 1e-4 and err.max() <= 5e-2, (
        np.median(err), err.max())


_decode_jit = jax.jit(jax_model.decode, static_argnums=0)


def _assert_cache_like(cache, jcache, scale_rtol=1e-5):
    for ours, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert ours.dtype == torch.int8
        assert_levels(ours.numpy(), ref)
    for ours, ref in ((cache.k_scale, jcache.k_scale),
                      (cache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=scale_rtol)


@pytest.mark.parametrize("case", ["flat S=1", "flat S=3", "per-row pos",
                                  "long prefill", "long per-row"])
@pytest.mark.parametrize("rung", ["dense weights", "int8 weights"])
def test_decode_int8_self_cache_matches_jax(weights_pair, cross_pair, case,
                                            rung):
    """decode over init_quant_kv_cache: a prefill, then a step, on the flat
    path (S·H <= 128: S = 1 after a 3-token prefill, S = 3 after it, and a
    step at per-row positions) and on the long prefill (S = 80, S·H = 160;
    at a shared and at per-row positions): logits atol 2e-4, the written
    cache's levels within one and scales rtol 1e-5."""
    jparams, params, jq, pq = weights_pair
    if rung == "int8 weights":
        jparams, params = jq, pq
    jkv, kv = cross_pair
    B, max_len = 2, 96
    rng = np.random.default_rng(3)
    S0 = 80 if case.startswith("long") else 3
    S1 = {"flat S=1": 1, "flat S=3": 3, "per-row pos": 1,
          "long prefill": 1, "long per-row": 80}[case]
    first = rng.integers(0, 1000, (B, S0)).astype(np.int64)
    nxt = rng.integers(0, 1000, (B, S1)).astype(np.int64)
    pos = {"per-row pos": np.array([S0, S0 - 2]),
           "long per-row": np.array([0, 5])}.get(case, S0)
    if case == "long per-row":       # both calls at per-row positions
        first_pos = np.array([0, 0])
    else:
        first_pos = 0

    jc = jax_model.init_quant_kv_cache(CFG, B, max_len)
    jl0, jc = _decode_jit(CFG, jparams, jnp.asarray(first, jnp.int32),
                          jnp.asarray(first_pos, jnp.int32), jc, jkv)
    jl1, jc = _decode_jit(CFG, jparams, jnp.asarray(nxt, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc, jkv)
    cache = model.init_quant_kv_cache(CFG, B, max_len)
    as_pos = lambda p: torch.from_numpy(p) if isinstance(p, np.ndarray) else p
    with torch.no_grad():
        l0, cache = model.decode(CFG, params, torch.from_numpy(first),
                                 as_pos(first_pos), cache, kv)
        l1, cache = model.decode(CFG, params, torch.from_numpy(nxt),
                                 as_pos(pos), cache, kv)
    assert isinstance(cache, model.QuantKVCache)
    for ours, ref in ((l0, jl0), (l1, jl1)):
        np.testing.assert_allclose(ours.numpy()[..., :CFG.n_vocab],
                                   np.asarray(ref)[..., :CFG.n_vocab],
                                   atol=LOGIT_ATOL)
    _assert_cache_like(cache, jc)


def test_batcher_int8_self_cache_matches_jax(weights_pair, cross_pair):
    """init_state(int8_self_cache=True) allocates int8 values and [L, B, T,
    H] scales; two slots admitted at different times, then steps, on the
    int8 rung's weights: tokens, positions and lengths equal the JAX
    batcher's, sum_logprob rtol 1e-5, the next logits atol 2e-4; the
    self-cache's levels within one, its scales rtol 1e-3."""
    _, _, jq, pq = weights_pair
    jkv, kv = cross_pair
    tok = WhisperTokenizer(CFG.n_langs)
    prompt = tok.sot_sequence("en", "transcribe")
    suppress = decoding.build_suppress_mask(tok, CFG,
                                            decoding.DecodingOptions())
    blank = tok.encode(" ")[0]

    js = jax_batcher.init_state(CFG, n_slots=2, dtype=jnp.float32,
                                max_len=64, int8_self_cache=True)
    jstep = functools.partial(jax_batcher.step, CFG, jq,
                              suppress_mask=jnp.asarray(suppress),
                              inner_steps=4, blank_token=blank)
    st = batcher.init_state(CFG, 2, dtype=torch.float32, max_len=64,
                            int8_self_cache=True, device="cpu")
    L, H = CFG.n_text_layer, CFG.n_text_head
    assert st.cache_k.dtype == torch.int8
    assert st.cache_ks.shape == st.cache_vs.shape == (L, 2, 64, H)
    sup = torch.from_numpy(suppress)
    for slot in (1, 0):
        js = jax_batcher.admit(CFG, jq, js, jnp.int32(slot), jkv,
                               jnp.asarray([prompt], jnp.int32),
                               jnp.asarray(True), prompt_len=len(prompt),
                               row=jnp.int32(slot))
        batcher.admit(CFG, pq, st, slot, kv, prompt, True,
                      prompt_len=len(prompt), row=slot)
        js = jstep(js)
        batcher.step(CFG, pq, st, sup, inner_steps=4, blank_token=blank)
    for _ in range(2):
        js = jstep(js)
        batcher.step(CFG, pq, st, sup, inner_steps=4, blank_token=blank)

    np.testing.assert_array_equal(st.tokens.numpy(), np.asarray(js.tokens))
    for name in ("pos", "length", "finished", "active"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_allclose(st.sum_logprob.numpy(),
                               np.asarray(js.sum_logprob), rtol=1e-5)
    live = np.isfinite(np.asarray(js.last_logits))
    np.testing.assert_allclose(st.last_logits.numpy()[live],
                               np.asarray(js.last_logits)[live],
                               atol=LOGIT_ATOL)
    assert int(st.length.min()) > 0
    ours = model.QuantKVCache(st.cache_k, st.cache_ks, st.cache_v,
                              st.cache_vs)
    _assert_cache_like(ours, jax_model.QuantKVCache(
        js.cache_k, js.cache_ks, js.cache_v, js.cache_vs), scale_rtol=1e-3)


def _audio(secs, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * (200 + 20 * seed) * t) \
        * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _segments(result):
    return [(s.text, round(s.start, 6), round(s.end, 6), s.tokens)
            for s in result.segments]


@pytest.mark.parametrize("encoder", [False, True])
def test_engine_int8_weights_matches_jax(weights_pair, encoder):
    """The one-shot engine quantizing the same fp32 weights itself (decoder,
    and the W8A8 encoder too): the JAX engine's segments and text."""
    jparams, params, _, _ = weights_pair
    audio = _audio(12.0, 7)
    kw = dict(quantize_weights=True, quantize_encoder=encoder)
    ref = jax_engine.WhisperEngine("test", params=jparams, **kw).transcribe(
        audio, language="en", max_new_tokens=24)
    eng = engine.WhisperEngine("test", params=params, device="cpu", **kw)
    assert isinstance(eng.params["decoder"]["layers"]["q_w"], dict)
    assert isinstance(eng.params["encoder"]["layers"]["q_w"], dict) == encoder
    ours = eng.transcribe(audio, language="en", max_new_tokens=24)
    assert _segments(ours) == _segments(ref)
    assert ours.text == ref.text


def test_int8_server_transcribe_files_matches_jax(weights_pair):
    """transcribe_files through an int8-self-cache EngineServer on int8
    decoder weights, against the JAX server built the same way: the same
    windows and segments."""
    from openhush_tpu.runtime import longform as jax_longform
    from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
    _, _, jq, pq = weights_pair
    audios = [_audio(35.0, 1), _audio(12.0, 2)]
    guards = dict(logprob_threshold=-1e9, no_speech_threshold=2.0)
    jsrv = jax_longform.make_server(CFG, jq, JaxTokenizer(CFG.n_langs),
                                    n_files=2, max_new_tokens=24,
                                    dtype=jnp.float32, int8_self_cache=True,
                                    **guards)
    refs = jax_longform.transcribe_files(jsrv, audios, language="en")
    srv = longform.make_server(CFG, pq, WhisperTokenizer(CFG.n_langs),
                               n_files=2, max_new_tokens=24,
                               dtype=torch.float32, temperatures=(0.0,),
                               int8_self_cache=True, **guards)
    assert srv.state.cache_k.dtype == torch.int8
    outs = longform.transcribe_files(srv, audios, language="en")
    for out, ref in zip(outs, refs):
        assert out.windows == ref.windows
        assert _segments(out) == _segments(ref)


def test_cli_under_the_int8_rung(tmp_path, monkeypatch, capsys):
    """`cli transcribe` of two files under OPENHUSH_INT8_RUNG=1 runs the
    server on int8 decoder weights with an int8 self-cache, and prints a
    JSON list, one entry per file."""
    from openhush_tpu_torch import cli
    from openhush_tpu_torch.audio.wav import save_wav
    wavs = []
    for i, secs in enumerate((1.5, 2.5)):
        wavs.append(str(tmp_path / f"a{i}.wav"))
        save_wav(wavs[-1], _audio(secs, 20 + i))
    servers = []
    make_server = longform.make_server

    def spy(*args, **kw):
        servers.append(make_server(*args, **kw))
        return servers[-1]

    monkeypatch.setattr(longform, "make_server", spy)
    for name in ("OPENHUSH_INT8_WEIGHTS", "OPENHUSH_INT8_ENCODER",
                 "OPENHUSH_INT8_SELF_CACHE", "OPENHUSH_DRAFT_MODEL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OPENHUSH_INT8_RUNG", "1")
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    rc = cli.main(["transcribe", *wavs, "--model", "test", "--random-init",
                   "--dtype", "float32", "--device", "cpu", "--format",
                   "json", "--language", "en"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert [d["file"] for d in data] == wavs
    (srv,) = servers
    assert srv.state.cache_k.dtype == torch.int8
    assert isinstance(srv.params["decoder"]["layers"]["q_w"], dict)
    assert not isinstance(srv.params["encoder"]["layers"]["q_w"], dict)
