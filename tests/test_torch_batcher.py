"""The port's serving path (runtime/batcher.py, runtime/server.py,
runtime/longform.py and the multi-file CLI) against the JAX package and
against the port's own one-shot engine, on the "test" config in fp32.

Weights are JAX's `init_params` carried over with `from_numpy_params`. The
GELU choice is pinned to erf and the temperature ladder to (0.0,) on both
sides: at t > 0 the two packages draw different random numbers. Random
weights score avg_logprob ~ -log V, so the quality guards that would send
every window to the ladder are neutralized where a test is not about them.
Tolerances: tokens, positions and segments exact; logits atol 2e-4 against
JAX (as tests/test_torch_decoder.py: O(1) logits, fp32 sums in another
order) and 1e-5 between the port's own scalar and per-row paths;
sum_logprob rtol 1e-5."""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import batcher as jax_batcher
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models.whisper import decoding, model, weights
from openhush_tpu_torch.runtime import batcher, engine, longform, server
from openhush_tpu_torch.runtime.server import EngineServer
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from tests.test_torch_cli_support import cli_hooks  # noqa: F401

CFG = CONFIGS["test"]
MAX_NEW = 24
NO_GUARDS = dict(temperatures=(0.0,), logprob_threshold=-1e9,
                 no_speech_threshold=2.0)


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
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))


@pytest.fixture(scope="module")
def weights_pair():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    return jparams, params


@pytest.fixture(scope="module")
def cross_pair(weights_pair):
    """int8 cross-KV of two random feature windows, from JAX, carried over:
    the same arrays on both sides."""
    jparams, _ = weights_pair
    feats = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    jkv = jax_model.compute_cross_kv_quant(CFG, jparams, feats)
    t = lambda a: torch.from_numpy(np.array(a))
    return jkv, model.QuantKVCache(t(jkv.k), t(jkv.k_scale), t(jkv.v),
                                   t(jkv.v_scale))


def _audio(secs, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * (200 + 20 * seed) * t) \
        * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_decode_vector_pos_matches_scalar_and_jax(weights_pair, cross_pair):
    """Per-row-position decode equals scalar-position decode when every row
    shares the position, a row at its own position equals that row run
    alone, and both equal JAX `decode` with the same per-row positions."""
    jparams, params = weights_pair
    jkv, kv = cross_pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, (2, 3)).astype(np.int64)
    t2 = rng.integers(0, 1000, (2, 1)).astype(np.int64)
    with torch.no_grad():
        c1 = model.init_kv_cache(CFG, 2, torch.float32, 32)
        l1, c1 = model.decode(CFG, params, torch.from_numpy(toks), 0, c1, kv)
        c2 = model.init_kv_cache(CFG, 2, torch.float32, 32)
        l2, c2 = model.decode(CFG, params, torch.from_numpy(toks),
                              torch.zeros(2, dtype=torch.int64), c2, kv)
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)
        np.testing.assert_allclose(c1.k.numpy(), c2.k.numpy(), atol=1e-5)
        pos = torch.tensor([3, 7])
        l3, c3 = model.decode(CFG, params, torch.from_numpy(t2), pos, c2, kv)
        solo = model.init_kv_cache(CFG, 1, torch.float32, 32)
        kv0 = model.QuantKVCache(kv.k[:, :1], kv.k_scale[:, :1], kv.v[:, :1],
                                 kv.v_scale[:, :1])
        _, solo = model.decode(CFG, params, torch.from_numpy(toks[:1]), 0,
                               solo, kv0)
        l_solo, solo = model.decode(CFG, params, torch.from_numpy(t2[:1]), 3,
                                    solo, kv0)
    np.testing.assert_allclose(l3[0].numpy(), l_solo[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(c3.k[:, 0].numpy(), solo.k[:, 0].numpy(),
                               atol=1e-5)
    # Only each row's own position was written.
    assert float(c3.k[:, 1, 3:7].abs().sum()) == 0.0
    assert float(c3.k[:, 1, 7].abs().sum()) > 0.0

    jc = jax_model.init_kv_cache(CFG, 2, jnp.float32, 32)
    _, jc = jax_model.decode(CFG, jparams, jnp.asarray(toks, jnp.int32),
                             jnp.zeros(2, jnp.int32), jc, jkv)
    jl, jc = jax_model.decode(CFG, jparams, jnp.asarray(t2, jnp.int32),
                              jnp.asarray([3, 7], jnp.int32), jc, jkv)
    np.testing.assert_allclose(l3.numpy()[..., :CFG.n_vocab],
                               np.asarray(jl)[..., :CFG.n_vocab], atol=2e-4)
    np.testing.assert_allclose(c3.k.numpy(), np.asarray(jc.k), atol=1e-5)


def test_per_row_write_drops_past_max_len(weights_pair, cross_pair):
    """A per-row block that runs past the cache drops the rows beyond it
    (the reference's scatter mode="drop") and touches nothing else."""
    _, params = weights_pair
    _, kv = cross_pair
    with torch.no_grad():
        cache = model.init_kv_cache(CFG, 2, torch.float32, 8)
        cache.k[:, :, :6] = 1.0
        _, cache = model.decode(CFG, params, torch.tensor([[5, 6, 7]] * 2),
                                torch.tensor([6, 2]), cache, kv)
    assert bool((cache.k[:, 0, :6] == 1.0).all())     # row 0: 6, 7 written
    assert bool((cache.k[:, 0, 6:] != 1.0).all())
    assert bool((cache.k[:, 1, 2:5] != 1.0).all())    # row 1: 2..4
    # Per-row pos on the long prefill (S·H > 128) is ported: rows at one
    # offset give what the shared offset gives (JAX parity in
    # test_torch_decoder.py).
    toks = torch.zeros(2, 80, dtype=torch.int64)
    with torch.no_grad():
        per_row, c1 = model.decode(
            CFG, params, toks, torch.zeros(2, dtype=torch.int64),
            model.init_kv_cache(CFG, 2, torch.float32, 96), kv)
        shared, c2 = model.decode(
            CFG, params, toks, 0,
            model.init_kv_cache(CFG, 2, torch.float32, 96), kv)
    assert torch.equal(per_row, shared)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)


def test_admit_step_matches_jax_batcher(weights_pair, cross_pair):
    """Two slots admitted at different times (slot 1, four steps, slot 0),
    then steps: tokens, positions, lengths and finished flags equal the
    JAX batcher's at temperature 0; sum_logprob rtol 1e-5."""
    jparams, params = weights_pair
    jkv, kv = cross_pair
    tok = WhisperTokenizer(CFG.n_langs)
    prompt = tok.sot_sequence("en", "transcribe")
    suppress = decoding.build_suppress_mask(tok, CFG,
                                            decoding.DecodingOptions())
    blank = tok.encode(" ")[0]

    js = jax_batcher.init_state(CFG, n_slots=2, dtype=jnp.float32,
                                max_len=64)
    js = jax_batcher.admit(CFG, jparams, js, jnp.int32(1), jkv,
                           jnp.asarray([prompt], jnp.int32),
                           jnp.asarray(True), prompt_len=len(prompt),
                           row=jnp.int32(1))
    jstep = functools.partial(jax_batcher.step, CFG, jparams,
                              suppress_mask=jnp.asarray(suppress),
                              inner_steps=4, blank_token=blank)
    js = jstep(js)
    js = jax_batcher.admit(CFG, jparams, js, jnp.int32(0), jkv,
                           jnp.asarray([prompt], jnp.int32),
                           jnp.asarray(True), prompt_len=len(prompt),
                           row=jnp.int32(0))
    for _ in range(3):
        js = jstep(js)

    st = batcher.init_state(CFG, 2, dtype=torch.float32, max_len=64,
                            device="cpu")
    sup = torch.from_numpy(suppress)
    batcher.admit(CFG, params, st, 1, kv, prompt, True,
                  prompt_len=len(prompt), row=1)
    batcher.step(CFG, params, st, sup, inner_steps=4, blank_token=blank)
    batcher.admit(CFG, params, st, 0, kv, prompt, True,
                  prompt_len=len(prompt), row=0)
    for _ in range(3):
        batcher.step(CFG, params, st, sup, inner_steps=4, blank_token=blank)

    np.testing.assert_array_equal(st.tokens.numpy(), np.asarray(js.tokens))
    for name in ("pos", "length", "finished", "active", "ts_floor",
                 "rep_count"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_allclose(st.sum_logprob.numpy(),
                               np.asarray(js.sum_logprob), rtol=1e-5)
    np.testing.assert_allclose(st.no_speech.numpy(),
                               np.asarray(js.no_speech), atol=1e-6)
    assert int(st.length[1]) > 0


def test_state_bytes_and_unported_options(weights_pair):
    _, params = weights_pair
    st = batcher.init_state(CFG, 3, dtype=torch.float32, max_len=64,
                            audio_ctx=200, device="cpu")
    allocated = sum(t.numel() * t.element_size()
                    for t in vars(st).values() if torch.is_tensor(t))
    assert batcher.state_bytes(CFG, 3, dtype=torch.float32, max_len=64,
                               audio_ctx=200) == allocated
    assert st.xkv_k.shape == (CFG.n_text_layer, 3, 200, CFG.n_text_state)
    L, H = CFG.n_text_layer, CFG.n_text_head
    assert st.cache_ks.shape == st.cache_vs.shape == (L, 3, 1, 1)
    # The int8 self-cache: int8 values, [L, B, T, H] fp32 scales, and
    # state_bytes counts exactly what it allocates.
    s8 = batcher.init_state(CFG, 3, dtype=torch.float32, max_len=64,
                            audio_ctx=200, int8_self_cache=True,
                            device="cpu")
    assert s8.cache_k.dtype == s8.cache_v.dtype == torch.int8
    assert s8.cache_ks.shape == s8.cache_vs.shape == (L, 3, 64, H)
    assert s8.cache_ks.dtype == torch.float32
    allocated8 = sum(t.numel() * t.element_size()
                     for t in vars(s8).values() if torch.is_tensor(t))
    assert batcher.state_bytes(CFG, 3, dtype=torch.float32, max_len=64,
                               audio_ctx=200,
                               int8_self_cache=True) == allocated8 < allocated
    # Speculative serving is ported (tests/test_torch_spec_batcher.py): a
    # draft's state builds with SPEC_MARGIN more rows, spec_step runs (here
    # on no active slot: nothing moves), and EngineServer takes draft=.
    sd = batcher.init_state(CFG, 2, dtype=torch.float32, max_len=64,
                            draft_cfg=CFG, device="cpu")
    assert sd.tokens.shape == (2, 64 + batcher.SPEC_MARGIN)
    assert sd.d_cache_k.shape == (L, 2, 64 + batcher.SPEC_MARGIN,
                                  CFG.n_text_state)
    sup = torch.from_numpy(decoding.build_suppress_mask(
        WhisperTokenizer(CFG.n_langs), CFG, decoding.DecodingOptions()))
    batcher.spec_step(CFG, params, CFG, params, sd, sup, room_cap=63)
    assert int(sd.pos.sum()) == 0 and int(sd.length.sum()) == 0
    srv = EngineServer(CFG, params, n_slots=2, dtype=torch.float32,
                       max_decode_len=64, draft=(CFG, params))
    assert srv.draft_cfg is CFG and srv.state.d_cache_k.shape[0] == L
    # Beam serving is ported (tests/test_torch_beam_server.py).
    from openhush_tpu_torch.runtime.beam_server import BeamEngineServer
    srv = longform.make_server(CFG, params, WhisperTokenizer(CFG.n_langs),
                               n_files=2, beam_size=3, max_new_tokens=8,
                               dtype=torch.float32)
    assert isinstance(srv, BeamEngineServer) and srv.beam_size == 3
    assert srv.n_slots == 2 and srv.state.tokens.shape == (2, 3, 64)


def test_hbm_budget(weights_pair, monkeypatch):
    """The slot budgeter is off on the CPU and refuses slot counts that do
    not fit a stated capacity."""
    _, params = weights_pair
    assert server.device_hbm_limit("cpu") is None
    at = functools.partial(batcher.state_bytes, CFG, dtype=torch.float32,
                           max_len=64)
    assert server.hbm_fit_count(params, at) is None
    weight_bytes = server._nbytes(params)
    cap = int((weight_bytes + 2.5 * at(1)) / server.HBM_BUDGET_FRACTION) + 1
    monkeypatch.setenv("OPENHUSH_HBM_BYTES", str(cap))
    assert server.hbm_fit_count(params, at) == 2
    with pytest.raises(ValueError, match="largest slot count"):
        EngineServer(CFG, params, n_slots=3, dtype=torch.float32,
                     max_decode_len=64)
    s = longform.make_server(CFG, params, WhisperTokenizer(CFG.n_langs),
                             n_files=5, max_new_tokens=MAX_NEW,
                             dtype=torch.float32)
    assert s.n_slots == 2 and s.room_cap == 63


def _one_shot(params, monkeypatch, audios):
    """The port's one-shot engine with conditioning off, on the server's
    int8 cross-KV, with the quality guards off."""
    monkeypatch.setattr(engine, "LOGPROB_THRESHOLD", -1e9)
    monkeypatch.setattr(engine, "NO_SPEECH_THRESHOLD", 2.0)
    eng = engine.WhisperEngine("test", params=params, device="cpu",
                               language="en")
    monkeypatch.setattr(eng, "_cross_kv", lambda feats: (
        model.compute_cross_kv_quant(eng.cfg, eng.params, feats)))
    return eng, [eng.transcribe(a, language="en",
                                condition_on_previous_text=False,
                                max_new_tokens=MAX_NEW) for a in audios]


def _segments(result):
    return [(s.text, round(s.start, 6), round(s.end, 6), s.tokens)
            for s in result.segments]


def _server(eng, n_slots, **kw):
    plen = len(eng.tokenizer.sot_sequence("en", "transcribe"))
    return EngineServer(eng.cfg, eng.params, n_slots=n_slots, inner_steps=8,
                        dtype=torch.float32, tokenizer=eng.tokenizer,
                        max_decode_len=plen + MAX_NEW + 1,
                        max_admissions_per_turn=n_slots, **NO_GUARDS, **kw)


@pytest.mark.parametrize("threaded", [False, True])
def test_transcribe_files_matches_one_shot_engine(weights_pair, monkeypatch,
                                                  threaded):
    """Three files (two windows, one, one) over two slots through the
    server give the one-shot engine's segments, driven synchronously or by
    the server's own threads."""
    _, params = weights_pair
    audios = [_audio(35.0, 1), _audio(12.0, 2), _audio(20.0, 3)]
    eng, refs = _one_shot(params, monkeypatch, audios)
    srv = _server(eng, n_slots=2)
    interval = sys.getswitchinterval()
    if threaded:            # prep and step threads share the server's state
        sys.setswitchinterval(1e-5)
        srv.start()
    try:
        outs = longform.transcribe_files(srv, audios, language="en")
    finally:
        srv.stop()
        sys.setswitchinterval(interval)
    assert not (threaded and (srv._thread.is_alive()
                              or srv._prep_thread.is_alive()))
    for out, ref in zip(outs, refs):
        assert out.windows == ref.windows
        assert _segments(out) == _segments(ref)
        assert out.text == ref.text


def test_deep_stepping_token_exact(weights_pair):
    """deep_factor changes only how many steps run per turn: the tokens are
    those of deep_factor=1, and the deep path engages when every slot is
    busy (the last two windows, once the first two are done)."""
    _, params = weights_pair
    audios = [_audio(2.0, s) for s in range(4)]
    tok = WhisperTokenizer(CFG.n_langs)

    def run(deep_factor):
        srv = EngineServer(CFG, params, n_slots=2, inner_steps=4,
                           deep_factor=deep_factor, dtype=torch.float32,
                           tokenizer=tok, max_decode_len=48,
                           max_admissions_per_turn=2, **NO_GUARDS)
        sids = [srv.open_session() for _ in audios]
        for i, (sid, a) in enumerate(zip(sids, audios)):
            srv.submit_window(sid, a, window_id=i)
        out, turns = {}, 0
        while len(out) < len(audios) and turns < 300:
            srv.run_once()
            turns += 1
            for sid in sids:
                r = srv.poll(sid)
                if r is not None:
                    out[sid] = r.tokens
        assert len(out) == len(audios)
        return [out[sid] for sid in sids], srv.step_dispatches

    plain, n_plain = run(1)
    deep, n_deep = run(4)
    assert plain == deep and n_deep < n_plain


def test_first_window_qos_priority_and_reserve(weights_pair):
    """A new session's first window is admitted ahead of already-queued
    resubmissions; the reserve is active exactly while a first window is in
    flight; peek reads the in-flight window's tokens."""
    _, params = weights_pair
    srv = EngineServer(CFG, params, n_slots=4, inner_steps=2,
                       dtype=torch.float32, max_decode_len=32,
                       max_admissions_per_turn=4,
                       reserve_first_window=True, **NO_GUARDS)
    audio = _audio(1.0, 11)
    vets = [srv.open_session() for _ in range(4)]
    for s in vets:
        srv.submit_window(s, audio, window_id=0)
    done = set()
    for _ in range(400):
        srv.run_once()
        done |= {s for s in vets if srv.poll(s) is not None}
        if len(done) == 4:
            break
    assert len(done) == 4 and not srv._first_pending

    assert srv._regular_cap() == 4
    for s in vets:
        srv.submit_window(s, audio, window_id=1)
    srv.run_once()
    assert len(srv._slots) == 4
    partial = srv.peek(vets[0])     # one deep turn: 2 x 4 inner steps
    assert partial is not None and 0 < len(partial) <= 8

    newcomer = srv.open_session()
    srv.submit_window(newcomer, audio, window_id=0)
    assert srv._regular_cap() == 3
    for s in vets:
        srv.submit_window(s, audio, window_id=2)
    for _ in range(400):
        srv.run_once()
        with srv._lock:
            sessions = {i.session_id for i in srv._slots.values()}
        if newcomer in sessions:
            break
    assert newcomer in sessions
    with srv._lock:
        vet_w2 = sum(1 for i in srv._slots.values()
                     if i.session_id in vets and i.window_id == 2)
    assert vet_w2 <= 3
    assert not srv._first_pending and srv._regular_cap() == 4

    outstanding = {newcomer: 1, **{s: 2 for s in vets}}
    for _ in range(1200):
        srv.run_once()
        for s in list(outstanding):
            while srv.poll(s) is not None:
                outstanding[s] -= 1
            if outstanding[s] == 0:
                del outstanding[s]
        if not outstanding:
            break
    assert not outstanding


def test_ladder_retries_and_warmup(weights_pair):
    """With the guards on, random weights fail every rung: a window walks
    the whole ladder (a retry re-prefills from the slot's own cross-KV at
    the next temperature, sampling from its own generator) and comes back
    at the last rung. warmup() leaves no residue and refuses a started
    server."""
    _, params = weights_pair
    srv = EngineServer(CFG, params, n_slots=2, inner_steps=8,
                       dtype=torch.float32, max_decode_len=32,
                       temperatures=(0.0, 0.5, 1.0))
    srv.warmup()
    assert not srv._slots and srv.queue_depth() == 0
    sid = srv.open_session()
    srv.submit_window(sid, _audio(3.0, 4), language="en")
    res = None
    for _ in range(200):
        srv.run_once()
        res = srv.poll(sid)
        if res is not None:
            break
    assert res is not None and res.temperature == 1.0
    srv.start()
    try:
        with pytest.raises(RuntimeError):
            srv.warmup()
    finally:
        srv.stop()


def test_cli_several_files_json(tmp_path, monkeypatch, capsys, cli_hooks):
    """Several files go through the server (the one-shot engine's
    transcribe is never called) and come back as a JSON list, one entry per
    file with a "file" key, in order."""
    from openhush_tpu_torch import cli
    paths = []
    for i, secs in enumerate((1.5, 2.5, 1.25)):
        p = str(tmp_path / f"f{i}.wav")
        save_wav(p, _audio(secs, i))
        paths.append(p)

    def refuse(*a, **k):
        raise AssertionError("several files must not take the one-shot "
                             "engine")
    monkeypatch.setattr(engine.WhisperEngine, "transcribe", refuse)
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    rc = cli.main(["transcribe", *paths, "--model", "test", "--random-init",
                   "--dtype", "float32", "--device", "cpu", "--format",
                   "json", "--language", "en"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert [d["file"] for d in data] == paths
    assert [d["audio_duration_secs"] for d in data] == [1.5, 2.5, 1.25]
    assert all(d["model"] == "test" and d["language"] == "en" for d in data)
