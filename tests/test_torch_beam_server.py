"""The port's beam serving (runtime/beam_batcher.py, runtime/beam_server.py,
longform.make_server(beam_size=...) and the CLI's --beam-size) against the
JAX package's beam batcher and against the port's own one-shot beam search
and greedy batcher ("test" config, fp32; JAX's weights carried over).

The temperature ladder is pinned to (0.0,) and the GELU to erf where a test
compares with JAX; best-of sampling rows are compared with the port's
greedy batcher on the same generators, since the port cannot draw JAX's
random numbers. Tolerances: tokens exact; scores atol 1e-5 (fp32 sums in
another order); logits atol 2e-4 against JAX (as
tests/test_torch_decoder.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import beam_batcher as jax_beam_batcher
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models.whisper import beam, decoding, model, weights
from openhush_tpu_torch.ops import mel as mel_ops
from openhush_tpu_torch.runtime import (batcher, beam_batcher, engine,
                                        longform)
from openhush_tpu_torch.runtime.beam_server import BeamEngineServer
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
NO_GUARDS = dict(temperatures=(0.0,), logprob_threshold=-1e9,
                 no_speech_threshold=2.0)
TOK = WhisperTokenizer(CFG.n_langs)
BLANK = TOK.encode(" ")[0]
SUPPRESS = decoding.build_suppress_mask(TOK, CFG, decoding.DecodingOptions())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the decode loops run many tiny ops, and the
    test workers share the cores."""
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
def windows(weights_pair):
    """JAX's int8 cross-KV of three random feature windows, and the port's
    copy."""
    jparams, _ = weights_pair
    feats = jnp.asarray(np.random.default_rng(11).standard_normal(
        (3, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
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


def _port_state(G, K, int8=False, max_len=None):
    return beam_batcher.init_state(CFG, G, K, dtype=torch.float32,
                                   max_len=max_len, int8_self_cache=int8,
                                   device="cpu")


def _port_step(params, st, inner=4, lp=None):
    beam_batcher.step(CFG, params, st, torch.from_numpy(SUPPRESS),
                      inner_steps=inner, blank_token=BLANK,
                      length_penalty=lp)


def _harvest(st, g, prompt_len, lp=None):
    """(content tokens, score) of group g's best hypothesis."""
    fields = [getattr(st, f)[g].cpu().numpy() for f in (
        "tokens", "alive_lp", "alive_len", "fin_scores", "fin_tokens",
        "fin_lens")]
    row, length, score = beam_batcher.best_hypothesis(
        *fields, st.temperature[g], st.done_row[g].cpu().numpy(),
        length_penalty=lp)
    return [int(t) for t in row[prompt_len:prompt_len + length]
            if t != TOK.special.eot], score


def _jax_harvest(js, g, prompt_len):
    fetch = jax.device_get((js.tokens, js.alive_lp, js.alive_len,
                            js.fin_scores, js.fin_tokens, js.fin_lens,
                            js.temperature, js.done_row))
    row, length, score = jax_beam_batcher.best_hypothesis(
        *[f[g] for f in fetch])
    return [int(t) for t in row[prompt_len:prompt_len + length]
            if t != TOK.special.eot], score


def _oneshot(params, kv_row, K, ts, max_new):
    """The port's B=1 one-shot beam on one int8 cross-KV window."""
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=ts)
    sup = torch.from_numpy(decoding.build_suppress_mask(
        TOK, CFG, decoding.DecodingOptions(without_timestamps=not ts)))
    toks, scores, lens, _ = beam.beam_search_loop(
        CFG, params, kv_row, torch.tensor([prompt]), sup, beam_size=K,
        prompt_len=len(prompt), max_new=max_new, use_timestamps=ts,
        suppress_blank=True, max_initial_index=50, blank_token=BLANK)
    P = len(prompt)
    return ([int(t) for t in toks[0, P:P + int(lens[0])]
             if t != TOK.special.eot], float(scores[0]))


def _row(kv, r):
    return model.QuantKVCache(*[t[:, r:r + 1] for t in vars(kv).values()])


@pytest.mark.parametrize("ts,int8", [(True, False), (False, True)])
def test_beam_groups_match_oneshot_and_jax(weights_pair, windows, ts, int8):
    """Two windows in two concurrent groups (K=3, the second admitted two
    steps later) against the JAX beam batcher, step by step: the same
    tokens, ancestry and step counts, and the live rows' logits within
    2e-4; at the end the same hypotheses and scores, and on an fp32
    self-cache the port's one-shot beam's.

    On random weights the candidates' scores crowd (logits of ~0.1 over
    51865 tokens), and an int8 self-cache's level flips at .5 ties move
    the port's sums from JAX's by an ulp: a group whose tokens part from
    JAX's must do so at a tie, its alive scores equal to JAX's within 1e-4;
    it is then compared no further, and every group must have matched for
    at least 8 steps."""
    jparams, params = weights_pair
    jkv, kv = windows
    K, max_new = 3, 24
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=ts)
    P = len(prompt)
    js = jax_beam_batcher.init_state(CFG, 2, K, dtype=jnp.float32,
                                     int8_self_cache=int8)
    st = _port_state(2, K, int8)
    parted = {}                           # group → the step it parted at

    def step_both(js):
        js = jax_beam_batcher.step(CFG, jparams, js, jnp.asarray(SUPPRESS),
                                   inner_steps=1, blank_token=BLANK)
        _port_step(params, st, inner=1)
        jtok, jlp = np.asarray(js.tokens), np.asarray(js.alive_lp)
        for g in range(2):
            if g in parted:
                continue
            if not np.array_equal(st.tokens[g].numpy(), jtok[g]):
                np.testing.assert_allclose(np.sort(st.alive_lp[g].numpy()),
                                           np.sort(jlp[g]), atol=1e-4)
                assert int8, "an fp32 self-cache parted from JAX"
                parted[g] = int(st.step[g])
                continue
            np.testing.assert_array_equal(st.anc[g].numpy(),
                                          np.asarray(js.anc[g]))
            assert int(st.step[g]) == int(js.step[g])
            if bool(js.active[g] & ~js.finished[g]):
                rows = slice(g * K, g * K + K)
                np.testing.assert_allclose(
                    st.last_logits[rows, :CFG.n_vocab].numpy(),
                    np.asarray(js.last_logits[rows, :CFG.n_vocab]),
                    atol=2e-4)
        return js

    for g in (1, 0):
        js = jax_beam_batcher.admit(
            CFG, jparams, js, jnp.int32(g), jkv,
            jnp.asarray([prompt], jnp.int32), jnp.asarray(ts), prompt_len=P,
            max_new=jnp.int32(max_new), row=jnp.int32(g))
        beam_batcher.admit(CFG, params, st, g, kv, prompt, ts, prompt_len=P,
                           max_new=max_new, row=g)
        for _ in range(2 if g else 1):
            js = step_both(js)
    while not bool(np.asarray(js.finished).all()):
        js = step_both(js)
    assert bool(st.finished.all())
    assert all(s >= 8 for s in parted.values()), parted
    for g in set(range(2)) - set(parted):
        got, score = _harvest(st, g, P)
        ref, ref_score = _jax_harvest(js, g, P)
        assert got == ref and len(got) > 0
        assert score == pytest.approx(ref_score, abs=1e-5)
        if not int8:
            one, one_score = _oneshot(params, _row(kv, g), K, ts, max_new)
            assert got == one
            assert score == pytest.approx(one_score, abs=1e-5)


def test_frozen_group_at_cache_end(weights_pair, windows):
    """A group that runs to its budget with prompt_len + max_new == T
    freezes at pos == T, where its new keys are dropped (in both packages);
    a group admitted after it keeps JAX's logits, tokens and scores."""
    jparams, params = weights_pair
    jkv, kv = windows
    K, T = 2, 16
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=False)
    P = len(prompt)
    js = jax_beam_batcher.init_state(CFG, 2, K, dtype=jnp.float32,
                                     max_len=T)
    st = _port_state(2, K, max_len=T)
    jstep = lambda js: jax_beam_batcher.step(
        CFG, jparams, js, jnp.asarray(SUPPRESS), inner_steps=2,
        blank_token=BLANK)

    def admit(js, g, max_new):
        beam_batcher.admit(CFG, params, st, g, kv, prompt, False,
                           prompt_len=P, max_new=max_new, row=g)
        return jax_beam_batcher.admit(
            CFG, jparams, js, jnp.int32(g), jkv,
            jnp.asarray([prompt], jnp.int32), jnp.asarray(False),
            prompt_len=P, max_new=jnp.int32(max_new), row=jnp.int32(g))

    with pytest.raises(ValueError, match="passes the cache"):
        beam_batcher.admit(CFG, params, st, 0, kv, prompt, False,
                           prompt_len=P, max_new=T - P + 1)
    js = admit(js, 0, T - P)
    for _ in range(T):
        js = jstep(js)
        _port_step(params, st, inner=2)
        if bool(st.finished[0]):
            break
    assert int(st.step[0]) == T - P and int(st.prompt_len[0] + st.step[0]) \
        == T, "group 0 did not run to the cache's end"
    js = admit(js, 1, 8)
    for _ in range(6):
        js = jstep(js)
        _port_step(params, st, inner=2)
        np.testing.assert_allclose(
            st.last_logits.numpy()[K:, :CFG.n_vocab],
            np.asarray(js.last_logits)[K:, :CFG.n_vocab], atol=2e-4)
    assert bool(st.finished[1])
    for g in (0, 1):
        got, score = _harvest(st, g, P)
        ref, ref_score = _jax_harvest(js, g, P)
        assert got == ref
        assert score == pytest.approx(ref_score, abs=1e-5)


def test_admit_evict_interleaving(weights_pair, windows):
    """One seed of the JAX package's admit/evict lane (test_fuzz.py):
    random admits, steps and harvests over 2 groups of 2 beams; every
    window gives the tokens of its isolated run, and every live beam's
    ancestry selects exactly prompt_len + step positions."""
    _, params = weights_pair
    _, kv = windows
    G, K, max_new = 2, 2, 10
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=False)
    P = len(prompt)
    rng = np.random.default_rng(999)
    expected = []
    for w in range(3):
        st = _port_state(1, K)
        beam_batcher.admit(CFG, params, st, 0, kv, prompt, False,
                           prompt_len=P, max_new=max_new, row=w)
        while not bool(st.finished[0]):
            _port_step(params, st, inner=2)
        expected.append(_harvest(st, 0, P)[0])

    st = _port_state(G, K)
    occupant, next_win, checked = {}, 0, 0

    def harvest_done():
        nonlocal checked
        for g in list(occupant):
            if bool(st.finished[g]):
                assert _harvest(st, g, P)[0] == expected[occupant[g]]
                checked += 1
                mask = np.zeros(G, bool)
                mask[g] = True
                beam_batcher.release(st, mask)
                del occupant[g]

    for _ in range(40):
        act = rng.integers(0, 3)
        free = [g for g in range(G) if g not in occupant]
        if act == 0 and free and next_win < 6:
            g = int(rng.choice(free))
            w = next_win % 3
            beam_batcher.admit(CFG, params, st, g, kv, prompt, False,
                               prompt_len=P, max_new=max_new, row=w)
            occupant[g] = w
            next_win += 1
        elif act == 1 and occupant:
            _port_step(params, st, inner=int(rng.integers(1, 4)))
            for g in occupant:
                if bool(st.active[g] & ~st.finished[g]):
                    got = st.anc[g].reshape(K, -1).sum(dim=1)
                    assert (got == P + int(st.step[g])).all()
        else:
            harvest_done()
    while occupant:
        _port_step(params, st, inner=2)
        harvest_done()
    assert checked >= 3


def test_fallback_and_state_bytes(weights_pair, windows, monkeypatch):
    """The parent-gather formulation (forced) gives the grouped step's
    tokens, on an int8 self-cache; state_bytes counts what init_state
    allocates, and in the fallback its tiled cross-KV and gathered
    cache too."""
    _, params = weights_pair
    _, kv = windows
    K = 3
    prompt = TOK.sot_sequence("en", "transcribe", timestamps=False)
    P = len(prompt)

    def run():
        st = _port_state(1, K, int8=True)
        beam_batcher.admit(CFG, params, st, 0, kv, prompt, False,
                           prompt_len=P, max_new=16)
        while not bool(st.finished[0]):
            _port_step(params, st, inner=4)
        return _harvest(st, 0, P)

    calls = model.decode_beam_step.calls
    grouped = run()
    assert model.decode_beam_step.calls > calls
    st = _port_state(2, K, int8=True, max_len=32)
    allocated = sum(t.numel() * t.element_size()
                    for t in vars(st).values() if torch.is_tensor(t))
    at = dict(beam_size=K, dtype=torch.float32, max_len=32,
              int8_self_cache=True)
    assert beam_batcher.state_bytes(CFG, 2, **at) == allocated
    monkeypatch.setattr(model, "beam_grouped_ok", lambda cfg, k: False)
    calls = model.decode_beam_step.calls
    fallback = run()
    assert model.decode_beam_step.calls == calls
    assert fallback[0] == grouped[0]
    assert fallback[1] == pytest.approx(grouped[1], abs=1e-5)
    extra = sum(t.numel() * t.element_size() for t in (
        st.cache_k, st.cache_v, st.cache_ks, st.cache_vs)) + K * sum(
        t.numel() * t.element_size() for t in (
            st.xkv_k, st.xkv_ks, st.xkv_v, st.xkv_vs))
    assert beam_batcher.state_bytes(CFG, 2, **at) == allocated + extra


def test_best_of_rows_match_greedy_batcher(weights_pair, windows):
    """A group at T > 0 runs best-of-K sampling: with generators of the
    same seeds, each row gives the tokens of a greedy batcher slot at that
    temperature."""
    _, params = weights_pair
    _, kv = windows
    K, temp, seeds = 2, 0.7, (5, 9)
    prompt = TOK.sot_sequence("en", "transcribe")
    P = len(prompt)
    sup = torch.from_numpy(SUPPRESS)
    gs = batcher.init_state(CFG, K, dtype=torch.float32, device="cpu")
    for r in range(K):
        batcher.admit(CFG, params, gs, r, kv, prompt, True, prompt_len=P,
                      temperature=temp, seed=seeds[r])
    st = _port_state(1, K)
    beam_batcher.admit(CFG, params, st, 0, kv, prompt, True, prompt_len=P,
                       max_new=40, temperature=temp,
                       rng=[torch.Generator().manual_seed(s) for s in seeds])
    for _ in range(3):
        batcher.step(CFG, params, gs, sup, inner_steps=8, blank_token=BLANK,
                     rep_threshold=1000)
        _port_step(params, st, inner=8)
    for r in range(K):
        ref = [int(t) for t in gs.tokens[r, P:int(gs.pos[r])]
               if t != TOK.special.eot]
        got = [int(t) for t in st.tokens[0, r, P:P + int(st.alive_len[0, r])]
               if t != TOK.special.eot]
        assert got == ref and len(got) > 0


def _server(params, **kw):
    """A beam server with a 32-row cache: random weights rarely emit EOT,
    so a window runs to its budget of 32 - 1 - prompt_len steps."""
    return BeamEngineServer(CFG, params, inner_steps=4, dtype=torch.float32,
                            tokenizer=TOK, max_decode_len=32, **kw)


def _drain(srv, sids, want=1, turns=400):
    got = {}
    for _ in range(turns):
        srv.run_once()
        for sid in sids:
            while True:
                r = srv.poll(sid)
                if r is None:
                    break
                got.setdefault(sid, []).append(r)
        if sum(map(len, got.values())) >= want * len(sids):
            break
    return got


def test_server_matches_oneshot_and_deep_stepping(weights_pair):
    """Two sessions through BeamEngineServer give equal tokens for equal
    audio, and the port's one-shot beam on the server's own prepared
    cross-KV; a saturated server with deep stepping (deep_factor 4) gives
    the tokens of deep_factor 1 in fewer dispatches."""
    _, params = weights_pair
    K = 2
    srv = _server(params, n_slots=2, beam_size=K, **NO_GUARDS)
    audio = _audio(2.0, 5)
    sids = [srv.open_session(), srv.open_session()]
    for sid in sids:
        srv.submit_window(sid, audio, window_id=0, language="en")
    res = _drain(srv, sids)
    a, b = (res[s][0] for s in sids)
    assert a.tokens == b.tokens and len(a.tokens) > 0
    assert a.latency > 0 and 0.0 <= a.no_speech_prob <= 1.0
    n = srv.audio_ctx * 2 * mel_ops.HOP_LENGTH
    window = np.zeros((1, n), np.float32)
    window[0, :len(audio)] = audio
    xkv, _, _ = srv._prep(torch.from_numpy(window), False)
    prompt = TOK.sot_sequence("en", "transcribe")
    ref, score = _oneshot(params, xkv, K, True, srv.room_cap - len(prompt))
    assert a.tokens == ref
    assert a.avg_logprob == pytest.approx(score, abs=1e-5)

    audios = [_audio(2.0, s) for s in range(4)]

    def run(deep_factor):
        s = _server(params, n_slots=2, beam_size=2, deep_factor=deep_factor,
                    max_admissions_per_turn=2, **NO_GUARDS)
        sid = s.open_session()
        for i, x in enumerate(audios):
            s.submit_window(sid, x, window_id=i, timestamps=False,
                            language="en")
        out = _drain(s, [sid], want=len(audios))[sid]
        return {r.window_id: r.tokens for r in out}, s.step_dispatches

    (plain, n_plain), (deep, n_deep) = run(1), run(4)
    assert plain == deep and len(plain) == len(audios)
    assert n_deep < n_plain


def test_server_ladder_peek_and_draft(weights_pair, caplog):
    """Random weights fail the logprob threshold: the group retries as
    best-of-K sampling at the next rung and comes back there; peek reads
    a partial of the top beam mid-window; a draft model is refused with
    the reference's warning."""
    _, params = weights_pair
    srv = _server(params, n_slots=1, beam_size=2, temperatures=(0.0, 0.4),
                  logprob_threshold=0.0, no_speech_threshold=2.0,
                  draft=(CFG, params))
    assert "drafting is unsupported" in caplog.text
    sid = srv.open_session()
    srv.submit_window(sid, _audio(1.0, 6), window_id=0, language="en")
    res = _drain(srv, [sid])[sid][0]
    assert res.temperature == pytest.approx(0.4)

    srv = _server(params, n_slots=1, beam_size=2, **NO_GUARDS)
    sid = srv.open_session()
    srv.submit_window(sid, _audio(1.0, 7), window_id=0, language="en")
    peeked = None
    for _ in range(300):
        srv.run_once()
        p = srv.peek(sid)
        if p:
            peeked = list(p)
        r = srv.poll(sid)
        if r is not None:
            break
    assert r is not None and peeked
    assert srv.queue_depth() == 0


def test_cli_beam_size(tmp_path, monkeypatch, capsys):
    """--beam-size: one file runs the one-shot engine's beam rung, several
    files a BeamEngineServer; both print their JSON. Windows are cut to 16
    new tokens (the engine's default budget, and the server's) to keep
    the random model's beams short."""
    from openhush_tpu_torch import cli
    calls = {"beam": 0, "servers": []}
    decode_beam, make_server = beam.decode_beam, longform.make_server

    def counted_beam(*a, **k):
        calls["beam"] += 1
        return decode_beam(*a, **k)

    def recorded_server(*a, **k):
        srv = make_server(*a, **k, max_new_tokens=16)
        calls["servers"].append(srv)
        return srv
    monkeypatch.setattr(beam, "decode_beam", counted_beam)
    monkeypatch.setattr(longform, "make_server", recorded_server)
    monkeypatch.setattr(decoding.DecodingOptions, "max_new_tokens", 16)
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    paths = []
    for i, secs in enumerate((1.5, 2.0)):
        paths.append(str(tmp_path / f"f{i}.wav"))
        save_wav(paths[-1], _audio(secs, i))
    args = ["--model", "test", "--random-init", "--dtype", "float32",
            "--device", "cpu", "--format", "json", "--language", "en",
            "--beam-size", "2"]
    assert cli.main(["transcribe", paths[0], *args]) == 0
    assert calls["beam"] >= 1 and not calls["servers"]
    assert json.loads(capsys.readouterr().out)["model"] == "test"
    assert cli.main(["transcribe", *paths, *args]) == 0
    (srv,) = calls["servers"]
    assert isinstance(srv, BeamEngineServer) and srv.beam_size == 2
    data = json.loads(capsys.readouterr().out)
    assert [d["file"] for d in data] == paths
