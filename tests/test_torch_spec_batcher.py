"""The port's speculative serving (runtime/batcher.spec_step and
EngineServer(draft=...)) against the JAX package's spec_step and against
the port's own plain server, on the "test" config and the 1-layer
"test-draft" in fp32 (JAX's weights carried over).

spec_step's tokens are step()'s for any draft: a random one and the big
model itself (whose proposals match, so blocks are accepted several tokens
deep). The GELU is pinned to erf and the ladder to (0.0,) where a test
compares with JAX (the two packages draw different random numbers). Decode
budgets are cut to max_decode_len 48 to keep the file short. Tolerances:
tokens, positions and lengths exact; sum_logprob atol 2e-3 (the JAX
package's tests/test_spec_batcher.py's)."""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import batcher as jax_batcher
from openhush_tpu_torch.models.whisper import decoding, model, weights
from openhush_tpu_torch.runtime import batcher, server
from openhush_tpu_torch.runtime.server import EngineServer
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
DCFG = CONFIGS["test-draft"]
TOK = WhisperTokenizer(CFG.n_langs)
BLANK = TOK.encode(" ")[0]
MAX_LEN = 48
NO_GUARDS = dict(temperatures=(0.0,), logprob_threshold=-1e9,
                 no_speech_threshold=2.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the step loops run many tiny ops, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


def _to_torch(jparams):
    return weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     torch.float32, "cpu")


@pytest.fixture(scope="module")
def setup():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(42),
                                    dtype=jnp.float32)
    jdraft = jax_model.init_params(DCFG, jax.random.PRNGKey(7),
                                   dtype=jnp.float32)
    return jparams, _to_torch(jparams), jdraft, _to_torch(jdraft)


def _server(params, draft=None, **kw):
    args = dict(n_slots=2, inner_steps=8, dtype=torch.float32, tokenizer=TOK,
                max_decode_len=MAX_LEN, int8_self_cache=False, **NO_GUARDS)
    args.update(kw)
    return EngineServer(CFG, params, draft=draft, **args)


def _run_server(srv, audios, max_turns=600, **submit):
    sids = []
    for i, audio in enumerate(audios):
        sid = srv.open_session()
        sids.append(sid)
        srv.submit_window(sid, audio, window_id=i, **submit)
    results = {}
    for _ in range(max_turns):
        srv.run_once()
        for sid in sids:
            if sid not in results:
                r = srv.poll(sid)
                if r is not None:
                    results[sid] = r
        if len(results) == len(sids):
            break
    assert len(results) == len(sids), "server did not finish all windows"
    return [results[sid] for sid in sids]


def _audios(n, seed=3, secs=2):
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(16000 * secs)).astype(np.float32)
            for _ in range(n)]


def _port_qkv(kv):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return model.QuantKVCache(t(kv.k), t(kv.k_scale), t(kv.v), t(kv.v_scale))


@pytest.mark.parametrize("int8_self", [False, True])
def test_spec_step_matches_jax(setup, int8_self):
    """Two slots admitted at different times (slot 1, a spec_step call,
    slot 0), then spec_step calls: after each, tokens, pos, length and
    finished equal the JAX batcher's spec_step on the same admitted state
    and cross-KVs (the big model's and the draft's int8), sum_logprob atol
    2e-3; on the fp and the int8 self-cache."""
    jparams, params, jdraft, dparams = setup
    feats = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    jkv = jax_model.compute_cross_kv_quant(CFG, jparams, feats)
    jdkv = jax_model.compute_cross_kv_quant(DCFG, jdraft, feats)
    kv, dkv = _port_qkv(jkv), _port_qkv(jdkv)
    prompt = TOK.sot_sequence("en", "transcribe")
    P = len(prompt)
    suppress = decoding.build_suppress_mask(TOK, CFG,
                                            decoding.DecodingOptions())
    room_cap = MAX_LEN - 1
    kw = dict(k_spec=4, n_iters=2, room_cap=room_cap, blank_token=BLANK)

    js = jax_batcher.init_state(CFG, 2, dtype=jnp.float32, max_len=MAX_LEN,
                                int8_self_cache=int8_self, draft_cfg=DCFG)
    st = batcher.init_state(CFG, 2, dtype=torch.float32, max_len=MAX_LEN,
                            int8_self_cache=int8_self, draft_cfg=DCFG,
                            device="cpu")
    assert st.tokens.shape == js.tokens.shape == (2, MAX_LEN + 16)
    jstep = functools.partial(jax_batcher.spec_step, CFG, jparams, DCFG,
                              jdraft, suppress_mask=jnp.asarray(suppress),
                              **kw)
    sup = torch.from_numpy(suppress)
    seen = []
    for call in range(6):
        if call in (0, 1):
            slot = 1 - call
            js = jax_batcher.admit(
                CFG, jparams, js, jnp.int32(slot), jkv,
                jnp.asarray([prompt], jnp.int32), jnp.asarray(True),
                prompt_len=P, row=jnp.int32(slot), draft_cfg=DCFG,
                draft_params=jdraft, draft_xkv=jdkv)
            batcher.admit(CFG, params, st, slot, kv, prompt, True,
                          prompt_len=P, row=slot, draft_cfg=DCFG,
                          draft_params=dparams, draft_xkv=dkv)
        js = jstep(state=js)
        batcher.spec_step(CFG, params, DCFG, dparams, st, sup, **kw)
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(js.tokens))
        for name in ("pos", "length", "finished", "ts_floor", "rep_count"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(js, name)), name)
        np.testing.assert_allclose(st.sum_logprob.numpy(),
                                   np.asarray(js.sum_logprob), atol=2e-3)
        seen.append(st.length.tolist())
    assert seen[-1][1] > 8


@pytest.mark.parametrize("int8_self", [False, True])
@pytest.mark.parametrize("k_spec", [3, 4])
def test_spec_server_matches_plain(setup, k_spec, int8_self):
    """The same windows through a speculative server (random draft) and a
    plain one: the same content tokens and text, avg_logprob atol 2e-3;
    on the fp and the int8 self-cache."""
    _, params, _, dparams = setup
    audios = _audios(3)
    r_plain = _run_server(_server(params, int8_self_cache=int8_self), audios)
    spec = _server(params, draft=(DCFG, dparams), k_spec=k_spec,
                   spec_policy="always", int8_self_cache=int8_self)
    assert spec.draft_cfg is DCFG and spec.state.d_cache_k.shape[0] == 1
    r_spec = _run_server(spec, audios)
    assert spec.spec_iters > 0
    for rp, rs in zip(r_plain, r_spec):
        assert rp.tokens == rs.tokens and len(rp.tokens) > 0
        assert rp.text == rs.text
        np.testing.assert_allclose(rp.avg_logprob, rs.avg_logprob, atol=2e-3)


def test_self_draft_server(setup):
    """The big model as its own draft: tokens equal the plain server's, and
    a lone window emits more than 2 tokens per spec_step iteration."""
    _, params, _, _ = setup
    audios = _audios(1, seed=17)
    [rp] = _run_server(_server(params, n_slots=1), audios)
    spec = _server(params, draft=(CFG, params), n_slots=1,
                   spec_policy="always")
    [rs] = _run_server(spec, audios)
    assert rp.tokens == rs.tokens
    # Tokens emitted (content plus the final EOT or the room's last) per
    # iteration; the last dispatch may run idle iterations after the end.
    per_iter = (len(rs.tokens) + 1) / spec.spec_iters
    assert per_iter > 2.0, per_iter


def test_spec_server_output_invariant_to_draft(setup):
    """Two different random drafts give the same serving output."""
    _, params, _, dparams = setup
    other = _to_torch(jax_model.init_params(DCFG, jax.random.PRNGKey(99),
                                            dtype=jnp.float32))
    audios = _audios(2, seed=11)
    r1 = _run_server(_server(params, draft=(DCFG, dparams),
                             spec_policy="always"), audios)
    r2 = _run_server(_server(params, draft=(DCFG, other),
                             spec_policy="always"), audios)
    assert [a.tokens for a in r1] == [b.tokens for b in r2]


def test_spec_server_no_timestamps_mode(setup):
    _, params, _, dparams = setup
    audios = _audios(2, seed=5)
    plain = _run_server(_server(params), audios, timestamps=False)
    spec = _run_server(_server(params, draft=(DCFG, dparams),
                               spec_policy="always"), audios,
                       timestamps=False)
    assert [a.tokens for a in plain] == [b.tokens for b in spec]
    assert all(t < TOK.special.timestamp_begin for r in spec for t in r.tokens)


def test_spec_server_incompatible_draft_disabled(setup, caplog):
    """A draft of another width is refused with the reference's warning;
    the server steps plainly."""
    _, params, _, _ = setup
    bad_cfg = dataclasses.replace(DCFG, name="bad", n_text_state=128,
                                  n_text_head=4)
    bad = _to_torch(jax_model.init_params(bad_cfg, jax.random.PRNGKey(1),
                                          dtype=jnp.float32))
    with caplog.at_level(logging.WARNING):
        srv = _server(params, draft=(bad_cfg, bad))
    assert "incompatible" in caplog.text
    assert srv.draft_cfg is None and srv.state.d_cache_k.shape == (1, 1, 1, 1)
    assert _run_server(srv, _audios(1))[0] is not None
    with pytest.raises(ValueError, match="spec_policy"):
        _server(params, spec_policy="sometimes")


def test_spec_policy_auto(setup):
    """spec_policy="auto": a burst of windows runs the plain step, a lone
    window the speculative one (re-picked only while the batcher is empty),
    an odd burst's tail window flips to speculation, and every window's
    tokens equal an always-plain server's."""
    _, params, _, dparams = setup
    srv = _server(params, draft=(DCFG, dparams))
    assert srv.spec_policy == "auto" and not srv._spec_mode
    r_batch = _run_server(srv, _audios(4))
    assert srv.spec_iters == 0
    [r_one] = _run_server(srv, _audios(1, seed=21))
    assert srv.spec_iters > 0
    before = srv.spec_iters
    r_odd = _run_server(srv, _audios(3, seed=33))
    assert srv.spec_iters > before

    plain = _server(params)
    rp_batch = _run_server(plain, _audios(4))
    [rp_one] = _run_server(plain, _audios(1, seed=21))
    rp_odd = _run_server(plain, _audios(3, seed=33))
    for a, b in zip(r_batch + [r_one] + r_odd, rp_batch + [rp_one] + rp_odd):
        assert a.tokens == b.tokens


def test_spec_auto_interleaved_sessions_converge_to_plain(setup):
    """Two sessions whose windows alternate, each arriving while the
    other's decodes: auto never admits a second window into a speculative
    batch, records the wait, re-picks plain at the next drain and then
    batches the two; an idle drain forgets it, so a later lone window
    speculates again. Tokens equal an always-plain server's throughout."""
    _, params, _, dparams = setup
    srv = _server(params, draft=(DCFG, dparams))
    audios = _audios(4, seed=55)
    s1, s2 = srv.open_session(), srv.open_session()
    srv.submit_window(s1, audios[0], window_id=0)
    srv.run_once()
    assert srv._spec_mode and srv.spec_iters > 0
    assert len(srv._slots) == 1
    srv.submit_window(s2, audios[1], window_id=1)
    results = {}
    both_in_plain = w2_submitted = False
    for _ in range(600):
        srv.run_once()
        occ = len(srv._slots)
        if srv._spec_mode:
            assert occ <= 1
        elif occ == 2:
            both_in_plain = True
        if (r := srv.poll(s1)) is not None:
            results[2 if 0 in results else 0] = r
        if 0 in results and srv._spec_blocked and not w2_submitted:
            srv.submit_window(s1, audios[2], window_id=2)
            w2_submitted = True
        if 1 not in results and (rb := srv.poll(s2)) is not None:
            results[1] = rb
        if len(results) == 3:
            break
    assert len(results) == 3, "interleaved windows did not finish"
    assert srv._spec_blocked and not srv._spec_mode and both_in_plain

    srv.run_once()
    before = srv.spec_iters
    srv.submit_window(s2, audios[3], window_id=3)
    for _ in range(600):
        srv.run_once()
        if (r3 := srv.poll(s2)) is not None:
            results[3] = r3
            break
    assert srv.spec_iters > before

    plain = _server(params)
    ps = plain.open_session()
    for i, audio in enumerate(audios):
        plain.submit_window(ps, audio, window_id=i)
        for _ in range(600):
            plain.run_once()
            if (rp := plain.poll(ps)) is not None:
                assert results[i].tokens == rp.tokens
                break
        else:
            raise AssertionError("plain reference did not finish")


def test_spec_force_accept_unreachable_via_env(setup, monkeypatch):
    """The accept-everything measurement mode is constructor-only: the
    variable the reference retired changes nothing."""
    _, params, _, dparams = setup
    monkeypatch.setenv("OPENHUSH_SPEC_FORCE_ACCEPT", "1")
    srv = _server(params, draft=(DCFG, dparams), n_slots=1,
                  spec_policy="always")
    assert srv.spec_force_accept is False
    [rs] = _run_server(srv, _audios(1, seed=13))
    [rp] = _run_server(_server(params, n_slots=1), _audios(1, seed=13))
    assert rs.tokens == rp.tokens
    forced = _server(params, draft=(DCFG, dparams), n_slots=1,
                     spec_policy="always", spec_force_accept=True)
    [rf] = _run_server(forced, _audios(1, seed=13))
    assert forced.spec_force_accept and isinstance(rf.text, str)


def test_spec_server_fallback_ladder(setup):
    """A retry up the ladder (readmit) under speculation: every first pass
    fails the logprob threshold, the window finishes at the T=0.5 rung, and
    its tokens are a plain server's at that rung with the same slot seed
    (one generator draw per emitted token, in step()'s order)."""
    _, params, _, dparams = setup
    kw = dict(n_slots=1, temperatures=(0.0, 0.5), logprob_threshold=1e9,
              no_speech_threshold=2.0)
    [rs] = _run_server(_server(params, draft=(DCFG, dparams),
                               spec_policy="always", **kw),
                       _audios(1, seed=9))
    [rp] = _run_server(_server(params, **kw), _audios(1, seed=9))
    assert rs.temperature == rp.temperature == 0.5
    assert rs.tokens == rp.tokens and len(rs.tokens) > 0


def test_state_bytes_with_draft(setup, monkeypatch):
    """init_state(draft_cfg=...): the draft's self-cache and int8 cross-KV
    ([Ld, B, T, H*Dh], [Ld, B, A, H] scales), SPEC_MARGIN more rows in every
    T-sized buffer, and state_bytes equal to the allocation; the slot
    budgeter counts the draft's weights and state."""
    L, H, HD = DCFG.n_text_layer, CFG.n_text_head, CFG.n_text_state
    for int8_self in (False, True):
        st = batcher.init_state(CFG, 3, dtype=torch.float32, max_len=64,
                                audio_ctx=200, int8_self_cache=int8_self,
                                draft_cfg=DCFG, device="cpu")
        T = 64 + batcher.SPEC_MARGIN
        assert st.tokens.shape == (3, T) and st.cache_k.shape[2] == T
        assert st.d_cache_k.shape == st.d_cache_v.shape == (L, 3, T, HD)
        assert st.d_xkv_k.shape == (L, 3, 200, HD)
        assert st.d_xkv_k.dtype == torch.int8
        assert st.d_xkv_ks.shape == (L, 3, 200, H)
        allocated = sum(t.numel() * t.element_size()
                        for t in vars(st).values() if torch.is_tensor(t))
        assert batcher.state_bytes(CFG, 3, dtype=torch.float32, max_len=64,
                                   audio_ctx=200, int8_self_cache=int8_self,
                                   draft_cfg=DCFG) == allocated
        assert allocated > batcher.state_bytes(
            CFG, 3, dtype=torch.float32, max_len=64, audio_ctx=200,
            int8_self_cache=int8_self)
    with pytest.raises(ValueError, match="SPEC_MARGIN"):
        batcher.spec_step(CFG, None, DCFG, None, st, None, k_spec=4,
                          room_cap=T - 4)

    _, params, _, dparams = setup
    at = functools.partial(batcher.state_bytes, CFG, dtype=torch.float32,
                           max_len=MAX_LEN, draft_cfg=DCFG)
    weights = server._nbytes(params) + server._nbytes(dparams)
    cap = int((weights + 2.5 * at(1)) / server.HBM_BUDGET_FRACTION) + 1
    monkeypatch.setenv("OPENHUSH_HBM_BYTES", str(cap))
    assert server.hbm_fit_count(params, at, draft_params=dparams) == 2
    assert server.hbm_fit_count(params, at) > 2
    with pytest.raises(ValueError, match="that fits: 2"):
        _server(params, draft=(DCFG, dparams), n_slots=3)
