"""The port's beam search (K4's beam mode's plain version, decode_beam_step,
decode(cross_group=K), models/whisper/beam.py and the engine's beam rung)
against the JAX package on the same weights ("test" config, fp32; JAX's
weights carried over with from_numpy_params).

Tolerances: the beam attention's outputs atol 1e-5, fp32 and int8 (the same
int8 levels on both sides; fp32 softmax sums in another order, which at a
.5 tie could move a prob level, i.e. the output by at most max_t(p·vs),
and measured 1.2e-7); logits atol 2e-4 against JAX (as
tests/test_torch_decoder.py) and 5e-5 against the port's own gather
oracle (the same plain arithmetic over the keys in another order: fp32
softmax sums, and an int8 cross-attention prob level that may move at a .5
tie; measured 8.7e-6 on logits of at most 0.15); tokens, segments and
texts exact; beam scores atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import beam as jax_beam
from openhush_tpu.models.whisper import decoding as jax_decoding
from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import engine as jax_engine
from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from openhush_tpu_torch.models.whisper import beam, decoding, model, weights
from openhush_tpu_torch.ops import decode_attention as da
from openhush_tpu_torch.runtime import engine
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer

CFG = CONFIGS["test"]
LOGIT_ATOL = 2e-4
_decode_jit = jax.jit(jax_model.decode, static_argnums=0)
_beam_step_jit = jax.jit(jax_model.decode_beam_step, static_argnums=0)


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
    monkeypatch.setattr(jax_engine, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(engine, "TEMPERATURES", (0.0,))


@pytest.fixture(scope="module")
def weights_pair():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    return jparams, params


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_kv(jkv):
    if isinstance(jkv, jax_model.QuantKVCache):
        return model.QuantKVCache(_t(jkv.k), _t(jkv.k_scale), _t(jkv.v),
                                  _t(jkv.v_scale))
    return model.KVCache(_t(jkv.k), _t(jkv.v))


@pytest.fixture(scope="module")
def cross(weights_pair):
    """{kind: (JAX cross-KV, the port's copy)} of two random windows."""
    jparams, _ = weights_pair
    feats = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    out = {}
    for kind, fn in (("fp", jax_model.compute_cross_kv),
                     ("int8", jax_model.compute_cross_kv_quant)):
        jkv = fn(CFG, jparams, feats)
        out[kind] = (jkv, _port_kv(jkv))
    return out


def _random_ancestry(rng, G, K, T, P, pos):
    """An ancestry [G, K, K, T] after random parent picks from position P to
    pos - 1, then this step's parents (test_fuzz.py's recipe)."""
    anc = np.broadcast_to(np.eye(K, dtype=bool)[None, :, :, None]
                          & (np.arange(T) < P), (G, K, K, T)).copy()
    for p in range(P, pos + 1):
        par = rng.integers(0, K, (G, K))
        anc = np.take_along_axis(anc, par[:, :, None, None], axis=1)
        if p < pos:
            anc |= (np.eye(K, dtype=bool)[None, :, :, None]
                    & (np.arange(T) == p))
    return anc


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_attend_decode_beam_plain_matches_jax(kind):
    """K4's beam mode's plain version under the port's write-first
    convention (each beam's new key written at pos, the mask anc_att |
    own) against JAX's _attend_decode_flat_beam (the cache under anc_att
    and the new keys beside it, under the identity block)."""
    G, K, T, H, D = 2, 3, 8, 2, 32
    HD, P, pos = H * D, 3, 6
    rng = np.random.default_rng(0 if kind == "fp32" else 1)
    anc = _random_ancestry(rng, G, K, T, P, pos)
    q = rng.standard_normal((G, K, HD)).astype(np.float32)
    if kind == "fp32":
        kc, vc = (rng.standard_normal((G, K * T, HD)).astype(np.float32)
                  for _ in range(2))
        kn, vn = (rng.standard_normal((G, K, HD)).astype(np.float32)
                  for _ in range(2))
        scales = {}
    else:
        kc, vc = (rng.integers(-127, 128, (G, K * T, HD)).astype(np.int8)
                  for _ in range(2))
        kn, vn = (rng.integers(-127, 128, (G, K, HD)).astype(np.int8)
                  for _ in range(2))
        scales = {n: rng.uniform(1e-3, 2e-2, (G, K * T if n[-1] != "n"
                                              else K, H)).astype(np.float32)
                  for n in ("ks", "vs", "ksn", "vsn")}
    ref = jax_model._attend_decode_flat_beam(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(anc.reshape(G, K, K * T)), jnp.asarray(kn),
        jnp.asarray(vn), H, **{n: jnp.asarray(a) for n, a in scales.items()})

    def written(cache, new):
        out = cache.reshape(G, K, T, -1).copy()
        out[:, :, pos] = new
        return torch.from_numpy(out.reshape(G, K * T, -1))

    kw = ({} if kind == "fp32" else
          dict(ks=written(scales["ks"], scales["ksn"]),
               vs=written(scales["vs"], scales["vsn"])))
    mask = model.beam_own(torch.from_numpy(anc), torch.full((G,), pos))
    assert bool(mask[:, :, :, pos].diagonal(dim1=1, dim2=2).all())
    out = da.attend_decode_beam(torch.from_numpy(q), written(kc, kn),
                                written(vc, vn), mask.view(G, K, K * T), H,
                                **kw)
    assert out.dtype == torch.float32 and out.shape == (G, K, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _prefilled_caches(jparams, jkv, G, K, T, prompt, int8):
    """Each group's row prefilled by JAX decode and tiled K ways (as the
    beam batcher does), as numpy arrays: (k, v) or (k, ks, v, vs)."""
    fields = ("k", "k_scale", "v", "v_scale") if int8 else ("k", "v")
    parts = []
    for g in range(G):
        row_kv = jax.tree.map(lambda a: a[:, g:g + 1], jkv)
        rc = (jax_model.init_quant_kv_cache(CFG, 1, T) if int8
              else jax_model.init_kv_cache(CFG, 1, jnp.float32, T))
        _, rc = _decode_jit(CFG, jparams, jnp.asarray([prompt], jnp.int32),
                            jnp.int32(0), rc, row_kv)
        parts.append([np.repeat(np.asarray(getattr(rc, f)), K, axis=1)
                      for f in fields])
    return [np.concatenate(p, axis=1) for p in zip(*parts)]


@pytest.mark.parametrize("int8_self", [False, True])
def test_decode_beam_step_matches_jax_and_gather_oracle(weights_pair, cross,
                                                        int8_self):
    """Six steps of random parent switches (repeats, collapses, swaps)
    through decode_beam_step against JAX's (logits atol 2e-4), and against
    the port's gather oracle: the cache rows gathered by parent, then a
    per-row decode step on the K-tiled cross-KV (atol 5e-5). On an fp32
    and on an int8 self-cache."""
    jparams, params = weights_pair
    jkv, kv = cross["int8"]
    G, K, T = 2, 3, 24
    prompt = WhisperTokenizer(CFG.n_langs).sot_sequence(
        "en", "transcribe", timestamps=False)
    P = len(prompt)
    arrays = _prefilled_caches(jparams, jkv, G, K, T, prompt, int8_self)
    jcache = (jax_model.QuantKVCache if int8_self
              else jax_model.KVCache)(*map(jnp.asarray, arrays))
    mk = (model.QuantKVCache if int8_self else model.KVCache)
    cache = mk(*[torch.from_numpy(a.copy()) for a in arrays])
    oracle = mk(*[torch.from_numpy(a.copy()) for a in arrays])
    tiled = beam._tile(kv, K)
    rng = np.random.default_rng(777)
    anc = (np.eye(K, dtype=bool)[None, :, :, None]
           & (np.arange(T)[None, None, None, :] < P))
    anc = np.broadcast_to(anc, (G, K, K, T)).copy()
    before = model.decode_beam_step.calls
    for step in range(6):
        pos = P + step
        parents = rng.integers(0, K, size=(G, K))
        tokens = rng.integers(0, CFG.n_vocab, size=(G, K))
        anc_att = np.take_along_axis(anc, parents[:, :, None, None], axis=1)
        jl, jcache = _beam_step_jit(
            CFG, jparams, jnp.asarray(tokens, jnp.int32),
            jnp.full((G,), pos, jnp.int32), jcache,
            jnp.asarray(anc_att.reshape(G, K, K * T)), jkv)
        att = model.beam_own(torch.from_numpy(anc_att),
                             torch.full((G,), pos))
        with torch.no_grad():
            lg, cache = model.decode_beam_step(
                CFG, params, torch.from_numpy(tokens), torch.full((G,), pos),
                cache, att.view(G, K, K * T), kv)
            flat = torch.from_numpy(
                (parents + np.arange(G)[:, None] * K).reshape(-1))
            oracle = mk(*[t[:, flat] for t in vars(oracle).values()])
            lo, oracle = model.decode(
                CFG, params, torch.from_numpy(tokens.reshape(G * K, 1)),
                torch.full((G * K,), pos), oracle, tiled)
        anc = att.numpy()
        ours = lg.numpy()[..., :CFG.n_vocab]
        np.testing.assert_allclose(ours, np.asarray(jl)[..., :CFG.n_vocab],
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        o = lo.numpy()[:, -1, :CFG.n_vocab].reshape(G, K, -1)
        np.testing.assert_allclose(ours, o, atol=5e-5, err_msg=f"step {step}")
    assert model.decode_beam_step.calls == before + 6
    # Every beam's mask selects exactly P + 6 positions, one row a position.
    assert (anc.reshape(G, K, -1).sum(-1) == P + 6).all()
    assert (anc.sum(axis=2) <= 1).all()


def test_decode_cross_group_matches_jax(weights_pair, cross):
    """decode(cross_group=K): the K rows of a group share one int8
    cross-KV row (JAX's tests/test_cross_group.py shapes on the test
    config): logits against JAX's grouped decode and the port's tiled
    one; the ValueErrors of a batch not divisible by the group and of a
    group past one lane tile."""
    jparams, params = weights_pair
    G, K, T, pos0 = 2, 4, 32, 7
    rng = np.random.default_rng(0)
    jkv, kv = cross["int8"]
    shape = (CFG.n_text_layer, G * K, T, CFG.n_text_state)
    k0, v0 = (0.2 * rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    toks = rng.integers(0, CFG.n_vocab, (G * K, 1))
    pos = np.full(G * K, pos0)
    jl, jc = jax_model.decode(CFG, jparams, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(pos, jnp.int32),
                              jax_model.KVCache(jnp.asarray(k0),
                                                jnp.asarray(v0)),
                              jkv, cross_group=K)
    with torch.no_grad():
        run = lambda x, group: model.decode(
            CFG, params, torch.from_numpy(toks), torch.from_numpy(pos),
            model.KVCache(torch.from_numpy(k0.copy()),
                          torch.from_numpy(v0.copy())), x,
            cross_group=group)
        lg, c = run(kv, K)
        lt, _ = run(beam._tile(kv, K), 1)
    np.testing.assert_allclose(lg.numpy()[..., :CFG.n_vocab],
                               np.asarray(jl)[..., :CFG.n_vocab],
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(lg.numpy(), lt.numpy(), atol=1e-5)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), atol=1e-5)

    cache = model.init_kv_cache(CFG, G * K - 1, torch.float32, 8)
    with pytest.raises(ValueError, match="not divisible"):
        model.decode(CFG, params, torch.zeros(G * K - 1, 1, dtype=torch.long),
                     0, cache, kv, cross_group=K)
    big = 128 // CFG.n_text_head + 1
    one = model.QuantKVCache(*[t[:, :1] for t in vars(kv).values()])
    with pytest.raises(ValueError, match="128"):
        model.decode(CFG, params, torch.zeros(big, 1, dtype=torch.long), 0,
                     model.init_kv_cache(CFG, big, torch.float32, 8), one,
                     cross_group=big)


# (beam size, timestamps, cross-KV, length penalty, batch rows)
BEAM_CASES = [(2, True, "fp", None, 1), (3, False, "int8", None, 2),
              (3, True, "int8", 1.0, 1), (2, False, "fp", 1.0, 2),
              (3, True, "fp", None, 2)]


def _decode_beam_pair(weights_pair, cross, K, ts, kind, lp, B):
    jparams, params = weights_pair
    jkv, kv = cross[kind]
    jkv = jax.tree.map(lambda a: a[:, :B], jkv)
    kv = type(kv)(*[t[:, :B] for t in vars(kv).values()])
    prompt = [50361, 440, 1000]               # start_of_prev + text
    common = dict(language="en", beam_size=K, max_new_tokens=20,
                  without_timestamps=not ts, length_penalty=lp)
    ref = jax_beam.decode_beam(CFG, jparams, jkv, JaxTokenizer(99),
                               jax_decoding.DecodingOptions(**common),
                               prompt_ids=prompt)
    ours = beam.decode_beam(CFG, params, kv, WhisperTokenizer(99),
                            decoding.DecodingOptions(**common),
                            prompt_ids=prompt)
    return ref, ours


@pytest.mark.parametrize("K,ts,kind,lp,B", BEAM_CASES)
def test_decode_beam_matches_jax(weights_pair, cross, K, ts, kind, lp, B):
    ref, ours = _decode_beam_pair(weights_pair, cross, K, ts, kind, lp, B)
    assert ours.tokens.shape == ref.tokens.shape
    np.testing.assert_array_equal(ours.tokens, np.asarray(ref.tokens))
    assert ours.prompt_len == ref.prompt_len
    np.testing.assert_allclose(ours.avg_logprob, np.asarray(ref.avg_logprob),
                               atol=1e-5)
    np.testing.assert_allclose(ours.no_speech_prob,
                               np.asarray(ref.no_speech_prob), atol=1e-5)


def test_decode_beam_fallback_gives_grouped_tokens(weights_pair, cross,
                                                   monkeypatch):
    """The K-tiled cross-KV and the parent gather (the formulation past one
    lane tile, forced here) give the grouped step's tokens, and JAX's."""
    jparams, params = weights_pair
    calls = model.decode_beam_step.calls
    ref, grouped = _decode_beam_pair(weights_pair, cross, 3, True, "int8",
                                     None, 2)
    assert model.decode_beam_step.calls > calls
    monkeypatch.setattr(model, "beam_grouped_ok", lambda cfg, k: False)
    calls = model.decode_beam_step.calls
    _, kv = cross["int8"]
    fallback = beam.decode_beam(
        CFG, params, kv, WhisperTokenizer(99),
        decoding.DecodingOptions(language="en", beam_size=3,
                                 max_new_tokens=20),
        prompt_ids=[50361, 440, 1000])
    assert model.decode_beam_step.calls == calls
    np.testing.assert_array_equal(fallback.tokens, grouped.tokens)
    np.testing.assert_array_equal(fallback.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(fallback.avg_logprob, grouped.avg_logprob,
                               atol=1e-5)


def test_top_k_ties_in_lax_order():
    """Dead beams tie across whole rows at finfo(f32).min (and overflow to
    -inf): _top_k returns jax.lax.top_k's values and indices, ties lowest
    index first."""
    neg = np.finfo(np.float32).min
    rng = np.random.default_rng(0)
    x = rng.choice(np.array([neg, -np.inf, -1.5, 0.25, 0.25, 3.0],
                            np.float32), size=(4, 64))
    x[0] = neg
    x[1, :32] = -np.inf
    for k in (1, 5, 10, 64):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = beam._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _segments(result):
    return [(s.text, round(s.start, 6), round(s.end, 6), s.tokens)
            for s in result.segments]


def test_engine_beam_matches_jax_engine(weights_pair):
    """WhisperEngine.transcribe(beam_size=3) on a 35 s input (two windows,
    the second with a previous-text prompt): JAX's windows and segments."""
    jparams, params = weights_pair
    rng = np.random.default_rng(0)
    n = 16000 * 35
    t = np.arange(n) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    ref = jax_engine.WhisperEngine("test", params=jparams).transcribe(
        audio, language="en", beam_size=3, max_new_tokens=16)
    ours = engine.WhisperEngine("test", params=params,
                                device="cpu").transcribe(
        audio, language="en", beam_size=3, max_new_tokens=16)
    assert ours.windows == ref.windows == 2
    assert _segments(ours) == _segments(ref)
    assert ours.text == ref.text
