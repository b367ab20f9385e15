"""Port draft distillation (openhush_tpu_torch.training.distill) against the
JAX package's openhush_tpu/training/distill.py, at the reference test's
configs ("test" teacher, "test-draft" draft; tests/test_distill.py).

Inputs are made with numpy and the parameters are the JAX init_params
outputs, carried over as numpy. Tolerances: rollout tokens equal, features
within 1e-5; CE within 1e-5 and agreement equal; one AdamW step's CE and
updated decoder parameters within 1e-5 relative (where the gradient is
not near Adam's epsilon); distill_draft's stats within 1e-3 (they are
rounded to 3-4 digits). The four repaired faults of the reference each
have a test that shows where the port's result differs from the JAX
function's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openhush_tpu.models.whisper import decoding as jdecoding
from openhush_tpu.models.whisper import model as jw
from openhush_tpu.models.whisper.config import get_config
from openhush_tpu.text.tokenizer import WhisperTokenizer
from openhush_tpu.training import distill as jd
from openhush_tpu_torch.models.whisper import weights
from openhush_tpu_torch.training import distill
from openhush_tpu_torch.training.train import AdamW, leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

B = 4
GEN = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return weights.from_numpy_params(_np_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def setup():
    cfg, dcfg = get_config("test"), get_config("test-draft")
    params = jw.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tok = WhisperTokenizer(cfg.n_langs)
    sup = jdecoding.build_suppress_mask(
        tok, cfg, jdecoding.DecodingOptions(without_timestamps=True)).copy()
    sup_eot = sup.copy()
    sup_eot[tok.special.eot] = True     # run to the token budget (as bench)
    prompt = np.tile(np.asarray(
        tok.sot_sequence("en", "transcribe", timestamps=False), np.int32),
        (B, 1))
    return dict(cfg=cfg, dcfg=dcfg, params=params, tparams=_t(params),
                sup=sup_eot, sup_open=sup, prompt=prompt,
                eot=tok.special.eot)


def _mel_fn(cfg):
    def fn(rng):
        return (0.1 * rng.standard_normal(
            (B, cfg.n_mels, 3000))).astype(np.float32)
    return fn


def _rollouts(s, sup, seed):
    """(JAX features, JAX tokens, port features, port tokens) of one
    rollout batch under the suppress mask `sup`."""
    mel = _mel_fn(s["cfg"])(np.random.default_rng(seed))
    P = s["prompt"].shape[1]
    jf, jt = jd.teacher_rollout(s["cfg"], s["params"], jnp.asarray(mel),
                                jnp.asarray(s["prompt"]), jnp.asarray(sup),
                                prompt_len=P, gen_tokens=GEN)
    f, t = distill.teacher_rollout(
        s["cfg"], s["tparams"], torch.from_numpy(mel),
        torch.from_numpy(s["prompt"]).long(), torch.from_numpy(sup),
        prompt_len=P, gen_tokens=GEN)
    return jf, jt, f, t


@pytest.fixture(scope="module")
def batch(setup):
    return _rollouts(setup, setup["sup"], 3)


@pytest.fixture(scope="module")
def draft_dec(setup):
    return jw.init_params(setup["dcfg"], jax.random.PRNGKey(1),
                          dtype=jnp.float32)["decoder"]


def test_teacher_rollout_matches_jax(setup, batch):
    jf, jt, f, t = batch
    P = setup["prompt"].shape[1]
    assert t.shape == (B, P + GEN) and t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(t[:, :P].numpy(), setup["prompt"])
    assert not setup["sup"][t[:, P:].numpy().ravel()].any()
    assert f.shape == (B, setup["cfg"].n_audio_ctx, setup["cfg"].n_audio_state)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)


def test_ce_and_agree_matches_jax(setup, batch, draft_dec):
    jf, jt, f, t = batch
    P = setup["prompt"].shape[1]
    jce, jag = jd._ce_and_agree(setup["dcfg"], draft_dec, jf, jt,
                                jnp.asarray(setup["sup"]), P)
    ce, ag = distill._ce_and_agree(setup["dcfg"], _t(draft_dec), f, t,
                                   torch.from_numpy(setup["sup"]), P,
                                   eot=setup["eot"])
    assert float(ce) == pytest.approx(float(jce), abs=1e-5)
    assert round(float(ag) * B * GEN) == round(float(jag) * B * GEN)


def test_one_distill_step_matches_jax(setup, batch, draft_dec):
    jf, jt, f, t = batch
    P = setup["prompt"].shape[1]
    lr, wd = 1e-3, 0.01
    jdec = jax.tree.map(jnp.array, draft_dec)
    jstate = optax.adamw(lr, weight_decay=wd).init(jdec)
    jdec, _, jce, jag = jd._distill_step(
        setup["dcfg"], (lr, wd), jdec, jstate, jf, jt,
        jnp.asarray(setup["sup"]), prompt_len=P)
    dec = _t(draft_dec)
    opt = AdamW(lr, wd)
    state = opt.init(dec)
    out, state, ce, ag = distill._distill_step(
        setup["dcfg"], opt, dec, state, f, t, torch.from_numpy(setup["sup"]),
        prompt_len=P, eot=setup["eot"])
    assert out is dec and state.count == 1
    assert float(ce) == pytest.approx(float(jce), rel=1e-5)
    assert float(ag) == pytest.approx(float(jag), abs=1e-6)
    # Adam's first update is lr·g/(|g| + 1e-8): where |g| nears 1e-8 it
    # turns on the gradient's last bits (sums in another order), so those
    # elements are held to the update's size, the rest to 1e-5.
    jgrads = jax.grad(lambda dp: jd._ce_and_agree(
        setup["dcfg"], dp, jf, jt, jnp.asarray(setup["sup"]), P)[0])(
            draft_dec)
    ref = [np.asarray(x) for x in jax.tree.leaves(jdec)]
    ours = leaves(dec)
    assert len(ours) == len(ref)
    for a, r, g in zip(ours, ref, jax.tree.leaves(jgrads)):
        a, tol = a.detach().numpy(), 1e-5 * max(np.abs(r).max(), 1e-3)
        well = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(a[well], r[well], atol=tol)
        assert (np.abs(a - r) <= lr + tol).all()


def _jax_logits(setup, dec, feats, tokens, int8_cross=True):
    """The reference's draft logits over a rollout from position 0: its
    decode over an empty cache on compute_cross_kv_quant (the int8
    cross-KV the server installs) or compute_cross_kv, composed from the
    JAX package's functions."""
    dcfg = setup["dcfg"]
    dparams = {"decoder": dec}
    xkv = (jw.compute_cross_kv_quant if int8_cross
           else jw.compute_cross_kv)(dcfg, dparams, feats)
    cache = jw.init_kv_cache(dcfg, B, dtype=jnp.float32, max_len=64)
    logits, _ = jw.decode(dcfg, dparams, tokens[:, :-1], jnp.int32(0),
                          cache, xkv)
    return np.asarray(logits, np.float64)


def _ce_agree_np(logits, tokens, sup, P, mask=None):
    tgt = np.asarray(tokens)[:, 1:]
    S = tgt.shape[1]
    if mask is None:
        mask = np.broadcast_to(np.arange(S)[None] >= P - 1, (B, S))
    lp = logits - logits.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    nll = -np.take_along_axis(lp, tgt[..., None], -1)[..., 0]
    pred = np.where(sup[None, None], -1e9, logits).argmax(-1)
    return ((nll * mask).sum() / mask.sum(),
            ((pred == tgt) * mask).sum() / mask.sum())


def _jax_pieces_eval(setup, dec, feats, tokens, sup):
    """The reference's CE/agreement of a draft decoder on a rollout, its
    decode run on the int8 cross-KV."""
    return _ce_agree_np(_jax_logits(setup, dec, feats, tokens), tokens, sup,
                        setup["prompt"].shape[1])


def test_distill_draft_matches_jax(setup, monkeypatch):
    """On the reference's inputs (EOT suppressed, n_batches >= 1, no
    budget) the stats equal JAX's, except the held-out ones, which the
    port takes on the int8 cross-KV: those equal the JAX pieces composed
    with compute_cross_kv_quant, at the draft's initial and trained
    decoder."""
    cfg, dcfg, seed = setup["cfg"], setup["dcfg"], 11
    kw = dict(n_batches=2, epochs=2, gen_tokens=GEN, lr=1e-3, seed=seed)
    jdraft, jstats = jd.distill_draft(cfg, setup["params"], dcfg,
                                      _mel_fn(cfg), setup["prompt"],
                                      setup["sup"], serve_dtype=jnp.float32,
                                      **kw)
    jinit = jw.init_params(dcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    monkeypatch.setattr(weights, "init_params",
                        lambda cfg_, gen, dtype, device: (
                            weights.from_numpy_params(_np_tree(jinit), dtype,
                                                      device)))
    draft, stats = distill.distill_draft(cfg, setup["tparams"], dcfg,
                                         _mel_fn(cfg), setup["prompt"],
                                         setup["sup"],
                                         serve_dtype=torch.float32, **kw)
    assert stats.pop("heldout_is_train") is False
    assert sorted(stats) == sorted(jstats)
    for k in ("rollout_batches", "gen_tokens", "steps"):
        assert stats[k] == jstats[k]
    for k in ("train_ce", "train_agree"):
        assert stats[k] == pytest.approx(jstats[k], abs=1e-3), k
    # The held-out batch: the last of n_batches + 1 draws from the seed.
    rng = np.random.default_rng(seed)
    mel = [_mel_fn(cfg)(rng) for _ in range(kw["n_batches"] + 1)][-1]
    hf, ht = jd.teacher_rollout(cfg, setup["params"], jnp.asarray(mel),
                                jnp.asarray(setup["prompt"]),
                                jnp.asarray(setup["sup"]),
                                prompt_len=setup["prompt"].shape[1],
                                gen_tokens=GEN)
    for pre, dec in (("init_", jinit["decoder"]), ("", jdraft["decoder"])):
        ce, ag = _jax_pieces_eval(setup, dec, hf, ht, setup["sup"])
        assert stats[pre + "heldout_ce"] == pytest.approx(ce, abs=1e-3)
        assert stats[pre + "heldout_agree"] == pytest.approx(ag, abs=1e-3)
    # Each of the 4 steps moves an element by at most about lr; elements
    # whose gradient nears Adam's epsilon may part by that much, the rest
    # (all but 1e-4 of them) stay within 1e-4.
    far = total = 0
    for a, r in zip(leaves(draft["decoder"]),
                    jax.tree.leaves(jdraft["decoder"])):
        d = np.abs(a.numpy() - np.asarray(r))
        assert (d <= 4 * kw["lr"] + 1e-4).all()
        far, total = far + int((d > 1e-4).sum()), total + d.size
    assert far <= 1e-4 * total
    assert draft["decoder"]["tok_emb"].dtype == torch.float32


def test_zero_time_budget_is_a_budget(setup):
    """Repaired fault: the reference reads time_budget_s=0.0 as no
    deadline and runs every rollout and epoch; the port stops after one
    rollout batch (and the held-out one) and one epoch, and still returns
    a complete bf16 draft."""
    cfg, dcfg = setup["cfg"], setup["dcfg"]
    kw = dict(n_batches=3, epochs=4, gen_tokens=GEN, time_budget_s=0.0,
              seed=5)
    _, jstats = jd.distill_draft(cfg, setup["params"], dcfg, _mel_fn(cfg),
                                 setup["prompt"], setup["sup"], **kw)
    draft, stats = distill.distill_draft(cfg, setup["tparams"], dcfg,
                                         _mel_fn(cfg), setup["prompt"],
                                         setup["sup"], **kw)
    assert (jstats["rollout_batches"], jstats["steps"]) == (3, 12)
    assert (stats["rollout_batches"], stats["steps"]) == (1, 1)
    assert not stats["heldout_is_train"]
    assert draft["decoder"]["tok_emb"].dtype == torch.bfloat16
    assert sorted(draft) == ["decoder", "encoder"]


def test_heldout_eval_runs_on_the_int8_cross_kv(setup, batch, draft_dec):
    """Repaired fault: the reference's held-out eval runs the draft on the
    fp cross-KV; the port's on the int8 one the server installs. Its
    numbers equal the JAX pieces composed with compute_cross_kv_quant and
    differ from the reference's _eval_step."""
    jf, jt, f, t = batch
    P = setup["prompt"].shape[1]
    sup = setup["sup"]
    ce, ag = distill._eval_step(setup["dcfg"], _t(draft_dec), f, t,
                                torch.from_numpy(sup), prompt_len=P,
                                eot=setup["eot"])
    want_ce, want_ag = _jax_pieces_eval(setup, draft_dec, jf, jt, sup)
    assert float(ce) == pytest.approx(want_ce, abs=1e-5)
    assert float(ag) == pytest.approx(want_ag, abs=1e-6)
    # The logits themselves: the int8 cross-KV's, not the fp one's.
    ours = distill._draft_logits(setup["dcfg"], _t(draft_dec), f, t[:, :-1],
                                 int8_cross=True).numpy()
    int8 = _jax_logits(setup, draft_dec, jf, jt)
    fp = _jax_logits(setup, draft_dec, jf, jt, int8_cross=False)
    np.testing.assert_allclose(ours, int8, atol=1e-5)
    assert np.abs(ours - fp).max() > 1e-4        # 10x the tolerance


def test_positions_past_eot_are_left_out(setup, draft_dec):
    """Repaired fault: with the serving mask (EOT not suppressed) a row's
    targets after its first EOT are left out of CE and agreement; the
    reference weights them fully."""
    jf, jt, f, t = _rollouts(setup, setup["sup_open"], 4)
    eot, P = setup["eot"], setup["prompt"].shape[1]
    t = t.clone()
    t[0, P + 5] = eot                  # an EOT inside row 0's rollout
    t[1, P] = eot                      # and at row 1's first position
    jt = jnp.asarray(t.numpy().astype(np.int32))
    sup = setup["sup_open"]
    ce, ag = distill._ce_and_agree(setup["dcfg"], _t(draft_dec), f, t,
                                   torch.from_numpy(sup), P, eot=eot)
    # Expected: JAX's logits (its teacher-forced decode), masked past EOT.
    S = t.shape[1] - 1
    mask = np.broadcast_to(np.arange(S)[None] >= P - 1, (B, S)).copy()
    mask[0, P + 5:] = False            # target index P+4 is the EOT itself
    mask[1, P:] = False
    want_ce, want_ag = _ce_agree_np(
        _jax_logits(setup, draft_dec, jf, jt, int8_cross=False), t, sup, P,
        mask)
    assert float(ce) == pytest.approx(want_ce, abs=1e-5)
    assert float(ag) == pytest.approx(want_ag, abs=1e-6)
    jce, _ = jd._ce_and_agree(setup["dcfg"], draft_dec, jf, jt,
                              jnp.asarray(sup), P)
    assert abs(float(jce) - float(ce)) > 1e-4


def test_heldout_is_train_when_no_batch_is_left(setup):
    """Repaired fault: with n_batches 0 the only batch is the held-out
    one, and training falls back to it; the port says so in its stats,
    the reference reports its train agreement as held-out silently."""
    cfg, dcfg = setup["cfg"], setup["dcfg"]
    kw = dict(n_batches=0, epochs=1, gen_tokens=GEN, seed=6)
    _, jstats = jd.distill_draft(cfg, setup["params"], dcfg, _mel_fn(cfg),
                                 setup["prompt"], setup["sup"], **kw)
    _, stats = distill.distill_draft(cfg, setup["tparams"], dcfg,
                                     _mel_fn(cfg), setup["prompt"],
                                     setup["sup"], **kw)
    assert "heldout_is_train" not in jstats
    assert jstats["rollout_batches"] == 1
    assert stats["heldout_is_train"] is True
    assert stats["rollout_batches"] == 1 and stats["steps"] == 1
