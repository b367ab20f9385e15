"""Port fine-tuning step (openhush_tpu_torch.training.train and
models/whisper/model.forward) against the JAX package's, on the CPU.

Inputs and parameters are made with numpy (JAX `init_params`, carried over
as numpy arrays) and fed to both. On the CPU the port's encoder attention
is the plain `attend` differentiated by autograd; JAX takes its dense
`_attend` too. Tolerances: logits atol 1e-5 (|logits| ~0.2; fp32 sums in
another order), losses 1e-5 relative, gradients atol 1e-5 of the largest,
optimizer updates 1e-6 relative (fed the same gradients, so only the
optimizer's arithmetic is compared), 3 train steps' losses 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import WhisperConfig
from openhush_tpu.training import train as jax_train
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.training import train

CFG = WhisperConfig(name="traintest", n_mels=80, n_audio_ctx=128,
                    n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                    n_text_state=64, n_text_head=2, n_text_layer=2,
                    n_vocab=51865, n_text_ctx=96, n_langs=99)
B = 2


@pytest.fixture(autouse=True)
def _erf_gelu(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


@pytest.fixture(scope="module")
def jparams():
    return jax_model.init_params(CFG, jax.random.PRNGKey(0))


def _torch_params(jparams):
    return weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     torch.float32, "cpu")


def _batch(S, seed=0, n_prompt=3):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)
                              ).astype(np.float32)
    tokens = rng.integers(0, CFG.n_vocab, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, :n_prompt] = jax_train.IGNORE_ID
    targets[1, S // 2:] = jax_train.IGNORE_ID       # padding on one row
    return mel, tokens, targets


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S", [24, 80], ids=["flat-SH<=128", "long-SH>128"])
def test_forward_matches_jax(jparams, S):
    """Both of the reference decoder's branches (S·H = 48 and 160 against
    its 128 cut) against the port's one causal block."""
    mel, tokens, _ = _batch(S)
    ref = np.asarray(jax.jit(jax_model.forward, static_argnums=0)(
        CFG, jparams, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.no_grad():
        ours = model.forward(CFG, _torch_params(jparams), *_t(mel, tokens))
    assert ours.shape == (B, S, CFG.n_vocab_padded)
    assert ours.dtype == torch.float32
    V = CFG.n_vocab
    np.testing.assert_allclose(ours[..., :V].numpy(), ref[..., :V],
                               atol=1e-5)
    assert bool((ours[..., V:] == torch.finfo(torch.float32).min).all())


def test_loss_and_gradients_match_jax(jparams):
    mel, tokens, targets = _batch(32, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.loss_fn(CFG, p, jnp.asarray(mel),
                                    jnp.asarray(tokens),
                                    jnp.asarray(targets))))(jparams)
    params = _torch_params(jparams)
    loss, grads = train.value_and_grad(CFG, params, *_t(mel, tokens,
                                                       targets))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-3))


def test_loss_of_an_all_ignored_batch_is_zero(jparams):
    mel, tokens, targets = _batch(16, seed=2)
    targets[:] = jax_train.IGNORE_ID
    ref = float(jax.jit(jax_train.loss_fn, static_argnums=0)(
        CFG, jparams, jnp.asarray(mel), jnp.asarray(tokens),
        jnp.asarray(targets)))
    with torch.no_grad():
        ours = float(train.loss_fn(CFG, _torch_params(jparams),
                                   *_t(mel, tokens, targets)))
    assert ours == ref == 0.0


def test_optimizer_matches_optax():
    """The same gradient sequence (global norms above and below the clip
    at 1) through optax's and the port's optimizer, applied to the
    parameters: equal updates, and the schedule's rates (0 on the first
    update)."""
    rng = np.random.default_rng(3)
    shapes = {"b": {"w": (4, 3), "a": (5,)}, "a": (2, 2, 2)}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    opt_j = jax_train.make_optimizer(lr=1e-2, warmup_steps=2,
                                     total_steps=6)
    opt_t = train.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=6)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    pj = jax.tree.map(jnp.asarray, params)
    pt = weights.from_numpy_params(params, torch.float32, "cpu")
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for step, norm in enumerate((5.0, 0.3, 2.0, 0.9, 1.5, 0.05, 3.0)):
        assert opt_t.learning_rate(step) == pytest.approx(
            float(sched(step)), rel=1e-6, abs=1e-12)
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), params)
        total = np.sqrt(sum(float((x ** 2).sum())
                            for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * norm / total).astype(np.float32), g)
        uj, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, uj)
        before = [p.clone() for p in train.leaves(pt)]
        opt_t.apply(pt, [torch.from_numpy(x) for x in jax.tree.leaves(g)],
                    st)
        for a, b, u in zip(train.leaves(pt), jax.tree.leaves(pj),
                           jax.tree.leaves(uj)):
            a, b, u = a.numpy(), np.asarray(b), np.asarray(u)
            # The updates agree to 1e-6 relative; p + u then rounds to
            # within one fp32 ulp of the reference's p + u.
            assert np.all(np.abs(a - b) <= 1e-6 * np.abs(u) + 1e-12
                          + np.spacing(np.abs(b)))
        if step == 0:
            assert all(torch.equal(a, b)
                       for a, b in zip(train.leaves(pt), before))
    assert st.count == 7


def test_three_train_steps_match_jax(jparams):
    """Three steps from the same parameters on the same batch: the losses
    agree, the first update (lr 0) leaves the loss where it was, and the
    parameters are updated in place."""
    mel, tokens, targets = _batch(24, seed=4)
    opt_j = jax_train.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5)
    p = jax.tree.map(jnp.array, jparams)
    s = opt_j.init(p)
    ref = []
    for _ in range(3):
        p, s, loss = jax_train.train_step(CFG, opt_j, p, s, jnp.asarray(mel),
                                          jnp.asarray(tokens),
                                          jnp.asarray(targets))
        ref.append(float(loss))
    opt_t = train.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5)
    params = _torch_params(jparams)
    state = opt_t.init(params)
    tok_emb = params["decoder"]["tok_emb"]
    before = tok_emb.detach().clone()
    ours = []
    for i in range(3):
        out, state, loss = train.train_step(CFG, opt_t, params, state,
                                            *_t(mel, tokens, targets))
        assert out is params and out["decoder"]["tok_emb"] is tok_emb
        ours.append(float(loss))
        if i == 0:
            assert torch.equal(tok_emb.detach(), before)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert ours[1] == pytest.approx(ours[0], rel=1e-6)
    assert ours[2] < ours[0]
    assert state.count == 3


def test_init_train_state_needs_cuda_unless_cpu_is_asked():
    opt = train.make_optimizer()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.init_train_state(CFG, opt, torch.Generator())
    params, state = train.init_train_state(
        CFG, opt, torch.Generator().manual_seed(0), device="cpu")
    ps = train.leaves(params)
    assert all(p.device.type == "cpu" for p in ps)
    assert state.count == 0 and len(state.mu) == len(state.nu) == len(ps)
    assert len(ps) == len(jax.tree.leaves(
        jax.eval_shape(lambda: jax_model.init_params(
            CFG, jax.random.PRNGKey(0)))))


def test_three_bf16_train_steps_match_jax(jparams):
    """init_train_state's dtype: bf16 parameters (the JAX init cast to
    bf16, carried over) and bf16 optimizer moments, three steps on one
    batch. Losses within 1e-2 relative (bf16 keeps 8 bits: 2^-8 = 3.9e-3 a
    rounding, and the two packages round matmul outputs, layer norms'
    casts and the updates in different places); the parameters stay bf16
    and within the updates' size of JAX's; the loss falls."""
    mel, tokens, targets = _batch(24, seed=5)
    mel16 = jnp.asarray(mel, jnp.bfloat16)      # the features in bf16
    opt_j = jax_train.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    s = opt_j.init(p)
    ref = []
    for _ in range(3):
        p, s, loss = jax_train.train_step(CFG, opt_j, p, s, mel16,
                                          jnp.asarray(tokens),
                                          jnp.asarray(targets))
        ref.append(float(loss))
    assert p["decoder"]["tok_emb"].dtype == jnp.bfloat16
    opt_t = train.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.bfloat16, "cpu")
    state = opt_t.init(params)
    ours = []
    for _ in range(3):
        params, state, loss = train.train_step(
            CFG, opt_t, params, state,
            weights.from_numpy_params({"m": np.asarray(mel16)},
                                      torch.bfloat16, "cpu")["m"],
            *_t(tokens, targets))
        ours.append(float(loss))
    assert all(t.dtype == torch.bfloat16 for t in train.leaves(params))
    assert all(m.dtype == torch.bfloat16 for m in state.mu)
    np.testing.assert_allclose(ours, ref, rtol=1e-2)
    assert ours[2] < ours[0]
    # Adam moves each element by about the step's rate (0, 1e-3, 8.5e-4):
    # every element within twice their sum (both packages' updates, one
    # turned against the other), two bf16 roundings of it (2^-7 |p|) and
    # 1% of the leaf's largest value; all but 1e-4 of them within half a
    # rate (bf16 moments can turn an update on a near-zero gradient).
    moved = 2 * sum(opt_t.learning_rate(c) for c in range(3))
    n_far = n_all = 0
    for a, b in zip(train.leaves(params), jax.tree.leaves(p)):
        b = np.asarray(b, np.float32)
        d = np.abs(a.float().detach().numpy() - b)
        big = 1e-2 * np.abs(b).max()
        assert (d <= moved + big + 2.0 ** -7 * np.abs(b)).all()
        n_far += int((d > 5e-4 + big).sum())
        n_all += d.size
    assert n_far <= 1e-4 * n_all
