"""Port speaker-model training (openhush_tpu_torch.training.speaker) against
the JAX package's openhush_tpu/training/speaker.py.

The synthesis is numpy in both, byte for byte from the same generator. One
step of each recipe runs from the same parameters (the JAX init, carried
over as numpy) on the same batch through optax.adam in JAX and the port's
optimizer: loss and updated parameters within 1e-5 (of the largest
parameter; where a gradient nears Adam's epsilon, within the update's
size); log-mel batches within 5e-5, the normalized log-mel's
tolerance (tests/test_torch_mel.py). Whole runs draw their parameters and
noise from different generators (torch's, jax.random), so they are held to
behaviour: a short port run makes two unseen speakers cluster into two, as
tests/test_speaker_training.py holds for JAX."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openhush_tpu.models import diarization as jdia
from openhush_tpu.models.whisper.convert import load_npz as jload_npz
from openhush_tpu.training import speaker as jsp
from openhush_tpu_torch.models import diarization as dia
from openhush_tpu_torch.models.whisper.weights import from_numpy_params
from openhush_tpu_torch.training import speaker as sp
from openhush_tpu_torch.training.train import AdamW, leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

LR = 3e-3


def _close(ours: dict, ref: dict, grads: dict):
    """Updated parameters within 1e-5 of the leaf's largest value, except
    where the gradient nears Adam's epsilon: the first update,
    lr·g/(|g| + 1e-8), turns there on the gradient's last bits, so those
    elements are held to the update's size (lr)."""
    assert sorted(ours) == sorted(ref)
    for k in ref:
        r, a = np.asarray(ref[k]), ours[k].detach().numpy()
        tol = 1e-5 * max(np.abs(r).max(), 1e-3)
        well = np.abs(np.asarray(grads[k])) > 1e-6
        np.testing.assert_allclose(a[well], r[well], atol=tol, err_msg=k)
        assert (np.abs(a - r) <= LR + tol).all(), k


def test_synthesis_is_byte_equal():
    a, b = np.random.default_rng(21), np.random.default_rng(21)
    bank, jbank = sp.synth_speaker_bank(a, 5), jsp.synth_speaker_bank(b, 5)
    for s, j in zip(bank, jbank):
        assert s["f0"] == j["f0"] and s["am_hz"] == j["am_hz"]
        assert s["ctrl"].tobytes() == j["ctrl"].tobytes()
    for spk, jspk in zip(bank, jbank):
        assert (sp.synth_utterance(a, spk, 12345).tobytes()
                == jsp.synth_utterance(b, jspk, 12345).tobytes())
    for _ in range(3):
        audio, labels = sp.synth_mixture(a, bank, secs=3.0)
        jaudio, jlabels = jsp.synth_mixture(b, jbank, secs=3.0)
        assert audio.tobytes() == jaudio.tobytes()
        assert labels.tobytes() == jlabels.tobytes()
    assert a.random() == b.random()


def test_mel_batch_matches_jax():
    rng = np.random.default_rng(22)
    bank = sp.synth_speaker_bank(rng, 2)
    audio = np.stack([sp.synth_utterance(rng, s, 100 * 160) for s in bank])
    # 5e-5: the normalized log-mel's tolerance (tests/test_torch_mel.py).
    np.testing.assert_allclose(sp._mel_batch(audio, 100, "cpu").numpy(),
                               np.asarray(jsp._mel_batch(audio, 100)),
                               atol=5e-5)


def test_one_embedder_step_matches_jax():
    rng = np.random.default_rng(23)
    bank = sp.synth_speaker_bank(rng, 4)
    audio = np.stack([sp.synth_utterance(rng, bank[i % 4], 100 * 160)
                      for i in range(8)])
    labels = np.arange(8) % 4
    mel = np.asarray(jsp._mel_batch(audio, 100)) + np.float32(0.05)
    params = jdia.init_embedder_params(jax.random.PRNGKey(0), width=32)
    head = jax.random.normal(jax.random.PRNGKey(1), (dia.EMB_DIM, 4)) \
        * dia.EMB_DIM ** -0.5
    opt = optax.adam(LR)
    ph = (params, head)
    state = opt.init(ph)

    def loss_fn(ph):           # the reference's step, train_embedder
        p, h = ph
        logits = jdia.embed_batch(p, jnp.asarray(mel)) @ h * 10.0
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(ph)
    updates, _ = opt.update(grads, state)
    new_p, new_h = optax.apply_updates(ph, updates)

    tph = {"params": from_numpy_params(jax.tree.map(np.asarray, params),
                                       device="cpu"),
           "head": torch.from_numpy(np.array(head))}
    topt = AdamW(LR)
    tstate = topt.init(tph)
    tloss = sp.embedder_step(topt, tph, tstate, torch.from_numpy(mel),
                             torch.from_numpy(labels))
    assert float(tloss) == pytest.approx(float(loss), abs=1e-5)
    _close(tph["params"], new_p, grads[0])
    _close({"head": tph["head"]}, {"head": new_h}, {"head": grads[1]})
    assert tstate.count == 1 and len(tstate.mu) == len(leaves(tph))


def test_one_segmentation_step_matches_jax():
    rng = np.random.default_rng(24)
    bank = sp.synth_speaker_bank(rng, 4)
    auds, labs = zip(*(sp.synth_mixture(rng, bank, secs=2.0)
                       for _ in range(3)))
    mel = np.asarray(jsp._mel_batch(np.stack(auds), 200))
    labels = np.stack(labs)
    params = jdia.init_segmentation_params(jax.random.PRNGKey(2), hidden=32)
    opt = optax.adam(LR)
    state = opt.init(params)

    def loss_fn(p):            # the reference's step, train_segmentation
        acts = jdia.segmentation_activities(p, jnp.asarray(mel))
        acts = jnp.clip(acts, 1e-6, 1 - 1e-6)
        lab = jnp.asarray(labels)
        return -(lab * jnp.log(acts) + (1 - lab) * jnp.log(1 - acts)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, state)
    new = optax.apply_updates(params, updates)

    tparams = from_numpy_params(jax.tree.map(np.asarray, params),
                                device="cpu")
    topt = AdamW(LR)
    tloss = sp.segmentation_step(topt, tparams, topt.init(tparams),
                                 torch.from_numpy(mel),
                                 torch.from_numpy(labels))
    assert float(tloss) == pytest.approx(float(loss), abs=1e-5)
    _close(tparams, new, grads)


@pytest.fixture(scope="module")
def trained():
    losses = []
    params = sp.train_embedder(seed=0, n_speakers=8, steps=60, batch=24,
                               device="cpu", losses=losses)
    return params, losses


def test_short_training_clusters_two_unseen_speakers(trained):
    """Speakers not in the training bank, the default 0.6 threshold."""
    params, losses = trained
    assert len(losses) == 60 and np.mean(losses[-10:]) < np.mean(losses[:10])
    rng = np.random.default_rng(99)
    bank = sp.synth_speaker_bank(rng, 2)

    def embed(audio):
        with torch.no_grad():
            return dia.speaker_embedding(params, torch.from_numpy(audio),
                                         100).numpy()

    embs = {s: [embed(sp.synth_utterance(rng, bank[s], 100 * 160))
                for _ in range(6)] for s in (0, 1)}
    within = np.mean([e1 @ e2 for s in (0, 1)
                      for e1, e2 in itertools.combinations(embs[s], 2)])
    between = np.mean([e1 @ e2 for e1 in embs[0] for e2 in embs[1]])
    assert within > 0.7, f"within-speaker similarity too low: {within}"
    assert between < 0.4, f"between-speaker similarity too high: {between}"
    cl = dia.EmbeddingClusterer(dia.DiarizationConfig())
    ids = [cl.assign(e) for s in (0, 1) for e in embs[s]]
    assert cl.n_speakers == 2
    assert ids[:6] == [0] * 6 and ids[6:] == [1] * 6


def test_training_is_deterministic():
    kw = dict(seed=3, n_speakers=3, steps=2, batch=4, utts_per_speaker=2,
              device="cpu")
    p1, p2 = sp.train_embedder(**kw), sp.train_embedder(**kw)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=0)


def test_main_writes_npz_the_jax_package_reads(tmp_path):
    assert sp.main(["--out-dir", str(tmp_path), "--steps", "2",
                    "--n-speakers", "3", "--device", "cpu"]) == 0
    emb = jload_npz(str(tmp_path / "speaker_embedder.npz"))
    seg = jload_npz(str(tmp_path / "segmentation.npz"))
    ref_emb = jdia.init_embedder_params(jax.random.PRNGKey(0))
    ref_seg = jdia.init_segmentation_params(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in emb.items()} == {
        k: v.shape for k, v in ref_emb.items()}
    assert {k: v.shape for k, v in seg.items()} == {
        k: v.shape for k, v in ref_seg.items()}
    # The JAX engine runs the port's checkpoint.
    eng = jdia.DiarizationEngine(
        params={k: jnp.asarray(v) for k, v in emb.items()},
        seg_params={k: jnp.asarray(v) for k, v in seg.items()})
    assert eng.embed(np.zeros(16000, np.float32)).shape == (dia.EMB_DIM,)
