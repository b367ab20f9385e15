"""Port fine-tuning data pipeline and loop (openhush_tpu_torch.training.
data) against the JAX package's training/data.py on the same synthetic
corpus: manifest and LibriSpeech loading, batch shapes and masking
(identical tokens and targets; the mel to tests/test_torch_mel.py's 5e-5),
and `finetune` end to end on the CPU against the reference's losses (1e-4
relative: fp32 through several AdamW steps)."""

import os
import types

import jax
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import WhisperConfig
from openhush_tpu.training import data as jax_data
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.training import data
from openhush_tpu_torch.training.train import IGNORE_ID

CFG = WhisperConfig(name="traintest", n_mels=80, n_audio_ctx=128,
                    n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                    n_text_state=64, n_text_head=2, n_text_layer=2,
                    n_vocab=51865, n_text_ctx=64, n_langs=99)
TEXTS = ["hello there", "good morning", "testing one two", "final phrase"]


@pytest.fixture(autouse=True)
def _erf_gelu(monkeypatch):
    monkeypatch.setattr(jax_model, "_GELU_MODE", "erf")
    monkeypatch.setattr(model, "_GELU_MODE", "erf")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four tones with noise, a manifest (relative paths, a comment and a
    blank line) and the same files as a LibriSpeech chapter."""
    root = tmp_path_factory.mktemp("corpus")
    chapter = root / "libri" / "19" / "198"
    chapter.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines, trans = ["# audio\ttext", ""], []
    for i, text in enumerate(TEXTS):
        n = 16000 + 4000 * i
        tone = 0.2 * np.sin(2 * np.pi * (200 + 100 * i) * np.arange(n)
                            / 16000)
        audio = (tone + 0.01 * rng.standard_normal(n)).astype(np.float32)
        save_wav(str(root / f"utt{i}.wav"), audio)
        save_wav(str(chapter / f"19-198-{i:04d}.wav"), audio)
        lines.append(f"utt{i}.wav\t{text}")
        trans.append(f"19-198-{i:04d} {text.upper()}")
    (root / "manifest.tsv").write_text("\n".join(lines) + "\n")
    (chapter / "19-198.trans.txt").write_text("\n".join(trans) + "\n")
    return root


def test_manifest_and_librispeech_loading(corpus):
    manifest = str(corpus / "manifest.tsv")
    ours, ref = data.load_manifest(manifest), jax_data.load_manifest(manifest)
    assert [(e.audio_path, e.transcript) for e in ours] == \
        [(e.audio_path, e.transcript) for e in ref]
    assert len(ours) == 4 and os.path.isabs(ours[0].audio_path)
    assert ours[1].transcript == "good morning"
    libri = str(corpus / "libri")
    ours, ref = data.load_librispeech(libri), jax_data.load_librispeech(libri)
    assert sorted((e.audio_path, e.transcript) for e in ours) == \
        sorted((e.audio_path, e.transcript) for e in ref)
    assert len(ours) == 4


def test_batches_match_jax(corpus):
    """Two epochs of batch 2 from the same seed: the same shuffles, the same
    tokens and targets, the same mels; prompt positions and padding are
    masked with IGNORE_ID, and EOT is a target."""
    examples = data.load_manifest(str(corpus / "manifest.tsv"))
    ours = data.WhisperDataset(examples, CFG, batch_size=2, max_tokens=32,
                               seed=3)
    ref = jax_data.WhisperDataset(jax_data.load_manifest(
        str(corpus / "manifest.tsv")), CFG, batch_size=2, max_tokens=32,
        seed=3)
    n = 0
    for _ in range(2):
        for a, b in zip(ours.epoch(), ref.epoch(), strict=True):
            assert a.mel.shape == (2, 80, 3000) and a.mel.dtype == np.float32
            assert a.tokens.shape == a.targets.shape == (2, 32)
            assert a.tokens.dtype == a.targets.dtype == np.int32
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_allclose(a.mel, b.mel, atol=5e-5)
            n += 1
    assert n == 4
    sp = WhisperTokenizer(CFG.n_langs).special
    assert (a.targets[:, :2] == IGNORE_ID).all()
    assert (a.targets == sp.eot).any() and (a.targets == IGNORE_ID).any()
    assert (a.tokens[:, 0] == sp.sot).all()


def test_bad_files_are_skipped(corpus, tmp_path):
    """An unreadable file is skipped with a warning; a batch it leaves
    short is not yielded, as in the reference."""
    examples = data.load_manifest(str(corpus / "manifest.tsv"))[:3]
    examples.append(data.Example(str(tmp_path / "missing.wav"), "gone"))
    ds = data.WhisperDataset(examples, CFG, batch_size=2, seed=0)
    batches = list(ds.epoch())
    assert len(batches) == 1 and batches[0].mel.shape[0] == 2


def _trimmed(ds):
    """Mel frames cut to the tiny encoder context, as tests/
    test_training_data.py does for the reference."""
    orig = ds._encode_example

    def small(ex):
        m, t, g = orig(ex)
        return m[:, : 2 * CFG.n_audio_ctx], t, g
    ds._encode_example = small
    return ds


def test_finetune_matches_jax(corpus):
    """`finetune` on the CPU (the parameters' device) from the same
    parameters over the same corpus: the reference's losses, step for step;
    the first update's learning rate is 0, so the second loss repeats the
    first up to the batch's order, and the loss then falls."""
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0))
    manifest = str(corpus / "manifest.tsv")
    kw = dict(batch_size=2, max_tokens=24, seed=1)
    _, ref = jax_data.finetune(CFG, jax.tree.map(lambda a: a.copy(), jparams),
                               _trimmed(jax_data.WhisperDataset(
                                   jax_data.load_manifest(manifest), CFG,
                                   **kw)), epochs=3, lr=2e-3)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    out, losses = data.finetune(CFG, params, _trimmed(data.WhisperDataset(
        data.load_manifest(manifest), CFG, **kw)), epochs=3, lr=2e-3)
    assert out is params and len(losses) == len(ref) == 6
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_finetune_refuses_a_mesh(corpus):
    """A mesh whose data axis does not divide the batch is refused before
    any step (finetune on a mesh itself: tests/test_torch_parallel.py)."""
    ds = data.WhisperDataset(data.load_manifest(str(corpus / "manifest.tsv")),
                             CFG, batch_size=2)
    mesh = types.SimpleNamespace(n_data=3, n_model=1, data_rank=0,
                                 model_rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="a batch of 2 does not split over "
                                         "a data axis of 3"):
        data.finetune(CFG, {}, ds, mesh=mesh)
