"""Port diarization (openhush_tpu_torch.models.diarization) against the JAX
package's openhush_tpu/models/diarization.py, on the committed trained
checkpoints (openhush_tpu/assets/diarization/*.npz, read by both) and the
same numpy audio.

Tolerances: embeddings, activities and fbank features within atol 1e-5
(fp32 convolutions as unfolded matmuls against XLA's at fp32, sums in
another order); powerset marginals, cluster assignments, segments and
speakers equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models import diarization as jdia
from openhush_tpu.models.whisper.convert import load_npz as jload_npz
from openhush_tpu.training import speaker as jsp
from openhush_tpu.utils import onnx_io as jonnx_io
from openhush_tpu_torch.models import diarization as dia
from openhush_tpu_torch.models.whisper.weights import (from_numpy_params,
                                                       load_npz)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one machine, and eight threads each oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ATOL = 1e-5
SR = 16000


def _jparams(name):
    path = os.path.join(dia.ASSETS, name)
    return {k: jnp.asarray(v) for k, v in jload_npz(path).items()}


def _tparams(name):
    return from_numpy_params(load_npz(os.path.join(dia.ASSETS, name)),
                             device="cpu")


@pytest.fixture(scope="module")
def emb():
    return _jparams("speaker_embedder.npz"), _tparams("speaker_embedder.npz")


@pytest.fixture(scope="module")
def seg():
    return _jparams("segmentation.npz"), _tparams("segmentation.npz")


def _conversation(seed: int, secs_each: float = 1.8, n_turns: int = 4):
    """Two synthetic speakers taking turns with short gaps (~10 s)."""
    rng = np.random.default_rng(seed)
    bank = jsp.synth_speaker_bank(rng, 2)
    gap = np.zeros(int(0.6 * SR), np.float32)
    parts = [gap]
    for i in range(n_turns):
        parts += [jsp.synth_utterance(rng, bank[i % 2],
                                      int(secs_each * SR)), gap]
    return np.concatenate(parts)


def test_assets_are_the_packaged_checkpoints():
    assert os.path.isdir(dia.ASSETS)
    assert sorted(os.listdir(dia.ASSETS)) == ["segmentation.npz",
                                              "speaker_embedder.npz"]


def test_embed_batch_matches_jax(emb):
    mel = np.random.default_rng(0).standard_normal((3, 120, 80)).astype(
        np.float32)
    ref = np.asarray(jdia.embed_batch(emb[0], jnp.asarray(mel)))
    with torch.no_grad():
        ours = dia.embed_batch(emb[1], torch.from_numpy(mel)).numpy()
    assert ours.shape == (3, dia.EMB_DIM)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n_frames", [100, 173])
def test_speaker_embedding_matches_jax(emb, n_frames):
    audio = _conversation(1)[:n_frames * 160]
    ref = np.asarray(jdia.speaker_embedding(emb[0], jnp.asarray(audio),
                                            n_frames=n_frames))
    with torch.no_grad():
        ours = dia.speaker_embedding(emb[1], torch.from_numpy(audio),
                                     n_frames).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_segmentation_activities_matches_jax(seg):
    audio = _conversation(2)[:400 * 160]
    mel = np.array(jsp._mel_batch(audio[None], 400))
    ref = np.asarray(jdia.segmentation_activities(seg[0], jnp.asarray(mel)))
    with torch.no_grad():
        ours = dia.segmentation_activities(seg[1],
                                           torch.from_numpy(mel)).numpy()
    assert ours.shape == (1, 100, dia.SEG_K)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    # Batched random mel, through both GRUs' gate orders.
    mel = np.random.default_rng(3).standard_normal((2, 64, 80)).astype(
        np.float32)
    ref = np.asarray(jdia.segmentation_activities(seg[0], jnp.asarray(mel)))
    with torch.no_grad():
        ours = dia.segmentation_activities(seg[1],
                                           torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("n", [250, 16000, 23456])
def test_kaldi_fbank_matches_jax(n):
    audio = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    ours, ref = dia.kaldi_fbank(audio), jdia.kaldi_fbank(audio)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_powerset_to_activities_matches_jax():
    logits = np.random.default_rng(4).standard_normal((50, 7))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for p in (probs, probs[:, :4]):
        np.testing.assert_array_equal(dia.powerset_to_activities(p),
                                      jdia.powerset_to_activities(p))


@pytest.mark.parametrize("threshold,cap", [(0.6, 8), (0.2, 8), (0.9, 3)])
def test_embedding_clusterer_matches_jax(threshold, cap):
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((4, 16))
    embs = [centers[i % 4] + 0.6 * rng.standard_normal(16)
            for i in range(40)]
    ours = dia.EmbeddingClusterer(dia.DiarizationConfig(threshold, cap))
    ref = jdia.EmbeddingClusterer(jdia.DiarizationConfig(threshold, cap))
    assert [ours.assign(e) for e in embs] == [ref.assign(e) for e in embs]
    assert ours.n_speakers == ref.n_speakers
    for a, b in zip(ours.centroids, ref.centroids):
        np.testing.assert_array_equal(a, b)


def _segments(segs):
    return [(s.start_secs, s.end_secs, s.speaker_id) for s in segs]


def test_from_local_diarize_chunk_matches_jax(tmp_path, monkeypatch):
    """The packaged checkpoints through from_local, on ~10 s of two
    synthetic speakers: the same segments and speakers."""
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    ours = dia.DiarizationEngine.from_local(device="cpu")
    ref = jdia.DiarizationEngine.from_local()
    assert ours.has_segmentation and ours.seg_fn is None
    audio = _conversation(8)
    got = _segments(ours.diarize_chunk(audio, offset_secs=2.0))
    want = _segments(ref.diarize_chunk(audio, offset_secs=2.0))
    assert got == want
    assert len(got) >= 3
    assert ours.clusterer.n_speakers == ref.clusterer.n_speakers == 2
    ours.reset()
    assert ours.clusterer.n_speakers == 0


def test_fixed_windows_without_segmentation_match_jax(emb):
    """No segmentation backend: fixed 1.5 s windows, silence skipped,
    adjacent same-speaker windows merged."""
    ours = dia.DiarizationEngine(params=emb[1], device="cpu")
    ref = jdia.DiarizationEngine(params=emb[0])
    audio = _conversation(7, secs_each=3.0)
    assert not ours.has_segmentation
    assert (_segments(ours.diarize_chunk(audio))
            == _segments(ref.diarize_chunk(audio)))


def _onnx_model(io, nodes, inits, inp, shape, out):
    return io.OnnxModel(io.OnnxGraph(
        nodes=nodes, initializers=inits,
        inputs=[io.OnnxValueInfo(inp, 1, shape)],
        outputs=[io.OnnxValueInfo(out, 1, ())]))


def test_onnx_backends_match_jax(tmp_path, monkeypatch):
    """A pyannote-style segmentation graph (waveform [1, 1, N] → log-softmax
    powerset scores [1, T, 7]) and a wespeaker-style embedder (fbank
    [1, T, 80] → [1, D]) in <model_dir>/aux, through from_local on the ONNX
    executor: the same activities, embeddings and segments as JAX's."""
    n, hop = 32000, 160
    frames = n // hop
    rng = np.random.default_rng(8)
    w = np.zeros((1, 7), np.float32)
    w[0, 0], w[0, 1] = -80.0, 80.0
    N = jonnx_io.OnnxNode
    seg = _onnx_model(jonnx_io, [
        N("Reshape", ["audio", "fshape"], ["fr"]),
        N("Abs", ["fr"], ["fa"]),
        N("ReduceMean", ["fa"], ["fe"], attrs={"axes": [1], "keepdims": 1}),
        N("MatMul", ["fe", "w"], ["fm"]),
        N("Add", ["fm", "b"], ["fl"]),
        N("LogSoftmax", ["fl"], ["fs"], attrs={"axis": -1}),
        N("Reshape", ["fs", "oshape"], ["scores"]),
    ], {"fshape": np.array([frames, hop], np.int64),
        "oshape": np.array([1, frames, 7], np.int64), "w": w,
        "b": np.array([[1.0, 0.0, -9, -9, -9, -9, -9]], np.float32)},
        "audio", (1, 1, n), "scores")
    wes = _onnx_model(jonnx_io, [
        N("ReduceMean", ["feats"], ["m"], attrs={"axes": [1],
                                                 "keepdims": 0}),
        N("Gemm", ["m", "wd", "bd"], ["e"]),
    ], {"wd": rng.standard_normal((80, 32)).astype(np.float32),
        "bd": rng.standard_normal(32).astype(np.float32)},
        "feats", (1, "T", 80), "e")
    aux = tmp_path / "aux"
    aux.mkdir()
    jonnx_io.save(seg, str(aux / "segmentation.onnx"))
    jonnx_io.save(wes, str(aux / "wespeaker.onnx"))
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    ours = dia.DiarizationEngine.from_local(device="cpu")
    ref = jdia.DiarizationEngine.from_local()
    assert ours.seg_fn is not None and ours._embedder_fn is not None
    audio = np.zeros(n, np.float32)
    audio[20 * hop:90 * hop] = 0.4 * np.sin(np.arange(70 * hop) / 7.0)
    audio[120 * hop:190 * hop] = 0.3 * np.sign(np.sin(np.arange(70 * hop)
                                                      / 3.0))
    np.testing.assert_allclose(ours.activities(audio), ref.activities(audio),
                               atol=ATOL)
    np.testing.assert_allclose(ours.embed(audio[:16000]),
                               ref.embed(audio[:16000]), atol=ATOL)
    assert (_segments(ours.diarize_chunk(audio))
            == _segments(ref.diarize_chunk(audio)))
    assert len(ours.segment_regions(audio)) == 2


def test_default_embedder_comes_from_a_generator():
    a = dia.DiarizationEngine(device="cpu")
    b = dia.DiarizationEngine(device="cpu")
    for k, v in a.params.items():
        torch.testing.assert_close(v, b.params[k], rtol=0, atol=0)
    ref = jdia.init_embedder_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in a.params.items()} == {
        k: v.shape for k, v in ref.items()}
    seg = dia.init_segmentation_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    jseg = jdia.init_segmentation_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in seg.items()} == {
        k: v.shape for k, v in jseg.items()}
