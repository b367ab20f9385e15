"""Port wake-word detector (openhush_tpu_torch.models.wakeword) against the
JAX package's openhush_tpu/models/wakeword.py, on the same numpy audio and
the same carried weights (the JAX detector's init_params outputs).

Tolerances: log-mel frames within 1e-5 (values up to ~10; fp32 matmuls
summed in another order); embeddings within 1e-5; scores within 1e-6;
detections equal. The port's time convolution is an fp32 matmul, as the
JAX one runs at the tests' Precision.HIGHEST."""

import jax
import numpy as np
import pytest
import torch

from openhush_tpu.models import wakeword as jww
from openhush_tpu_torch.models import wakeword as ww
from openhush_tpu_torch.models.whisper.weights import from_numpy_params


def _chunks(n: int, seed: int, amp: float = 0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(ww.CHUNK_SAMPLES) / 16000
    out = []
    for i in range(n):
        tone = np.sin(2 * np.pi * (300 + 25 * i) * t) * (i % 5 < 3)
        x = amp * tone + 0.05 * rng.standard_normal(ww.CHUNK_SAMPLES)
        out.append(x[: 1000 if i % 9 == 4 else None].astype(np.float32))
    return out


def _pair(**cfg):
    ref = jww.WakeWordDetector(jww.WakeWordConfig(**cfg))
    ours = ww.WakeWordDetector(
        ww.WakeWordConfig(**cfg),
        emb_params=from_numpy_params(ref.emb_params, device="cpu"),
        cls_params=from_numpy_params(ref.cls_params, device="cpu"),
        device="cpu")
    return ours, ref


def test_melspectrogram_chunk_matches_jax():
    rng = np.random.default_rng(1)
    audio = (0.3 * rng.standard_normal(ww.CHUNK_SAMPLES)).astype(np.float32)
    tail = (0.3 * rng.standard_normal(ww.TAIL)).astype(np.float32)
    ours = ww.melspectrogram_chunk(torch.from_numpy(audio),
                                   torch.from_numpy(tail))
    ref = jww.melspectrogram_chunk(audio, tail)
    assert tuple(ours.shape) == (ww.MEL_FRAMES_PER_CHUNK, ww.N_MEL_BINS)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_embed_and_classify_match_jax():
    key = jax.random.PRNGKey(2)
    jemb = jww.init_embedding_params(key)
    jcls = jww.init_classifier_params(jax.random.fold_in(key, 1))
    emb, cls = (from_numpy_params(p, device="cpu") for p in (jemb, jcls))
    rng = np.random.default_rng(3)
    mel = rng.uniform(0, 3, (ww.EMB_WINDOW, ww.N_MEL_BINS)).astype(np.float32)
    e = ww.embed_window(emb, torch.from_numpy(mel))
    np.testing.assert_allclose(e.numpy(), np.asarray(jww.embed_window(jemb, mel)),
                               atol=1e-5)
    embs = rng.standard_normal((ww.CLS_WINDOW, ww.EMB_DIM)).astype(np.float32)
    assert float(ww.classify_window(cls, torch.from_numpy(embs))) == \
        pytest.approx(float(jww.classify_window(jcls, embs)), abs=1e-6)


@pytest.mark.parametrize("threshold,refractory", [(0.5, 2.0), (0.0, 0.5),
                                                  (0.0, 0.0)])
def test_stream_scores_and_detections_match_jax(threshold, refractory):
    ours, ref = _pair(threshold=threshold, refractory_secs=refractory)
    scores, hits = [], []
    for c in _chunks(45, 4):
        a, b = ours.process(c), ref.process(c)
        assert (a is None) == (b is None)
        if a is not None:
            scores.append((a, b))
        hits.append((ours.detected(a), ref.detected(b)))
    # Warm after 76 mel frames (10 chunks) and 16 embeddings (15 more).
    assert len(scores) == 45 - 24
    np.testing.assert_allclose(*zip(*scores), atol=1e-6)
    assert [h[0] for h in hits] == [h[1] for h in hits]
    if threshold == 0.0:
        assert any(h[0] for h in hits)


def test_reset_and_save_load_round_trip(tmp_path):
    ours, ref = _pair()
    chunks = _chunks(30, 5)
    for c in chunks:
        ours.process(c)
    ours.reset()
    path = str(tmp_path / "ww.npz")
    ours.save(path)
    loaded = ww.WakeWordDetector.load(path, device="cpu")
    jloaded = jww.WakeWordDetector.load(path)     # the JAX package reads it
    for c in chunks:
        a, b, r = loaded.process(c), ours.process(c), jloaded.process(c)
        assert a == b
        assert (a is None) == (r is None)
        if a is not None:
            assert a == pytest.approx(r, abs=1e-6)


def test_default_params_come_from_a_generator():
    d1 = ww.WakeWordDetector(device="cpu")
    d2 = ww.WakeWordDetector(device="cpu")
    for k, v in d1.emb_params.items():
        torch.testing.assert_close(v, d2.emb_params[k], rtol=0, atol=0)
    assert tuple(d1.cls_params["w1"].shape) == (ww.CLS_WINDOW * ww.EMB_DIM, 128)


def test_from_onnx_raises(tmp_path):
    """from_onnx raises on a missing graph file, and on two written graphs
    (openWakeWord's I/O layouts) scores as JAX's from_onnx does."""
    import sys
    from pathlib import Path

    from openhush_tpu_torch.utils import onnx_io
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    with pytest.raises(FileNotFoundError):
        ww.WakeWordDetector.from_onnx(str(tmp_path / "emb.onnx"),
                                      str(tmp_path / "cls.onnx"),
                                      device="cpu")
    emb, cls_m = chip_smoke.wakeword_graphs(np.random.default_rng(5))
    ep, cp = str(tmp_path / "emb.onnx"), str(tmp_path / "cls.onnx")
    onnx_io.save(emb, ep)
    onnx_io.save(cls_m, cp)
    ours = ww.WakeWordDetector.from_onnx(ep, cp, device="cpu")
    ref = jww.WakeWordDetector.from_onnx(ep, cp)
    got = [(ours.process(c), ref.process(c)) for c in _chunks(25, 6)]
    assert got[-1][0] is not None
    for a, r in got:
        assert (a is None) == (r is None)
        if a is not None:
            assert a == pytest.approx(r, abs=1e-5)
