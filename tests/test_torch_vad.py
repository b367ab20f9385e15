"""Port VAD engines and segmenter (openhush_tpu_torch.models.vad) and Silero
(openhush_tpu_torch.models.silero) against the JAX package's
openhush_tpu/models/vad.py and openhush_tpu/models/silero.py, on the same
numpy audio and the same carried weights (the JAX init_params outputs).

Tolerances: speech probabilities within 1e-6 (fp32 matmuls and
convolutions summed in another order; the port's convolutions are fp32
matmuls, as JAX's run at Precision.HIGHEST); Silero against the TorchScript
replica within 2e-5, the bound tests/test_aux_convert.py holds the JAX
model to; converted arrays and VadState segments exact (on the engines'
probabilities: segment bounds exact, averages within 1e-6)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from openhush_tpu.models import silero as jsilero
from openhush_tpu.models import vad as jvad
from openhush_tpu_torch.models import silero, vad
from openhush_tpu_torch.models.whisper.weights import from_numpy_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_aux_convert as aux  # noqa: E402  (its SileroReplica)

TOL = 1e-6


def _stream(n_chunks: int, seed: int, size: int = vad.CHUNK_SIZE):
    """Chunks of speech-like bursts and near silence, some of them short
    (the engines zero-pad)."""
    rng = np.random.default_rng(seed)
    t = np.arange(size) / 16000
    out = []
    for i in range(n_chunks):
        loud = (i // 6) % 2 == 1
        x = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) if loud else 0.0) \
            + (0.02 if loud else 0.001) * rng.standard_normal(size)
        out.append(x[: size - 100 if i % 7 == 3 else size].astype(np.float32))
    return out


def _run(engine, chunks):
    return [engine.process(c).probability for c in chunks]


def test_energy_vad_stream_matches_jax():
    chunks = _stream(40, 1)
    ours = _run(vad.VadEngine(kind="energy", device="cpu"), chunks)
    ref = _run(jvad.VadEngine(kind="energy"), chunks)
    np.testing.assert_allclose(ours, ref, atol=TOL)
    assert min(ours) < 0.1 and max(ours) > 0.9


@pytest.mark.parametrize("seed", [0, 3])
def test_gru_vad_stream_matches_jax(seed):
    jparams = jvad.gru_vad_init_params(jax.random.PRNGKey(seed))
    engine = vad.VadEngine(kind="gru", device="cpu",
                           params=from_numpy_params(jparams, device="cpu"))
    chunks = _stream(30, 2)
    np.testing.assert_allclose(_run(engine, chunks),
                               _run(jvad.VadEngine(kind="gru",
                                                   params=jparams), chunks),
                               atol=TOL)
    engine.reset()
    np.testing.assert_allclose(_run(engine, chunks[:3]),
                               _run(jvad.VadEngine(kind="gru",
                                                   params=jparams),
                                    chunks[:3]), atol=TOL)


def _segments(mod, probs, threshold, config):
    """The segments `mod`'s VadState emits over a stream of probabilities."""
    st = mod.VadState(config)
    segs = []
    for p in probs:
        seg = st.update(mod.VadResult(p, p >= threshold), vad.CHUNK_SIZE)
        if seg is not None:
            segs.append((seg.start, seg.end, seg.avg_probability))
    return segs


@pytest.mark.parametrize("min_silence_ms,min_speech_ms", [(700, 250),
                                                          (100, 30),
                                                          (300, 900)])
def test_vad_state_segments_exact(min_silence_ms, min_speech_ms):
    rng = np.random.default_rng(min_silence_ms)
    # Runs of speech and silence of random lengths.
    probs = []
    for i in range(60):
        hi = i % 2 == 0
        probs += list(rng.uniform(0.6, 1.0) if hi else rng.uniform(0.0, 0.4)
                      for _ in range(int(rng.integers(1, 40))))
    ours = _segments(vad, probs, 0.5, vad.VadStateConfig(
        min_silence_ms=min_silence_ms, min_speech_ms=min_speech_ms))
    ref = _segments(jvad, probs, 0.5, jvad.VadStateConfig(
        min_silence_ms=min_silence_ms, min_speech_ms=min_speech_ms))
    assert ours == ref and len(ours) > 0


def test_engine_into_vad_state_segments_exact():
    """The energy engine's stream through both segmenters: the segments'
    bounds exact, their average probabilities within the engines'
    tolerance."""
    chunks = _stream(60, 4)
    cfgs = (vad.VadStateConfig(min_silence_ms=150, min_speech_ms=60),
            jvad.VadStateConfig(min_silence_ms=150, min_speech_ms=60))
    ours = _run(vad.VadEngine(kind="energy", device="cpu"), chunks)
    ref = _run(jvad.VadEngine(kind="energy"), chunks)
    assert min(abs(p - 0.5) for p in ref) > 100 * TOL
    segs = _segments(vad, ours, 0.5, cfgs[0])
    want = _segments(jvad, ref, 0.5, cfgs[1])
    assert [s[:2] for s in segs] == [s[:2] for s in want] and len(segs) > 0
    np.testing.assert_allclose([s[2] for s in segs], [s[2] for s in want],
                               atol=TOL)


class _Cfg:
    def __init__(self, engine, model_path="", threshold=0.4):
        self.engine, self.model_path, self.threshold = (engine, model_path,
                                                        threshold)


def test_create_engine_gru_npz(tmp_path):
    from openhush_tpu.models.whisper.convert import save_npz
    jparams = jvad.gru_vad_init_params(jax.random.PRNGKey(5))
    path = str(tmp_path / "gru.npz")
    save_npz(jparams, path)
    ours = vad.create_engine(_Cfg("gru", path), device="cpu")
    ref = jvad.create_engine(_Cfg("gru", path))
    assert ours.kind == "gru" and ours.threshold == 0.4
    chunks = _stream(12, 5)
    np.testing.assert_allclose(_run(ours, chunks), _run(ref, chunks),
                               atol=TOL)


@pytest.mark.parametrize("pad_mode", jsilero.PAD_MODES)
def test_create_engine_silero_npz(tmp_path, pad_mode):
    jparams = jsilero.init_params(jax.random.PRNGKey(6))
    path = str(tmp_path / "silero.npz")
    jsilero.save_npz(jparams, path, pad_mode=pad_mode)
    ours = vad.create_engine(_Cfg("silero", path), device="cpu")
    ref = jvad.create_engine(_Cfg("silero", path))
    assert isinstance(ours, silero.SileroVad) and ours.pad_mode == pad_mode
    chunks = _stream(8, 6)
    np.testing.assert_allclose(_run(ours, chunks), _run(ref, chunks),
                               atol=TOL)


@pytest.mark.parametrize("engine,name,content", [
    ("silero", "missing.npz", None),
    ("silero", "broken.npz", b"not a zip file at all"),
    ("gru", "broken.npz", b"PK\x03\x04 truncated"),
    ("silero", "", None),
])
def test_create_engine_falls_back_to_energy_on_a_bad_file(tmp_path, engine,
                                                          name, content):
    path = str(tmp_path / name) if name else ""
    if content is not None:
        Path(path).write_bytes(content)
    ours = vad.create_engine(_Cfg(engine, path), device="cpu")
    assert isinstance(ours, vad.VadEngine) and ours.kind == "energy"
    assert isinstance(jvad.create_engine(_Cfg(engine, path)), jvad.VadEngine)


def test_create_engine_onnx_raises_and_is_not_swallowed(tmp_path):
    path = tmp_path / "silero_vad.onnx"
    path.write_bytes(b"\x08\x07")
    with pytest.raises(NotImplementedError, match="A8"):
        vad.create_engine(_Cfg("silero", str(path)), device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        vad.OnnxSileroVad(str(path))


@pytest.mark.parametrize("pad_mode", jsilero.PAD_MODES)
def test_silero_forward_chunk_matches_jax(pad_mode):
    """20 chunks with the state carried, in each STFT pad mode."""
    jparams = jsilero.init_params(jax.random.PRNGKey(7))
    params = from_numpy_params(jparams, device="cpu")
    state, jstate = silero.init_state(device="cpu"), jsilero.init_state()
    rng = np.random.default_rng(8)
    for i in range(20):
        chunk = (rng.standard_normal(silero.CHUNK) * (0.3 if i % 4 else 0.01)
                 ).astype(np.float32)
        state, prob = silero.forward_chunk(params, state,
                                           torch.from_numpy(chunk), pad_mode)
        jstate, jprob = jsilero.forward_chunk(jparams, jstate, chunk,
                                              pad_mode)
        assert float(prob) == pytest.approx(float(jprob), abs=TOL)
        for a, b in zip(state, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_silero_init_params_shapes_and_basis():
    ours = silero.init_params(torch.Generator().manual_seed(0), device="cpu")
    ref = jsilero.init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["stft_basis"].numpy(),
                                  np.asarray(ref["stft_basis"]))


def test_silero_convert_jit_matches_jax_converter(tmp_path):
    torch.manual_seed(3)
    replica = aux.SileroReplica().eval()
    path = str(tmp_path / "silero_vad.jit")
    torch.jit.save(torch.jit.script(replica), path)
    ours, ref = silero.convert_jit(path), jsilero.convert_jit(path)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))
    # The converted model tracks the replica chunk by chunk.
    params = from_numpy_params(ours, device="cpu")
    state = silero.init_state(device="cpu")
    h = c = torch.zeros(1, 128)
    ctx = torch.zeros(1, 64)
    rng = np.random.default_rng(9)
    for _ in range(5):
        chunk = rng.standard_normal(silero.CHUNK).astype(np.float32) * 0.1
        with torch.no_grad():
            want, h, c, ctx = replica(torch.from_numpy(chunk)[None], h, c, ctx)
        state, prob = silero.forward_chunk(params, state,
                                           torch.from_numpy(chunk))
        assert float(prob) == pytest.approx(float(want[0]), abs=2e-5)


def test_silero_convert_rejects_bad_state_dicts():
    sd = {k: torch.zeros(*s) for k, (_, s) in silero._JIT_NAME_MAP.items()}
    sd["_model.decoder.rnn.weight_ih"] = torch.zeros(512, 64)
    with pytest.raises(ValueError, match="weight_ih"):
        silero.convert_state_dict(sd)
    with pytest.raises(ValueError, match="missing expected"):
        silero.convert_state_dict({})


def test_silero_npz_round_trip(tmp_path):
    params = silero.init_params(torch.Generator().manual_seed(1), device="cpu")
    path = str(tmp_path / "s.npz")
    silero.save_npz(params, path, pad_mode="both")
    loaded = silero.SileroVad.load(path, device="cpu")
    assert loaded.pad_mode == "both"
    for k, v in params.items():
        torch.testing.assert_close(loaded.params[k], v, rtol=0, atol=0)
    # The JAX package reads the port's file too.
    jparams, jmode = jsilero.load_npz(path)
    assert jmode == "both" and jparams.keys() == params.keys()
