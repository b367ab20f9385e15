"""Port RNNoise parser and network (openhush_tpu_torch.ops.rnnoise_model)
against the JAX package's openhush_tpu/ops/rnnoise_model.py, on model text
files written here (nothing is downloaded) and the same numpy features.

Two model files: the one tests/test_aux_convert.py writes (integer weights
up to ±127, i.e. ±0.5 after the x256 scale), whose GRUs are chaotic: fp32
rounding noise doubles every frame (measured: 1e-6 at frame 0, 2e-5 at
frame 5, 0.1 by frame 17), so it is held over 6 frames, within 1e-4, as the
JAX test holds its own scan against its steps; and one with weights up to
±20 (±0.08), a contractive network, held over 60 frames within 1e-5."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openhush_tpu.ops import rnnoise_model as jrn
from openhush_tpu_torch.ops import rnnoise_model as rn

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_aux_convert as aux  # noqa: E402  (its model-file writer)


def _small_text(seed: int, limit: int = 20) -> str:
    """A model file in the same format with weights in [-limit, limit]."""
    rng = np.random.default_rng(seed)

    def ints(n):
        return " ".join(map(str, rng.integers(-limit, limit + 1, size=n)))

    def dense(m, n, act):
        return f"{m} {n} {ints(m * n)} {ints(n)} {act}"

    def gru(m, n, act):
        return f"{m} {n} {ints(m * 3 * n)} {ints(n * 3 * n)} {ints(3 * n)} {act}"

    x, d, v, nz, dn, g = 42, 24, 24, 48, 96, 22
    return "\n".join(["rnnoise-nu model file version 1", dense(x, d, 0),
                      gru(d, v, 0), gru(d + v + x, nz, 2),
                      gru(v + nz + x, dn, 2), dense(dn, g, 1),
                      dense(v, 1, 1)])


MODELS = {
    "aux-text": (lambda: aux._build_model_text(np.random.default_rng(11))[0],
                 6, 1e-4),
    "small-weights": (lambda: _small_text(12), 60, 1e-5),
}


@pytest.fixture(params=list(MODELS))
def model(request):
    make, frames, tol = MODELS[request.param]
    text = make()
    return text, frames, tol


def _feats(frames: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((frames, 42)).astype(
        np.float32)


def test_parse_equals_jax(model):
    text, _, _ = model
    ours, ref = rn.parse_model_file(text, device="cpu"), jrn.parse_model_file(text)
    assert ours.keys() == ref.keys()
    for layer in ref:
        assert ours[layer].keys() == ref[layer].keys()
        for k, v in ref[layer].items():
            if k == "act":
                assert type(ours[layer][k]) is int and ours[layer][k] == v
            else:
                np.testing.assert_array_equal(ours[layer][k].numpy(),
                                              np.asarray(v))


def test_rnn_step_matches_jax(model):
    text, frames, tol = model
    params, jparams = rn.parse_model_file(text, device="cpu"), \
        jrn.parse_model_file(text)
    state, jstate = rn.init_rnn_state(params), jrn.init_rnn_state(jparams)
    for f in _feats(frames, 1):
        state, gains, v = rn.rnn_step(params, state, torch.from_numpy(f))
        jstate, jgains, jv = jrn.rnn_step(jparams, jstate, f)
        np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), atol=tol)
        assert float(v) == pytest.approx(float(jv), abs=tol)
        for a, b in zip(state, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=tol)


def test_rnn_sequence_matches_jax_steps(model):
    """The eager loop against the JAX steps (the JAX scan itself parts from
    its steps by 5e-3 on the chaotic file; tests/test_aux_convert.py)."""
    text, frames, tol = model
    params, jparams = rn.parse_model_file(text, device="cpu"), \
        jrn.parse_model_file(text)
    feats = _feats(frames, 2)
    state, gains, vad = rn.rnn_sequence(params, rn.init_rnn_state(params),
                                        torch.from_numpy(feats))
    jstate = jrn.init_rnn_state(jparams)
    jg, jv = [], []
    for f in feats:
        jstate, g, v = jrn.rnn_step(jparams, jstate, f)
        jg.append(np.asarray(g))
        jv.append(float(v))
    assert tuple(gains.shape) == (frames, 22) and tuple(vad.shape) == (frames,)
    np.testing.assert_allclose(gains.numpy(), np.stack(jg), atol=tol)
    np.testing.assert_allclose(vad.numpy(), jv, atol=tol)
    np.testing.assert_allclose(state.denoise.numpy(),
                               np.asarray(jstate.denoise), atol=tol, rtol=tol)


def test_load_and_npz_round_trip(tmp_path):
    text = _small_text(13)
    path = tmp_path / "model.rnnn"
    path.write_text(text)
    params = rn.load(str(path), device="cpu")
    npz = str(tmp_path / "model.npz")
    rn.save_npz(params, npz)
    again = rn.load_npz(npz, device="cpu")
    jagain = jrn.load_npz(npz)                    # the JAX package reads it
    for layer, p in params.items():
        for k, v in p.items():
            if k == "act":
                assert again[layer][k] == v == jagain[layer][k]
            else:
                torch.testing.assert_close(again[layer][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("text,match", [
    ("not a model\n1 2 3", "not an RNNoise model file"),
    ("rnnoise-nu model file version 2\n", "unsupported"),
    ("rnnoise-nu model file version 1\n42 24 1 2 3", "truncated"),
])
def test_parse_rejects_bad_files(text, match):
    with pytest.raises(ValueError, match=match):
        rn.parse_model_file(text, device="cpu")
