"""Port audio DSP chain (openhush_tpu_torch.ops.dsp) against the JAX package's
openhush_tpu/ops/dsp.py, on the same numpy inputs. On the CPU the
recurrences' wrappers run their plain versions (loops over the samples in
torch ops), which the CUDA kernels of csrc/dsp.cu match bit for bit on the
card (chip_smoke.py phase 2).

Tolerance: atol 2e-5 on outputs of magnitude up to ~1, the bound
tests/test_native.py holds the reference's own host C++ copies to. The
recurrences are the reference's operations in its order; what differs is
the last bit of exp, log10 and pow (XLA's against PyTorch's) and XLA's
freedom to contract a multiply and an add."""

import numpy as np
import pytest
import torch

from openhush_tpu.ops import dsp as jdsp
from openhush_tpu_torch.ops import dsp

ATOL = 2e-5
N = 16000


def _audio(seed: int, n: int = N) -> np.ndarray:
    """Speech-like levels: a loud burst, a quiet stretch, a ramp."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    env = np.concatenate([np.full(n // 4, 0.9), np.full(n // 4, 0.02),
                          np.linspace(0.0, 1.4, n - n // 2)])
    return (x * env).astype(np.float32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(threshold_db=-30.0, ratio=2.0, attack_ms=1.0, release_ms=100.0,
         makeup_gain_db=6.0),
    dict(threshold_db=-12.0, ratio=8.0, attack_ms=10.0, release_ms=20.0,
         makeup_gain_db=-3.0),
    dict(threshold_db=-20.0, ratio=1.0),       # ratio <= 1: the identity
    dict(threshold_db=-20.0, ratio=0.5),
], ids=["default", "makeup", "hard", "ratio1", "ratio-half"])
def test_compress_matches_jax(kw):
    x = _audio(1)
    ours = dsp.compress(_t(x), **kw).numpy()
    ref = np.asarray(jdsp.compress(x, **kw))
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    if kw.get("ratio", 4.0) <= 1.0:
        np.testing.assert_array_equal(ours, x)


@pytest.mark.parametrize("ceiling_db,release_ms", [(-1.0, 50.0), (-6.0, 50.0),
                                                   (-12.0, 10.0)])
def test_limit_matches_jax(ceiling_db, release_ms):
    x = _audio(2)
    ours = dsp.limit(_t(x), ceiling_db, release_ms).numpy()
    ref = np.asarray(jdsp.limit(x, ceiling_db, release_ms))
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    assert np.abs(ours).max() <= 10 ** (ceiling_db / 20) + 1e-6


@pytest.mark.parametrize("kind", ["noise", "silence", "tiny"])
@pytest.mark.parametrize("target_db", [-20.0, -30.0])
def test_normalize_rms_matches_jax(kind, target_db):
    x = {"noise": _audio(3), "silence": np.zeros(N, np.float32),
         "tiny": _audio(3) * np.float32(1e-4)}[kind]
    ours = dsp.normalize_rms(_t(x), target_db).numpy()
    ref = np.asarray(jdsp.normalize_rms(x, target_db))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=1e-5)
    r_ours, r_ref = float(dsp.rms_db(_t(x))), float(jdsp.rms_db(x))
    if kind == "silence":
        assert r_ours == r_ref == float("-inf")
        np.testing.assert_array_equal(ours, x)
    else:
        assert r_ours == pytest.approx(r_ref, abs=1e-4)


@pytest.mark.parametrize("gain_db", [0.0, 6.0, -12.5])
def test_apply_gain_matches_jax(gain_db):
    x = _audio(4, 4000)
    np.testing.assert_allclose(dsp.apply_gain(_t(x), gain_db).numpy(),
                               np.asarray(jdsp.apply_gain(x, gain_db)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(compress_enabled=True),
    dict(normalize=False, compress_enabled=True, ratio=3.0, limiter=False),
    dict(target_db=-16.0, compress_enabled=True, makeup_gain_db=4.0,
         ceiling_db=-3.0, limiter_release_ms=30.0),
], ids=["default", "all", "compress-only", "all-tuned"])
def test_preprocess_chain_matches_jax(kw):
    x = _audio(5)
    ours = dsp.preprocess_chain(_t(x), **kw).numpy()
    ref = np.asarray(jdsp.preprocess_chain(x, **kw))
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_recurrences_over_lanes_match_one_lane_at_a_time():
    """The plain versions (and the kernels) take [..., n]: each signal of a
    batch is its own lane, as if it ran alone."""
    xs = np.stack([_audio(6, 3000), _audio(7, 3000)])
    a = torch.from_numpy(np.abs(xs))
    env = dsp.follow_envelope(a, 0.9, 0.999)
    gain = dsp.limiter_gain(torch.clamp(1.0 / a.clamp(min=1e-3), max=1.0),
                            0.99)
    for i in range(2):
        torch.testing.assert_close(env[i], dsp.follow_envelope(a[i], 0.9, 0.999),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            gain[i], dsp.limiter_gain(torch.clamp(1.0 / a[i].clamp(min=1e-3),
                                                  max=1.0), 0.99),
            rtol=0, atol=0)


def test_envelope_follows_the_reference_scan():
    """The envelope alone against the reference's _follow_envelope: within
    1e-5 of the value (a few ulps over 16000 steps; XLA may fuse a
    multiply and an add that the port rounds apart)."""
    a = np.abs(_audio(8))
    att = dsp.smoothing_coeff(5.0)
    rel = dsp.smoothing_coeff(50.0)
    assert att == pytest.approx(float(np.exp(np.float32(-1 / 80.0))), rel=1e-7)
    ours = dsp.follow_envelope(_t(a), att, rel).numpy()
    ref = np.asarray(jdsp._follow_envelope(a, np.float32(att), np.float32(rel)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
