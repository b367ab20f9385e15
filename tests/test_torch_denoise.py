"""Port denoiser (openhush_tpu_torch.ops.denoise) and the daemon's
per-window preprocess (openhush_tpu_torch.runtime.daemon.build_preprocess)
against the JAX package's openhush_tpu/ops/denoise.py and
openhush_tpu/runtime/daemon.py:build_preprocess, on the same numpy inputs
and the same carried weights. On the CPU the noise floor's wrapper runs its
plain version (a loop over frames in torch ops), which the CUDA kernel
matches bit for bit on the card (chip_smoke.py).

Tolerances: bases and bands exact (the same numpy code); gains and audio
within 1e-5 of values of magnitude up to ~1, spectra (values up to ~20)
within 1e-5 relative (fp32 matmuls summed in another order, and exp/log's
last bit); the noise floor (log energies of
magnitude up to ~25) within 1e-5 absolute; the preprocess within 2e-5, the
bound tests/test_native.py holds the reference's host DSP to (the JAX
preprocess takes that host C++ for compress and limit where it is built)."""

import jax
import numpy as np
import pytest
import torch

from openhush_tpu.ops import denoise as jdn
from openhush_tpu.runtime.daemon import build_preprocess as jax_build_preprocess
from openhush_tpu.utils.config import AudioConfig
from openhush_tpu_torch.models.whisper.weights import from_numpy_params
from openhush_tpu_torch.ops import denoise as dn
from openhush_tpu_torch.runtime.daemon import build_preprocess

ATOL = 1e-5


def _noisy(n: int, seed: int) -> np.ndarray:
    """A 440 Hz tone with bursts, over white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    tone = 0.4 * np.sin(2 * np.pi * 440 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _state_np(state):
    return [np.asarray(x) for x in state]


def _assert_state(ours, ref, atol=ATOL):
    for a, b in zip(ours, _state_np(ref)):
        np.testing.assert_allclose(a.cpu().numpy(), b, atol=atol)


def test_bases_and_bands_equal():
    np.testing.assert_array_equal(dn.bark_bands(), jdn.bark_bands())
    for a, b in zip(dn._synthesis_bases(), jdn._synthesis_bases()):
        np.testing.assert_array_equal(a, b)
    for n in (2, 7, 100):
        np.testing.assert_array_equal(dn._ola_norm(n), jdn._ola_norm(n))


@pytest.mark.parametrize("n_frames", [3, 50, 101])
def test_stft_and_round_trip(n_frames):
    x = _noisy(n_frames * dn.HOP + dn.N_FFT, 1)
    re, im = dn._stft(torch.from_numpy(x), n_frames)
    jre, jim = jdn._stft(jax.numpy.asarray(x), n_frames)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=1e-5,
                               atol=ATOL)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=1e-5,
                               atol=ATOL)
    n = n_frames * dn.HOP + dn.N_FFT
    ours = dn._istft(re, im, n).numpy()
    ref = np.asarray(jdn._istft(jre, jim, n))
    # The overlap-add before the COLA division; after it, within 1e-5 where
    # the window weight is at least 1e-2 (the first and last samples divide
    # by squared-window sums down to 1e-6, which magnifies the matmuls'
    # rounding there; denoise cuts those samples off with its padding).
    norm = dn._ola_norm(n_frames)
    np.testing.assert_allclose(ours * norm, ref * norm, atol=ATOL)
    keep = norm >= 1e-2
    np.testing.assert_allclose(ours[keep], ref[keep], atol=ATOL)
    # Every sample that a whole frame covers comes back.
    lo, hi = dn.N_FFT, (n_frames - 1) * dn.HOP
    if hi > lo:
        np.testing.assert_allclose(ours[lo:hi], x[lo:hi], atol=1e-5)


def _band_energy(seed: int, n_frames: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    level = np.exp(rng.uniform(-8, 2, (n_frames, 1)))
    return (level * rng.uniform(0.1, 1.0, (n_frames, dn.N_BANDS))
            ).astype(np.float32)


def test_wiener_gains_carry_state_over_two_calls():
    state, jstate = dn.init_state("cpu"), jdn.init_state()
    for seed, n_frames in ((1, 40), (2, 25)):
        e = _band_energy(seed, n_frames)
        gains, state = dn.wiener_gains(torch.from_numpy(e), state)
        jgains, jstate = jdn.wiener_gains(jax.numpy.asarray(e), jstate)
        np.testing.assert_allclose(gains.numpy(), np.asarray(jgains),
                                   atol=ATOL)
        _assert_state(state, jstate)
        assert bool(state.initialized)


def test_noise_floor_plain_is_the_reference_step():
    """The floor alone: its plain version against the reference step
    written out in numpy float32."""
    le = np.log(_band_energy(3, 30) + np.float32(1e-10))
    floor = le[0].copy()
    want = []
    for row in le:
        rate = np.where(row < floor, np.float32(0.3), np.float32(0.003))
        floor = (floor + rate * (row - floor)).astype(np.float32)
        want.append(floor)
    ours = dn.noise_floor(torch.from_numpy(le), torch.from_numpy(le[0]))
    np.testing.assert_array_equal(ours.numpy(), np.stack(want))


def test_rnn_gains_match_jax():
    jparams = jdn.init_rnn_params(jax.random.PRNGKey(4))
    params = from_numpy_params(jparams, device="cpu")
    state, jstate = dn.init_state("cpu"), jdn.init_state()
    for seed in (5, 6):
        e = _band_energy(seed, 30)
        gains, state, vad = dn.rnn_gains(params, torch.from_numpy(e), state)
        jgains, jstate, jvad = jdn.rnn_gains(jparams, jax.numpy.asarray(e),
                                             jstate)
        np.testing.assert_allclose(gains.numpy(), np.asarray(jgains),
                                   atol=ATOL)
        np.testing.assert_allclose(vad.numpy(), np.asarray(jvad), atol=ATOL)
        _assert_state(state, jstate)


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n", [8000 + 77, 9 * 160, 399, 400])
def test_denoise_matches_jax(strength, n):
    """Two consecutive calls with the state carried: a length that is not a
    multiple of the hop (the tail passes through), one that is, one under
    a frame (returned as it is) and exactly one frame."""
    state = jstate = None
    for seed in (7, 8):
        x = _noisy(n, seed)
        ours, state = dn.denoise(x, strength, state, device="cpu")
        ref, jstate = jdn.denoise(x, strength, jstate)
        assert ours.dtype == np.float32 and ours.shape == x.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL)
        _assert_state(state, jstate)
        if strength == 0.0 or n < dn.N_FFT:
            np.testing.assert_array_equal(ours, x)
        else:
            tail = n % dn.HOP
            if tail:
                np.testing.assert_array_equal(ours[-tail:], x[-tail:])


def test_denoise_with_rnn_params_matches_jax():
    jparams = jdn.init_rnn_params(jax.random.PRNGKey(9))
    params = from_numpy_params(jparams, device="cpu")
    x = _noisy(8000, 10)
    ours, state = dn.denoise(x, 1.0, params=params, device="cpu")
    ref, jstate = jdn.denoise(x, 1.0, params=jparams)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    _assert_state(state, jstate)


def test_early_return_gives_a_fresh_state():
    x = _noisy(300, 11)
    ours, state = dn.denoise(x, 1.0, device="cpu")
    np.testing.assert_array_equal(ours, x)
    _assert_state(state, jdn.init_state(), atol=0)
    assert state.noise_floor.device.type == "cpu"


ALL_ON = dict(noise_reduction_enabled=True, noise_reduction_strength=0.8,
              compression_enabled=True, compression_threshold_db=-24.0,
              compression_makeup_gain_db=2.0, limiter_ceiling_db=-3.0)


@pytest.mark.parametrize("cfg", [AudioConfig(), AudioConfig(**ALL_ON)],
                         ids=["default", "all-stages"])
def test_build_preprocess_matches_jax_over_two_calls(cfg):
    ours, ref = build_preprocess(cfg, device="cpu"), jax_build_preprocess(cfg)
    for n, seed in ((16000 + 33, 12), (12000, 13)):
        x = _noisy(n, seed)
        y = ours(x)
        assert isinstance(y, np.ndarray) and y.dtype == np.float32
        np.testing.assert_allclose(y, ref(x), atol=2e-5)


def test_build_preprocess_takes_any_config_object():
    """Any object with AudioConfig's attribute names will do."""
    class Cfg:
        noise_reduction_enabled = False
        normalization_enabled = True
        normalization_target_db = -18.0
        compression_enabled = False
        limiter_enabled = False
    x = _noisy(4000, 14)
    y = build_preprocess(Cfg(), device="cpu")(x)
    rms = float(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
    assert 20 * np.log10(rms) == pytest.approx(-18.0, abs=1e-3)
