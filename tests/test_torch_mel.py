"""Port log-mel frontend (openhush_tpu_torch.ops.frontend / mel) against the
JAX reference (ops/mel.log_mel_spectrogram) and the Pallas kernel in
interpret mode (ops/frontend_pallas.log_mel_pallas), as
tests/test_frontend_pallas.py runs them. On the CPU the port's wrapper runs
the kernel's plain version. Tolerance: atol 5e-5 on the normalized log-mel,
the JAX frontend tests' own bound (fp32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.ops import frontend_pallas as fp
from openhush_tpu.ops import mel as mel_ref
from openhush_tpu_torch.ops import frontend, mel

ATOL = 5e-5


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_reference_and_pallas(n_mels):
    rng = np.random.default_rng(0)
    audio = (0.2 * rng.standard_normal(mel_ref.N_SAMPLES)).astype(np.float32)
    ref = np.asarray(mel_ref.log_mel_spectrogram(jnp.asarray(audio),
                                                 n_mels=n_mels))
    pallas = np.asarray(fp.log_mel_pallas(jnp.asarray(audio), n_mels=n_mels,
                                          interpret=True))
    ours = frontend.log_mel(torch.from_numpy(audio)[None], n_mels=n_mels)
    assert ours.shape == (1, n_mels, 3000) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours[0].numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(ours[0].numpy(), pallas, atol=ATOL)


def test_short_window_and_per_row_max():
    """Non-default frame counts, and a batch whose rows differ in level:
    the clamp's max is taken per row, as the reference takes it per
    window (vmap over rows)."""
    n_frames = 448
    t = np.arange(n_frames * 160) / 16000
    tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    rows = np.stack([tone, 1e-3 * tone])
    ours = frontend.log_mel(torch.from_numpy(rows), n_frames=n_frames)
    for r in range(2):
        ref = np.asarray(mel_ref.log_mel_spectrogram(
            jnp.asarray(rows[r]), n_frames=n_frames))
        np.testing.assert_allclose(ours[r].numpy(), ref, atol=ATOL)


def test_bases_and_filterbank_are_the_references():
    for a, b in zip(mel._dft_bases(), mel_ref._dft_bases()):
        np.testing.assert_array_equal(a, b)
    for n in (80, 128):
        np.testing.assert_array_equal(mel.mel_filter_bank(n),
                                      mel_ref.mel_filter_bank(n))


def test_pad_or_trim():
    x = np.ones(10, np.float32)
    assert mel.pad_or_trim(x, 16).shape == (16,)
    assert mel.pad_or_trim(x, 4).shape == (4,)
    t = mel.pad_or_trim(torch.ones(2, 10), 16)
    assert t.shape == (2, 16) and float(t[:, 10:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        mel.pad_or_trim(x, 16), np.asarray(mel_ref.pad_or_trim(x, 16)))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_cover_the_filters(n_mels):
    """Each filter's nonzeros lie in its band [lo, hi], which starts and
    ends on a nonzero; the kernel gets lo and a weight row holding the
    band's values in order, then zeros; the banded sum equals the dense
    product."""
    fb = mel.mel_filter_bank(n_mels)
    bands = mel.mel_bands(n_mels)
    assert bands.shape == (n_mels, 2) and bands.dtype == np.int32
    for m, (lo, hi) in enumerate(bands):
        nz = np.flatnonzero(fb[:, m])
        assert nz.size and nz[0] == lo and nz[-1] == hi
        assert hi - lo < frontend.MAX_BAND
    _, weights, first = frontend._bases(n_mels, torch.device("cpu"))
    assert np.array_equal(first.numpy(), bands[:, 0])
    power = np.random.default_rng(1).random((64, fb.shape[0])).astype(
        np.float32) ** 4
    banded = np.zeros((64, n_mels), np.float32)
    for m, (lo, hi) in enumerate(bands):
        w = weights[m].numpy()
        np.testing.assert_array_equal(w[:hi - lo + 1], fb[lo:hi + 1, m])
        assert not w[hi - lo + 1:].any()
        for j in range(lo, hi + 1):
            banded[:, m] += power[:, j] * w[j - lo]
    np.testing.assert_allclose(banded, power @ fb, rtol=1e-6)


def _kernel_model(frames: np.ndarray, fold: bool):
    """float32 model of the kernel's DFT sums: one rounding a term (fmaf),
    in ascending n; folded, x[n] +- x[400-n] first (rounded) against the
    bases' rows 0..200."""
    cos_b, sin_b = mel._dft_bases()
    if fold:
        lo, hi = frames[:, 1:200], frames[:, 399:200:-1]
        xr = np.concatenate([frames[:, :1], lo + hi, frames[:, 200:201]], 1)
        xi = np.concatenate([frames[:, :1], lo - hi, frames[:, 200:201]], 1)
        cos_b, sin_b = cos_b[:201], sin_b[:201]
    else:
        xr = xi = frames
    re = np.zeros((frames.shape[0], cos_b.shape[1]), np.float32)
    im = np.zeros_like(re)
    for n in range(xr.shape[1]):
        re = (xr[:, n:n + 1].astype(np.float64) * cos_b[n] + re).astype(
            np.float32)
        im = (xi[:, n:n + 1].astype(np.float64) * sin_b[n] + im).astype(
            np.float32)
    return re, im


def test_folded_dft_model_holds_fp32_accuracy():
    """The kernel folds the DFT's symmetry: the windowed bases satisfy
    C[400-n] = C[n] and S[400-n] = -S[n] (as stored, to 2e-13). A float32
    model of the folded sums, on a tone over near silence where the low
    bins cancel, against float64 sums of the same fp32 bases:
    - each Re and Im within the worst-case bound of a 202-term fp32 sum,
      202 * 2**-24 * sum_n |x_n C_nk|, plus what the bases' own asymmetry
      contributes, sum_{n>200} |x_n| |C_nk -+ C_(400-n)k| (the dense
      400-term model within its bound, 400 * 2**-24 * ...);
    - the log10 mel energies within 2e-3 in every bin within 8 decades of
      its frame's peak, the card check's tolerance (chip_smoke.py)."""
    cos_b, sin_b = mel._dft_bases()
    assert np.abs(cos_b[1:200] - cos_b[399:200:-1]).max() < 2e-13
    assert np.abs(sin_b[1:200] + sin_b[399:200:-1]).max() < 2e-13
    t = np.arange(16000) / 16000
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x[8000:] = 1e-5 * np.random.default_rng(5).standard_normal(8000)
    n_frames = 100
    frames = mel.frame_signal(mel.reflect_pad(torch.from_numpy(x)[None]),
                              n_frames)[0].numpy()
    f64 = frames.astype(np.float64)
    re64, im64 = f64 @ cos_b.astype(np.float64), f64 @ sin_b.astype(np.float64)
    for fold, terms in ((True, 202), (False, 400)):
        re, im = _kernel_model(frames, fold)
        for got, ref, basis, sign in ((re, re64, cos_b, 1), (im, im64, sin_b,
                                                             -1)):
            b64 = basis.astype(np.float64)
            bound = terms * 2.0 ** -24 * (np.abs(f64) @ np.abs(b64))
            if fold:    # rows 201..399 taken as +-rows 199..1
                bound += np.abs(f64[:, 201:]) @ np.abs(
                    b64[201:] - sign * b64[199:0:-1])
            assert bool((np.abs(got - ref) <= bound).all())
    re, im = _kernel_model(frames, True)
    fb = mel.mel_filter_bank(128).astype(np.float64)
    ref = np.log10(np.maximum((re64 ** 2 + im64 ** 2) @ fb, 1e-10))
    power = (re * re + im * im).astype(np.float32)
    ours = np.log10(np.maximum((power @ mel.mel_filter_bank(128)), 1e-10))
    keep = ref > ref.max(axis=1, keepdims=True) - 8
    assert keep.mean() > 0.5
    assert np.abs(ours - ref)[keep].max() <= 2e-3
