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
