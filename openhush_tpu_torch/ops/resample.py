"""Sample-rate conversion.

Host path: polyphase windowed-sinc (kaiser) resampling for arbitrary rational
ratios — the replacement for the reference's rubato sinc resampler
(src/input/audio.rs:904-1043, sinc_len 256 / BlackmanHarris2) with a linear
fallback for ratios that would need huge filters. A copy of
openhush_tpu/ops/resample.py (numpy only), so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import functools
import math

import numpy as np

try:  # scipy is baked into the image; used for fast host-side upfirdn.
    from scipy.signal import upfirdn as _upfirdn
except ImportError:  # pragma: no cover
    _upfirdn = None

HALF_TAPS = 128  # half-length of the sinc kernel per output sample (≈ rubato's 256 sinc_len)


@functools.lru_cache(maxsize=16)
def design_polyphase_filter(up: int, down: int, half_taps: int = HALF_TAPS,
                            beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for polyphase resampling by up/down.

    Cutoff at min(1/up, 1/down) of the upsampled Nyquist; gain `up` to
    compensate zero-stuffing. Returns taps of odd length centered at n=0.
    """
    cutoff = min(1.0 / up, 1.0 / down)
    n_taps = 2 * half_taps * up + 1
    n = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(n_taps, beta)
    h *= up / h.sum()  # unity DC gain after zero-stuffing by `up`
    return h.astype(np.float64)


def resample(x: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Resample 1-D float audio from rate_in to rate_out (host-side).

    Output length is ceil(len(x) * rate_out / rate_in), matching the usual
    polyphase convention.
    """
    if rate_in == rate_out or len(x) == 0:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(rate_in, rate_out)
    up, down = rate_out // g, rate_in // g
    if up > 1024:  # absurd ratio — fall back to linear interpolation
        return resample_linear(x, rate_in, rate_out)
    h = design_polyphase_filter(up, down)
    # Group delay is (n_taps-1)/2 at the upsampled rate; front-pad the filter
    # with zeros so the delay is a multiple of `down`, keeping the output grid
    # phase-aligned with the input (no fractional-sample shift).
    delay = (len(h) - 1) // 2
    pad = (-delay) % down
    if pad:
        h = np.concatenate([np.zeros(pad), h])
        delay += pad
    if _upfirdn is not None:
        y = _upfirdn(h, np.asarray(x, dtype=np.float64), up=up, down=down)
    else:  # pragma: no cover — slow pure-numpy path
        stuffed = np.zeros(len(x) * up, dtype=np.float64)
        stuffed[::up] = x
        y = np.convolve(stuffed, h)[::down]
    start = delay // down
    n_out = -(-len(x) * up // down)  # ceil
    y = y[start:start + n_out]
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y.astype(np.float32)


def resample_linear(x: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Linear-interpolation fallback (parity: resample_linear,
    src/input/audio.rs:920-938)."""
    if rate_in == rate_out or len(x) == 0:
        return np.asarray(x, dtype=np.float32)
    n_out = -(-len(x) * rate_out // rate_in)
    t = np.arange(n_out, dtype=np.float64) * rate_in / rate_out
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)
