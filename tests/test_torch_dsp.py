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


# ---------------------------------------------------------------------------
# The segment plan of csrc/dsp.cu's oh_envelope and oh_limiter_gain, modelled
# in numpy float32 (every product and sum rounded on its own, as the kernels
# round them) and held bit for bit to the plain loops. The kernels' SEG (512)
# and warm-up (8 and 16 segments) are cut here to L = 64 and 4 and 8
# segments, so that met segments, runs and the carry's walks all show on a
# few thousand samples; "fast" coefficients shrink the time constants by
# the same factor. The model's carry takes the segments one at a time; the
# kernel's warp takes 32 at once and stops at the first whose rule fails,
# which gives the same starts.
# ---------------------------------------------------------------------------

F32 = np.float32
SEG_MODEL = 64


def _u(v):
    return np.asarray(v, F32).view(np.uint32)


class _Limiter:
    """g = x < g ? x : rc*g + (1-rc)*x from 1; its hulls m <= step <= M."""
    warm, init = 4, F32(1.0)

    def __init__(self, rc):
        self.rc = F32(rc)
        self.c = F32(1) - self.rc
        self.summarizable = self.rc > 0

    def step(self, g, x):
        return np.where(x < g, x, self.rc * g + self.c * x).astype(F32)

    def low(self, g, x):
        return np.minimum(x, self.rc * g + self.c * x).astype(F32)

    def high(self, g, x):
        """x < g ? max(x, r(x)) : r(g), r the release branch."""
        xp = np.maximum(x, self.rc * x + self.c * x)
        return np.where(x < g, xp, self.rc * g + self.c * x).astype(F32)

    def starts(self, x, windows):
        return (np.zeros(len(windows), F32),
                np.full(len(windows), np.inf, F32))

    def plain(self, x):
        return dsp.limiter_gain_plain(_t(x), float(self.rc)).numpy()


class _Envelope:
    """e = x > e ? att*e + (1-att)*x : rel*e + (1-rel)*x from 0; its hulls."""
    warm, init = 8, F32(0.0)

    def __init__(self, att, rel):
        self.att, self.rel = F32(att), F32(rel)
        self.ca, self.cr = F32(1) - self.att, F32(1) - self.rel
        self.summarizable = self.att > 0 and self.rel > 0

    def step(self, e, x):
        return np.where(x > e, self.att * e + self.ca * x,
                        self.rel * e + self.cr * x).astype(F32)

    def low(self, e, x):
        down_x = self.rel * x + self.cr * x
        return np.where(x > e, np.minimum(self.att * e + self.ca * x, down_x),
                        self.rel * e + self.cr * x).astype(F32)

    def high(self, e, x):
        xm = np.where(x > 0, (_u(x) - np.uint32(1)).view(F32), x)
        up_xm = self.att * xm + self.ca * x
        return np.where(x > e, self.att * e + self.ca * x,
                        np.maximum(self.rel * e + self.cr * x, up_xm)
                        ).astype(F32)

    def starts(self, x, windows):
        return (np.zeros(len(windows), F32),
                np.array([x[a:b].max() for a, b in windows], F32))

    def plain(self, x):
        return dsp.follow_envelope_plain(_t(x), float(self.att),
                                         float(self.rel)).numpy()


def segment_plan(op, x, L=SEG_MODEL, stats=None):
    """The kernels' three passes on one signal x [n]: summaries (the low
    and high hull walks over each segment's window), the carry, the
    outputs."""
    x = np.asarray(x, F32)
    n, w = len(x), op.warm
    ns = -(-n // L)
    k = np.arange(ns)
    p = np.maximum(k - w, 0) * L                  # the windows' starts
    end = np.minimum((k + 1) * L, n)
    lo0, hi0 = op.starts(x, list(zip(p, end)))
    lo0 = np.where(k < w, op.init, lo0).astype(F32)
    hi0 = np.where(k < w, op.init, hi0).astype(F32)
    lo, hi = lo0.copy(), hi0.copy()
    for j in range((w + 1) * L):                  # 1. summaries
        idx = p + j
        act = idx < end
        xv = x[np.minimum(idx, n - 1)]
        lo = np.where(act, op.low(lo, xv), lo).astype(F32)
        hi = np.where(act, op.high(hi, xv), hi).astype(F32)
    # A met end counts where the hulls hold: positive coefficients, and
    # every sample of the window finite.
    finite = np.array([np.isfinite(x[a:b]).all() for a, b in zip(p, end)])
    met = (lo == hi) & (lo != 0) & finite & op.summarizable
    segs = [x[i * L:(i + 1) * L] for i in range(ns)]
    run = [bool(np.all(_u(s) == _u(s[0]))) for s in segs]
    S = np.empty(ns + 1, F32)                     # 2. the carry
    S[0] = op.init
    counts = {"met": 0, "run": 0, "walked": 0}
    for i in range(ns):
        at_window = S[max(i - w, 0)]
        if met[i] and lo0[i] <= at_window <= hi0[i]:
            S[i + 1] = lo[i]
            counts["met"] += 1
        elif run[i] and _u(op.step(S[i], segs[i][0])) == _u(S[i]):
            S[i + 1] = S[i]
            counts["run"] += 1
        else:
            s = S[i]
            for xv in segs[i]:
                s = op.step(s, xv)
            S[i + 1] = s
            counts["walked"] += 1
    out = np.empty(n, F32)                        # 3. outputs
    s = S[:ns].copy()
    for j in range(L):
        idx = k * L + j
        act = idx < n
        ii = np.minimum(idx, n - 1)
        s = np.where(act, op.step(s, x[ii]), s).astype(F32)
        out[ii[act]] = s[act]
    if stats is not None:
        stats.update(counts, segments=ns)
    return out


def _target_gains(x):
    ceiling = F32(10.0 ** (-1.0 / 20.0))
    ax = np.abs(x)
    return np.where(ax > ceiling, ceiling / np.maximum(ax, F32(1e-30)),
                    F32(1.0)).astype(F32)


def _speech(n, seed, level=4.0):
    """chip_smoke.py's speech-like audio: a gliding tone under a 3 Hz
    envelope plus noise, here at 4x so that the limiter engages."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.5 * t)
    x = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (level * (x + 0.05 * rng.standard_normal(n))).astype(F32)


def _plan_input(kind, n=4000):
    """(limiter target gains, envelope magnitudes), each [n] or [2, n]."""
    rng = np.random.default_rng(60)
    quiet = (0.02 * rng.standard_normal(n)).astype(F32)
    if kind == "speech":
        x = _speech(n, 61)
    elif kind == "peak-then-quiet":
        x = quiet.copy()
        x[100] = 1.5
    elif kind == "no-peak":
        x = quiet
    elif kind == "peak-at-edges":        # a segment's first and the last
        x = quiet.copy()
        x[[0, SEG_MODEL, 17 * SEG_MODEL, n - 1]] = [1.2, 1.6, 1.3, 2.0]
    elif kind == "sparse-peaks":         # one sample every few segments
        x = quiet.copy()
        x[np.arange(150, n, 5 * SEG_MODEL + 13)] = 1.4
    elif kind == "silence-after-speech":
        x = _speech(n, 62)
        x[n // 3:] = 0.0
    elif kind == "constant":
        return np.full(n, F32(0.7)), np.full(n, F32(0.3))
    elif kind == "tg-under-1":           # gains in (1 - 2.4e-5, 1)
        tg = np.ones(n, F32)
        tg[np.arange(7, n, 97)] = F32(1 - 3e-6)
        tg[np.arange(500, n, 733)] = F32(0.6)
        return tg, np.abs(_speech(n, 63, 1.0))
    elif kind == "n-under-L":
        x = _speech(SEG_MODEL - 5, 64)
    elif kind == "n-ragged":
        x = _speech(n + 37, 65)
    elif kind == "non-finite":         # +inf at a third, NaN at two thirds
        tg, a = _target_gains(_speech(n, 67)), np.abs(_speech(n, 68))
        for v in (tg, a):
            v[n // 3], v[2 * n // 3] = np.inf, np.nan
        return tg, a
    elif kind == "two-signals":
        x = np.stack([_speech(n, 66), quiet])
    return _target_gains(x), np.abs(x).astype(F32)


PLAN_INPUTS = ["speech", "peak-then-quiet", "no-peak", "peak-at-edges",
               "sparse-peaks", "silence-after-speech", "constant",
               "tg-under-1", "n-under-L", "n-ragged", "two-signals",
               "non-finite"]


def _ops(coeffs):
    ms = {"default": (50.0, 5.0, 50.0), "fast": (2.0, 0.25, 2.0)}[coeffs]
    rc, att, rel = (F32(dsp.smoothing_coeff(m)) for m in ms)
    return _Limiter(rc), _Envelope(att, rel)


@pytest.mark.parametrize("coeffs", ["default", "fast"])
@pytest.mark.parametrize("kind", PLAN_INPUTS)
def test_segment_plan_matches_the_plain_loops(kind, coeffs):
    """The float32 model of the kernels' plan equals limiter_gain_plain and
    follow_envelope_plain bit for bit, signal by signal."""
    limiter, envelope = _ops(coeffs)
    tg, a = _plan_input(kind)
    for op, x in ((limiter, tg), (envelope, a)):
        ref = op.plain(x)
        rows = x.reshape(-1, x.shape[-1])
        refs = ref.reshape(rows.shape)
        for row, want in zip(rows, refs):
            stats = {}
            got = segment_plan(op, row, stats=stats)
            np.testing.assert_array_equal(_u(got), _u(want))
            assert sum(stats[c] for c in ("met", "run", "walked")) == \
                stats["segments"]


def test_segment_plan_takes_its_shortcuts():
    """Where the plan's rules apply they do: on speech at 4x the carry walks
    at most two segments (the rest meet, or pass a run of 1.0 at a fixed
    point), a limiter that never engages passes its runs of 1.0 through
    (the first `warm` segments meet: their windows start at the exact
    initial state), and after one peak the limiter walks until it settles below
    1.0, then passes the runs after it."""
    limiter, envelope = _ops("fast")
    tg, a = _plan_input("speech")
    for op, x in ((limiter, tg), (envelope, a)):
        st = {}
        segment_plan(op, x, stats=st)
        assert st["met"] > st["segments"] // 2 and st["walked"] <= 2, st
    st = {}
    segment_plan(limiter, np.ones(4000, F32), stats=st)
    assert st["run"] == st["segments"] - limiter.warm, st   # the first meet
    tg, a = _plan_input("peak-then-quiet", n=12000)
    st = {}
    segment_plan(_ops("default")[0], tg, stats=st)
    assert st["run"] > 0 and st["walked"] > 0, st


def _ulp_near(rng, x, m):
    """States at and a few ulps around x, and far from it."""
    near = (_u(x) + rng.integers(-3, 4, m).astype(np.int64)).astype(
        np.uint32).view(F32)
    far = (x * rng.uniform(0, 2, m)).astype(F32)
    return np.where(rng.random(m) < 0.5, near, far).astype(F32)


@pytest.mark.parametrize("which", ["limiter", "envelope"])
def test_hulls_bracket_the_step_and_are_monotone(which):
    """With the default coefficients, over seeded random inputs and state
    pairs s1 <= s2 (half of them within a few ulps of the input, where the
    select switches): m(s) <= step(s) <= M(s), and m and M never decrease
    as the state grows, which is what the summary's sandwich needs. The
    step alone breaks monotony by an ulp at a few inputs (those where its
    two branches do not both round to the input): the hulls are there for
    them."""
    limiter, envelope = _ops("default")
    op = limiter if which == "limiter" else envelope
    rng = np.random.default_rng(70)
    m = 400_000
    x = np.where(rng.random(m) < 0.5, rng.uniform(0.05, 1.0, m),
                 np.exp(rng.uniform(-30, 3, m))).astype(F32)
    s1, s2 = _ulp_near(rng, x, m), _ulp_near(rng, x, m)
    s1, s2 = np.minimum(s1, s2), np.maximum(s1, s2)
    for s in (s1, s2):
        f = op.step(s, x)
        assert np.all(op.low(s, x) <= f) and np.all(f <= op.high(s, x))
    assert np.all(op.low(s1, x) <= op.low(s2, x))
    assert np.all(op.high(s1, x) <= op.high(s2, x))
    # Inputs where the step itself decreases by an ulp as the state crosses
    # the input (found by scanning the floats in [0.03, 0.04) and [0.5,
    # 0.51)): the hulls still bracket it there.
    bad = {"limiter": 0x3f0036b9, "envelope": 0x3d05cbc5}[which]
    xb = np.full(2, bad, np.uint32).view(F32)
    sb = (np.array([bad, bad + 1]) - (which == "envelope")).astype(
        np.uint32).view(F32)
    fb = op.step(sb, xb)
    assert fb[0] > fb[1]
    assert op.low(sb, xb)[0] <= fb[1] and fb[0] <= op.high(sb, xb)[1]
    broken = op.step(s1, x) > op.step(s2, x)
    if which == "limiter":
        at_x = limiter.rc * x + limiter.c * x
        assert np.all(at_x[broken] > x[broken])
    else:
        up = envelope.att * x + envelope.ca * x
        down = envelope.rel * x + envelope.cr * x
        assert np.all(up[broken] != down[broken])


def test_limiter_fixed_points_below_one():
    """At 50 ms release g = 1 - k*2^-24 is a fixed point of the step at
    tg = 1.0 for k = 0..400 and not at 401; from 0.5 the walk settles on
    k = 400 and stays there."""
    limiter = _ops("default")[0]
    g = (F32(1) - np.arange(402, dtype=F32) * F32(2.0 ** -24)).astype(F32)
    fixed = _u(limiter.step(g, np.ones_like(g))) == _u(g)
    assert fixed[:401].all() and not fixed[401]
    s, one, steps = F32(0.5), np.ones(1, F32), 0
    while _u(limiter.step(s, one))[0] != _u(s):
        s = limiter.step(s, one)[0]
        steps += 1
    assert s == F32(1) - F32(400 * 2.0 ** -24) and 7000 < steps < 9000


def test_envelope_contracts_and_settles_in_silence():
    """Walks of the envelope from 0 and from 1 over |noise|*0.1 meet within
    the kernel's 8192-sample warm-up; in digital silence any start settles
    on the denormal 400*2^-149, a fixed point, after ~77,000 steps."""
    envelope = _ops("default")[1]
    a = np.abs(0.1 * np.random.default_rng(71).standard_normal(8192)).astype(
        F32)
    s = np.array([0.0, 1.0], F32)
    for i, v in enumerate(a):
        s = envelope.step(s, np.full(2, v, F32))
        if s[0] == s[1]:
            break
    assert s[0] == s[1] and i < 8192
    e, zero, steps = np.full(1, F32(0.5)), np.zeros(1, F32), 0
    while _u(envelope.step(e, zero))[0] != _u(e)[0]:
        e = envelope.step(e, zero)
        steps += 1
    assert e[0] == F32(400 * 2.0 ** -149) and 70_000 < steps < 85_000
