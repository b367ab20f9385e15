"""Audio DSP chain: RMS measure/normalize, compressor, limiter.

Counterpart of openhush_tpu/ops/dsp.py (behavioural parity with the
reference's AudioBuffer DSP methods, src/input/audio.rs:56-341). The two
first-order recurrences, the compressor's envelope follower and the
limiter's gain, run on hand-written CUDA kernels (csrc/dsp.cu) for CUDA
tensors: in eager PyTorch a 30 s window would cost a few kernel launches
for each of its 480,000 samples. The kernels walk 512-sample segments in
parallel and give each its exact start (the file's header says how); the
one-thread serial walk stays callable (`*_serial`) as the card's bit
reference. Everything elementwise around them stays in PyTorch. Each
recurrence has its plain version here, a loop over the samples in torch
ops (the reference's lax.scan step), which CPU tensors take; the kernels
give its bits.

Scalars follow the reference's rounding: the attack and release
coefficients are exp of an fp32 value, computed once on the CPU; the
threshold and ceiling are Python floats rounded to fp32 where they are
used; every division by one is an IEEE divide on every device (on a CUDA
tensor, `x / 20.0` would multiply by a rounded 1/20).
"""

from __future__ import annotations

import torch

from openhush_tpu_torch.ops import _build

SAMPLE_RATE = 16_000


def fp32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded to fp32, as a 0-d tensor on `like`'s device (an
    operand, never a host scalar that PyTorch may fold differently)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / fp32_scalar(d, x)


def smoothing_coeff(ms: float, sample_rate: int = SAMPLE_RATE) -> float:
    """exp(-1 / (ms * rate / 1000)): the argument in double, rounded to
    fp32, its exp in fp32, as jnp.exp of a Python float computes it."""
    arg = torch.tensor(-1.0 / (ms * sample_rate / 1000.0), dtype=torch.float32)
    return float(torch.exp(arg))


def rms_db(x: torch.Tensor) -> torch.Tensor:
    """20*log10(rms); -inf for silence. Parity: src/input/audio.rs:86-101."""
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms > 0.0, 20.0 * torch.log10(torch.clamp(rms, min=1e-30)),
                       fp32_scalar(-float("inf"), x))


def apply_gain(x: torch.Tensor, gain_db) -> torch.Tensor:
    gain_db = torch.as_tensor(gain_db, dtype=torch.float32, device=x.device)
    return x * torch.pow(10.0, _div(gain_db, 20.0))


def normalize_rms(x: torch.Tensor, target_db: float = -20.0) -> torch.Tensor:
    """Gain to reach target RMS; no-op on silence.
    Parity: src/input/audio.rs:103-119."""
    current = rms_db(x)
    gain_db = torch.where(torch.isfinite(current), target_db - current,
                          fp32_scalar(0.0, x))
    return apply_gain(x, gain_db)


# ---------------------------------------------------------------------------
# The two recurrences: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def follow_envelope_plain(a: torch.Tensor, attack: float,
                          release: float) -> torch.Tensor:
    """a = |x| [..., n] fp32 → the envelope [..., n]: from 0, coeff =
    attack where a > env else release, env = coeff*env + (1-coeff)*a."""
    att, rel = fp32_scalar(attack, a), fp32_scalar(release, a)
    env = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    out = []
    for at in a.unbind(-1):
        c = torch.where(at > env, att, rel)
        env = c * env + (1.0 - c) * at
        out.append(env)
    return torch.stack(out, dim=-1) if out else torch.empty_like(a)


def limiter_gain_plain(tg: torch.Tensor, rc: float) -> torch.Tensor:
    """tg, target gains [..., n] fp32 → the gains [..., n]: from 1,
    g = tg where tg < g else rc*g + (1-rc)*tg."""
    rc_t = fp32_scalar(rc, tg)
    g = torch.ones(tg.shape[:-1], dtype=torch.float32, device=tg.device)
    out = []
    for tt in tg.unbind(-1):
        g = torch.where(tt < g, tt, rc_t * g + (1.0 - rc_t) * tt)
        out.append(g)
    return torch.stack(out, dim=-1) if out else torch.empty_like(tg)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA fp32 tensor (the kernels of
    csrc/dsp.cu take nothing else)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.dtype}; the kernel takes fp32")


def _lanes(a: torch.Tensor) -> int:
    n_sig = a.numel() // a.shape[-1]
    if n_sig >= 2 ** 31:
        raise ValueError(f"{n_sig} signals; the kernel takes fewer than 2**31")
    return n_sig


def _launch(name: str, x: torch.Tensor, *coeffs: float,
            serial: bool = False) -> torch.Tensor:
    """Launch csrc/dsp.cu's `name` (or its serial walk) on CUDA fp32
    [..., n] `x`; the segment kernels get their scratch here."""
    check_cuda(name, x)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    n, n_sig = x.shape[-1], _lanes(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if serial:
        err = getattr(lib, name + "_serial")(x.data_ptr(), out.data_ptr(), n,
                                             n_sig, *coeffs, stream)
    else:
        scratch = torch.empty(lib.oh_dsp_scratch_floats(n, n_sig),
                              dtype=torch.float32, device=x.device)
        err = getattr(lib, name)(x.data_ptr(), out.data_ptr(), n, n_sig,
                                 *coeffs, scratch.data_ptr(), stream)
    _build.check(err, name + ("_serial" if serial else ""))
    return out


def follow_envelope(a: torch.Tensor, attack: float,
                    release: float) -> torch.Tensor:
    """The envelope follower of [..., n] fp32 magnitudes. CPU tensors take
    the plain version; CUDA tensors launch csrc/dsp.cu:oh_envelope."""
    if a.device.type == "cpu":
        return follow_envelope_plain(a, attack, release)
    out = _launch("oh_envelope", a, attack, release)
    follow_envelope.launches += 1
    return out


follow_envelope.launches = 0


def limiter_gain(tg: torch.Tensor, rc: float) -> torch.Tensor:
    """The limiter's gains over [..., n] fp32 target gains. CPU tensors take
    the plain version; CUDA tensors launch csrc/dsp.cu:oh_limiter_gain."""
    if tg.device.type == "cpu":
        return limiter_gain_plain(tg, rc)
    out = _launch("oh_limiter_gain", tg, rc)
    limiter_gain.launches += 1
    return out


limiter_gain.launches = 0


def follow_envelope_serial(a: torch.Tensor, attack: float,
                           release: float) -> torch.Tensor:
    """follow_envelope by csrc/dsp.cu's serial walk (one thread a signal):
    a reference on the card, never on the path. CPU tensors take the
    plain version."""
    if a.device.type == "cpu":
        return follow_envelope_plain(a, attack, release)
    out = _launch("oh_envelope", a, attack, release, serial=True)
    follow_envelope_serial.launches += 1
    return out


follow_envelope_serial.launches = 0


def limiter_gain_serial(tg: torch.Tensor, rc: float) -> torch.Tensor:
    """limiter_gain by csrc/dsp.cu's serial walk: a reference on the card,
    never on the path. CPU tensors take the plain version."""
    if tg.device.type == "cpu":
        return limiter_gain_plain(tg, rc)
    out = _launch("oh_limiter_gain", tg, rc, serial=True)
    limiter_gain_serial.launches += 1
    return out


limiter_gain_serial.launches = 0


# ---------------------------------------------------------------------------
# Compressor, limiter, chain
# ---------------------------------------------------------------------------

def compress(x: torch.Tensor, threshold_db: float = -20.0, ratio: float = 4.0,
             attack_ms: float = 5.0, release_ms: float = 50.0,
             makeup_gain_db: float = 0.0,
             sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """Dynamic range compression of [..., n] fp32 audio.
    Parity: src/input/audio.rs:131-196."""
    if ratio <= 1.0:
        return x
    threshold = fp32_scalar(10.0 ** (threshold_db / 20.0), x)
    env = follow_envelope(x.abs(), smoothing_coeff(attack_ms, sample_rate),
                          smoothing_coeff(release_ms, sample_rate))
    over_db = 20.0 * torch.log10(torch.clamp(env / threshold, min=1e-30))
    reduction_db = over_db - _div(over_db, ratio)
    gain = torch.where(env > threshold, torch.pow(10.0, _div(-reduction_db, 20.0)),
                       fp32_scalar(1.0, x))
    y = x * gain
    if makeup_gain_db != 0.0:
        y = apply_gain(y, makeup_gain_db)
    return y


def limit(x: torch.Tensor, ceiling_db: float = -1.0, release_ms: float = 50.0,
          sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """Brick-wall limiter of [..., n] fp32 audio: instant attack, smooth
    release. Parity: src/input/audio.rs:198-247."""
    ceiling = fp32_scalar(10.0 ** (ceiling_db / 20.0), x)
    x_abs = x.abs()
    target_gain = torch.where(x_abs > ceiling,
                              ceiling / torch.clamp(x_abs, min=1e-30),
                              fp32_scalar(1.0, x))
    return x * limiter_gain(target_gain,
                            smoothing_coeff(release_ms, sample_rate))


def preprocess_chain(x: torch.Tensor, *, normalize: bool = True,
                     target_db: float = -20.0, compress_enabled: bool = False,
                     threshold_db: float = -20.0, ratio: float = 4.0,
                     attack_ms: float = 5.0, release_ms: float = 50.0,
                     makeup_gain_db: float = 0.0, limiter: bool = True,
                     ceiling_db: float = -1.0, limiter_release_ms: float = 50.0,
                     sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """The worker's per-job preprocess order after denoise: normalize →
    compress → limit (src/queue/worker.rs:196-240)."""
    y = x
    if normalize:
        y = normalize_rms(y, target_db)
    if compress_enabled:
        y = compress(y, threshold_db, ratio, attack_ms, release_ms,
                     makeup_gain_db, sample_rate)
    if limiter:
        y = limit(y, ceiling_db, limiter_release_ms, sample_rate)
    return y
