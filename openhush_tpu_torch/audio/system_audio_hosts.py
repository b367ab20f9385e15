"""Windows/macOS system-audio (loopback) capture sources.

Parity: src/input/system_audio_windows.rs (WASAPI loopback on the default
render device, polling capture loop + linear 48k→16k resampler) and
src/input/system_audio_macos.rs (ScreenCaptureKit desktop audio at 48 kHz
→ 16 kHz). Linux monitors live in audio/system_audio.py.

TPU-host posture: the capture device surface is reached through
sounddevice/PortAudio rather than raw COM / ObjC bindings. The
protocol-testable halves — loopback-device discovery/ranking, the
streaming resampler, mono downmix, and the guidance errors — are pure and
unit-tested off-OS (tests/test_platform_hosts.py); the stream-open half
degrades into `SystemAudioUnavailable` carrying install guidance, the
graceful-failure behavior the reference gets from its error enums
(system_audio_windows.rs:48-97).

Windows: PortAudio exposes loopback either as explicit "[Loopback]"
WASAPI inputs (patched builds), as a WasapiSettings(loopback=) flag
(feature-detected), or via vendor "Stereo Mix" devices — all three are
tried in that order. macOS: ScreenCaptureKit has no stable C ABI to
reach from ctypes, so capture routes through a loopback virtual device
(BlackHole et al.), the supported-and-documented path; absent one, the
error explains the one-command install.

A copy of openhush_tpu/audio/system_audio_hosts.py.
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Callable, Optional

import numpy as np

log = logging.getLogger(__name__)

Callback = Callable[[np.ndarray], None]
TARGET_RATE = 16_000


class SystemAudioUnavailable(RuntimeError):
    """Loopback capture can't start on this host; .guidance says how to
    enable it (parity: SystemAudioError variants with user-facing
    messages, system_audio_windows.rs:48-64)."""

    def __init__(self, message: str, guidance: str):
        super().__init__(f"{message}\n{guidance}")
        self.guidance = guidance


WINDOWS_GUIDANCE = """\
To capture system audio on Windows, one of:
  * enable "Stereo Mix" (Sound settings -> Recording -> right-click ->
    Show Disabled Devices -> Stereo Mix -> Enable), or
  * install VB-Audio Virtual Cable (https://vb-audio.com/Cable/) and set
    it as the default output, then pick "CABLE Output" as the source."""

MACOS_GUIDANCE = """\
To capture system audio on macOS, install a loopback audio driver:
  brew install blackhole-2ch
then create a Multi-Output Device (Audio MIDI Setup) with your speakers +
BlackHole, route output to it, and pick "BlackHole 2ch" as the source."""


# ---------------------------------------------------------------------------
# Pure halves
# ---------------------------------------------------------------------------

# Input-device name fragments that indicate a loopback/monitor tap, in
# preference order (checked lowercase-substring).
WINDOWS_LOOPBACK_MARKERS = ("[loopback]", "loopback", "stereo mix",
                            "what u hear", "wave out mix", "cable output")
MACOS_LOOPBACK_MARKERS = ("blackhole", "soundflower", "loopback",
                          "ishowu", "vb-cable")


def rank_loopback_devices(devices: list[dict], markers: tuple[str, ...],
                          name: Optional[str] = None) -> list[int]:
    """Indices of input-capable devices that look like loopback taps,
    best first. `devices` rows follow sounddevice.query_devices():
    {'name', 'max_input_channels', ...}. An explicit `name` filters by
    case-insensitive substring instead of the marker list."""
    scored: list[tuple[int, int]] = []
    for idx, dev in enumerate(devices):
        if int(dev.get("max_input_channels", 0)) <= 0:
            continue
        devname = str(dev.get("name", "")).lower()
        if name is not None:
            if name.lower() in devname:
                scored.append((0, idx))
            continue
        for rank, marker in enumerate(markers):
            if marker in devname:
                scored.append((rank, idx))
                break
    return [idx for _, idx in sorted(scored)]


def downmix_mono(block: np.ndarray) -> np.ndarray:
    """[frames, channels] or [frames] → mono float32."""
    a = np.asarray(block, np.float32)
    if a.ndim == 2:
        a = a.mean(axis=1)
    return np.ascontiguousarray(a, np.float32)


class StreamResampler:
    """Streaming linear resampler, phase-continuous across blocks
    (parity: SimpleResampler, system_audio_windows.rs:327-366 — same
    linear interpolation, vectorized)."""

    def __init__(self, rate_in: int, rate_out: int = TARGET_RATE):
        self.step = rate_in / rate_out
        self._phase = 0.0            # position of next output sample
        self._tail = np.zeros(0, np.float32)

    def process(self, block: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._tail, np.asarray(block, np.float32)])
        if len(x) < 2:
            self._tail = x
            return np.zeros(0, np.float32)
        # Output positions that have both neighbours available.
        n_out = int(np.floor((len(x) - 1 - self._phase) / self.step)) + 1
        if n_out <= 0:
            self._tail = x
            return np.zeros(0, np.float32)
        pos = self._phase + self.step * np.arange(n_out)
        i0 = pos.astype(np.int64)
        frac = (pos - i0).astype(np.float32)
        i1 = np.minimum(i0 + 1, len(x) - 1)   # pos may hit len(x)-1 exactly
        out = x[i0] * (1.0 - frac) + x[i1] * frac
        consumed = int(i0[-1])       # keep x[consumed:] for continuity
        self._phase = float(pos[-1] + self.step - consumed)
        self._tail = x[consumed:]
        return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Host sources (sounddevice-backed)
# ---------------------------------------------------------------------------

class _DeviceLoopbackSource:
    """Shared stream plumbing: open `device` as input, downmix + resample
    to 16 kHz mono, feed `callback` — the same contract as
    system_audio.MonitorSource."""

    markers: tuple[str, ...] = ()
    guidance: str = ""

    def __init__(self, source: Optional[str] = None,
                 sample_rate: int = TARGET_RATE, block_ms: int = 32):
        self.source = source
        self.sample_rate = sample_rate
        self.block_ms = block_ms
        self._stream = None
        self._lock = threading.Lock()

    def _sounddevice(self):
        try:
            import sounddevice as sd
            return sd
        except Exception as e:  # noqa: BLE001 — no PortAudio on host
            raise SystemAudioUnavailable(
                f"sounddevice/PortAudio unavailable ({e})",
                self.guidance) from e

    def _pick_device(self, sd) -> int:
        devices = list(sd.query_devices())
        ranked = rank_loopback_devices(devices, self.markers, self.source)
        if not ranked:
            what = (f"device matching {self.source!r}" if self.source
                    else "loopback input device")
            raise SystemAudioUnavailable(f"No {what} found", self.guidance)
        return ranked[0]

    def start(self, callback: Callback) -> None:
        sd = self._sounddevice()
        device = self._pick_device(sd)
        info = sd.query_devices(device)
        native_rate = int(info.get("default_samplerate")
                          or 48_000)
        channels = self._channels(info)
        resampler = (StreamResampler(native_rate, self.sample_rate)
                     if native_rate != self.sample_rate else None)

        def cb(indata, frames, time_info, status):  # noqa: ARG001
            if status:
                log.debug("loopback stream status: %s", status)
            mono = downmix_mono(indata)
            if resampler is not None:
                mono = resampler.process(mono)
            if len(mono):
                callback(mono)

        blocksize = int(native_rate * self.block_ms / 1000)
        self._stream = sd.InputStream(
            device=device, channels=channels, samplerate=native_rate,
            dtype="float32", blocksize=blocksize, callback=cb,
            **self._extra_settings(sd))
        self._stream.start()
        log.info("System-audio capture from %r at %d Hz -> %d Hz",
                 info.get("name"), native_rate, self.sample_rate)

    def _extra_settings(self, sd) -> dict:
        return {}

    def _channels(self, info: dict) -> int:
        return max(1, min(2, int(info.get("max_input_channels", 1))))

    def stop(self) -> None:
        with self._lock:
            if self._stream is not None:
                try:
                    self._stream.stop()
                    self._stream.close()
                finally:
                    self._stream = None


class WasapiLoopbackSource(_DeviceLoopbackSource):
    """Windows system audio (parity: SystemAudioCapture,
    system_audio_windows.rs:98-190). Prefers explicit loopback inputs;
    feature-detects WasapiSettings(loopback=) for PortAudio builds that
    can tap the default render device directly."""

    markers = WINDOWS_LOOPBACK_MARKERS
    guidance = WINDOWS_GUIDANCE

    def _pick_device(self, sd) -> int:
        try:
            return super()._pick_device(sd)
        except SystemAudioUnavailable:
            if self.source is None and _wasapi_supports_loopback(sd):
                out = sd.default.device[1]
                if out is not None and out >= 0:
                    self._force_loopback = True
                    return out
            raise

    def _extra_settings(self, sd) -> dict:
        if getattr(self, "_force_loopback", False):
            return {"extra_settings": sd.WasapiSettings(loopback=True)}
        return {}

    def _channels(self, info: dict) -> int:
        if getattr(self, "_force_loopback", False):
            # Loopback taps the default RENDER device: WASAPI requires
            # the render mix format's channel count (max_input_channels
            # is 0 on an output device).
            return max(1, min(2, int(info.get("max_output_channels", 2))))
        return super()._channels(info)


def _wasapi_supports_loopback(sd) -> bool:
    try:
        return "loopback" in inspect.signature(
            sd.WasapiSettings.__init__).parameters
    except (AttributeError, ValueError, TypeError):
        return False


class MacSystemAudioSource(_DeviceLoopbackSource):
    """macOS desktop audio through a loopback virtual device (parity
    role: SystemAudioCapture, system_audio_macos.rs:144-260 — the
    reference taps ScreenCaptureKit; SCK has no C ABI reachable from
    ctypes, so the supported path here is BlackHole-class drivers, with
    the install one-liner in the failure guidance)."""

    markers = MACOS_LOOPBACK_MARKERS
    guidance = MACOS_GUIDANCE


def open_system_source(source: Optional[str] = None,
                       sample_rate: int = TARGET_RATE,
                       platform: Optional[str] = None):
    """Host-appropriate system-audio source (start(cb)/stop()):
    PulseAudio/PipeWire monitor on Linux, WASAPI loopback on Windows,
    loopback-driver tap on macOS."""
    import sys
    p = platform or sys.platform
    if p.startswith("win"):
        return WasapiLoopbackSource(source, sample_rate)
    if p in ("darwin", "macos"):
        return MacSystemAudioSource(source, sample_rate)
    from .system_audio import MonitorSource
    return MonitorSource(source, sample_rate)
