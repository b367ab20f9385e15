"""Host audio capture sources.

The reference captures via cpal (src/input/audio.rs:452-841) with an
always-on stream at the device rate, mono-mixed and resampled on extract.
Here sources implement one protocol and feed the ring buffer from a callback
thread; the daemon never blocks on audio.

- SoundDeviceSource: real microphones via the `sounddevice` package when the
  deployment image has it (this CI image does not — import-gated).
- FileSource: streams a WAV at real-time (or accelerated) pace — used by
  tests and for reproducing bugs from recordings.
- NullSource: silence at real-time pace (headless daemon smoke tests).

A copy of openhush_tpu/audio/capture.py, over the port's copy of
ops/resample.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from openhush_tpu_torch.ops.resample import resample

Callback = Callable[[np.ndarray], None]


class AudioSourceError(RuntimeError):
    pass


class FileSource:
    """Streams a mono 16 kHz waveform in blocks, pacing like a live mic."""

    def __init__(self, samples: np.ndarray, sample_rate: int = 16_000,
                 block_ms: int = 32, realtime: bool = True):
        self.samples = np.asarray(samples, np.float32)
        self.sample_rate = sample_rate
        self.block = int(sample_rate * block_ms / 1000)
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, callback: Callback) -> None:
        self._stop.clear()

        def run():
            i = 0
            while not self._stop.is_set() and i < len(self.samples):
                chunk = self.samples[i:i + self.block]
                callback(chunk)
                i += self.block
                if self.realtime:
                    time.sleep(self.block / self.sample_rate)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="file-audio-source")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def wait_done(self, timeout: float = 60) -> None:
        if self._thread:
            self._thread.join(timeout=timeout)


class NullSource(FileSource):
    """Silence forever (or for `duration_secs`)."""

    def __init__(self, duration_secs: float = 3600.0,
                 sample_rate: int = 16_000):
        super().__init__(np.zeros(int(duration_secs * sample_rate),
                                  np.float32), sample_rate)


class CaptureWatchdog:
    """Device-disconnect detection: if no audio arrives for `timeout_secs`,
    call `reinit` (parity: disconnect detection + reinit to the default
    device, src/input/audio.rs:750-840). Separate from the sounddevice
    layer so the policy is unit-testable without hardware."""

    def __init__(self, reinit: Callable[[], None],
                 timeout_secs: float = 3.0, poll_secs: float = 0.5):
        self.reinit = reinit
        self.timeout = timeout_secs
        self.poll = poll_secs
        self._last_data = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reinit_count = 0

    def heartbeat(self) -> None:
        self._last_data = time.monotonic()

    def start(self) -> None:
        self._stop.clear()
        self._last_data = time.monotonic()

        def run():
            while not self._stop.wait(self.poll):
                if time.monotonic() - self._last_data > self.timeout:
                    self.reinit_count += 1
                    try:
                        self.reinit()
                    except Exception:  # noqa: BLE001 — retry next poll
                        pass
                    self._last_data = time.monotonic()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="capture-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class SoundDeviceSource:
    """Real microphone via sounddevice (when available). Captures at the
    device rate, mono-mixes selected channels, resamples to 16 kHz —
    parity with AudioRecorder (src/input/audio.rs:614-840). A watchdog
    reinitializes the stream (falling back to the default device) when the
    callback goes silent — device unplugged or server restarted."""

    def __init__(self, device: Optional[str] = None,
                 channels: Optional[list[int]] = None,
                 target_rate: int = 16_000):
        try:
            import sounddevice as sd  # type: ignore
        except ImportError as e:
            raise AudioSourceError(
                "sounddevice not installed — use FileSource or install the "
                "audio extra") from e
        self._sd = sd
        self.device = device
        self.channels = channels
        self.sample_rate = target_rate
        self._stream = None
        self._callback: Optional[Callback] = None
        self._watchdog = CaptureWatchdog(self._reinit)

    @staticmethod
    def list_devices() -> list[dict]:
        try:
            import sounddevice as sd  # type: ignore
        except ImportError:
            return []
        return [dict(d) for d in sd.query_devices()]

    def start(self, callback: Callback) -> None:
        self._callback = callback
        self._open_stream()
        self._watchdog.start()

    def _open_stream(self) -> None:
        sd = self._sd
        info = sd.query_devices(self.device, "input")
        native_rate = int(info["default_samplerate"])
        n_ch = int(info["max_input_channels"])
        callback = self._callback

        def cb(indata, frames, time_info, status):
            self._watchdog.heartbeat()
            data = np.asarray(indata, np.float32)
            if self.channels:
                sel = [c for c in self.channels if 0 <= c < n_ch]
                data = data[:, sel] if sel else data
            mono = data.mean(axis=1)
            if native_rate != self.sample_rate:
                mono = resample(mono, native_rate, self.sample_rate)
            callback(mono)

        self._stream = sd.InputStream(
            device=self.device, channels=n_ch, samplerate=native_rate,
            callback=cb)
        self._stream.start()

    def _reinit(self) -> None:
        """Reopen capture; fall back to the default device if the selected
        one disappeared."""
        import logging
        logging.getLogger(__name__).warning(
            "Audio capture stalled — reinitializing stream")
        try:
            if self._stream:
                self._stream.stop()
                self._stream.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._open_stream()
        except Exception:
            self.device = None          # fall back to default device
            self._open_stream()

    def stop(self) -> None:
        self._watchdog.stop()
        if self._stream:
            self._stream.stop()
            self._stream.close()
            self._stream = None
