"""System-audio loopback capture (meeting capture, baseline config #5).

Parity: src/input/system_audio.rs (727 LoC, PulseAudio monitor sources via
libpulse) — here implemented over the `parec`/`pw-record` CLIs (present on
any PulseAudio/PipeWire desktop) streaming raw float32 to a pipe, so no
native audio binding is needed. Also provides source enumeration via
`pactl` and a MixedSource that sums mic + monitor for the mic+system mode
the reference left "not yet implemented" (src/recording.rs:274-294).

A copy of openhush_tpu/audio/system_audio.py.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import threading
from typing import Callable, Optional

import numpy as np

log = logging.getLogger(__name__)

Callback = Callable[[np.ndarray], None]


def list_monitor_sources() -> list[str]:
    """PulseAudio/PipeWire monitor sources via pactl."""
    if not shutil.which("pactl"):
        return []
    try:
        r = subprocess.run(["pactl", "list", "short", "sources"],
                           capture_output=True, text=True, timeout=5)
    except (subprocess.SubprocessError, OSError):
        return []
    out = []
    for line in r.stdout.splitlines():
        parts = line.split("\t")
        if len(parts) >= 2 and ".monitor" in parts[1]:
            out.append(parts[1])
    return out


class MonitorSource:
    """Captures a monitor source at 16 kHz mono float32 via parec."""

    def __init__(self, source: Optional[str] = None,
                 sample_rate: int = 16_000, block_ms: int = 32):
        self.source = source
        self.sample_rate = sample_rate
        self.block = int(sample_rate * block_ms / 1000)
        self._proc: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, callback: Callback) -> None:
        tool = shutil.which("parec") or shutil.which("pw-record")
        if tool is None:
            raise RuntimeError(
                "No system-audio capture tool (parec/pw-record) available")
        source = self.source
        if source is None:
            monitors = list_monitor_sources()
            if not monitors:
                raise RuntimeError("No monitor sources found")
            source = monitors[0]
        if tool.endswith("parec"):
            cmd = [tool, "--device", source, "--format=float32le",
                   f"--rate={self.sample_rate}", "--channels=1", "--raw"]
        else:
            cmd = [tool, "--target", source, "--format", "f32",
                   "--rate", str(self.sample_rate), "--channels", "1", "-"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL)
        self._stop.clear()

        def pump():
            bytes_per_block = self.block * 4
            while not self._stop.is_set():
                data = self._proc.stdout.read(bytes_per_block)
                if not data:
                    break
                callback(np.frombuffer(data, np.float32))

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="monitor-capture")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._proc:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None
        if self._thread:
            self._thread.join(timeout=3)


class MixedSource:
    """Sums two sources sample-aligned (mic + system audio — the 'both'
    mode the reference stubs out). Buffers per source and emits min-length
    mixed blocks."""

    def __init__(self, *sources):
        self.sources = sources
        self._buffers = [np.zeros(0, np.float32) for _ in sources]
        self._lock = threading.Lock()
        self._callback: Optional[Callback] = None

    def start(self, callback: Callback) -> None:
        self._callback = callback
        for i, src in enumerate(self.sources):
            src.start(self._make_cb(i))

    def _make_cb(self, idx: int) -> Callback:
        def cb(samples: np.ndarray) -> None:
            with self._lock:
                self._buffers[idx] = np.concatenate(
                    [self._buffers[idx], samples])
                n = min(len(b) for b in self._buffers)
                if n == 0:
                    return
                mixed = sum(b[:n] for b in self._buffers) / len(
                    self._buffers)
                self._buffers = [b[n:] for b in self._buffers]
            self._callback(mixed.astype(np.float32))
        return cb

    def stop(self) -> None:
        for src in self.sources:
            try:
                src.stop()
            except Exception:  # noqa: BLE001
                pass
