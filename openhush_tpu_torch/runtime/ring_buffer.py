"""Always-on audio ring buffer with mark/extract semantics.

Parity: src/input/ring_buffer.rs — power-of-2 capacity + mask, monotonic
write position (never wraps logically), `mark()` snapshots a position,
`extract_since`/`extract_range` handle wraparound by clamping to capacity
and warning. The reference's lock-free SPSC safety argument
(ring_buffer.rs:38-65) maps to numpy slice-assignment under a mutex here;
the optional C++ backend (native/) provides the true lock-free SPSC path
for capture callbacks that cannot take the GIL.

A copy of openhush_tpu/runtime/ring_buffer.py over the port's
utils/native.py, which compiles the repo's native/openhush_native.cpp into
the port's own build directory.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AudioMark:
    """Snapshot of a buffer position (parity: AudioMark, ring_buffer.rs:157)."""
    position: int
    sequence: int


class RingBuffer:
    """Monotonic-position audio ring buffer.

    Backend: the lock-free C++ SPSC ring (native/openhush_native.cpp) when
    the native library is available — the capture callback then pushes with
    no lock and no GIL-held copies — else a numpy-under-mutex fallback with
    identical semantics.
    """

    def __init__(self, duration_secs: float = 30.0,
                 sample_rate: int = 16_000, prefer_native: bool = True):
        min_capacity = int(duration_secs * sample_rate)
        self.sample_rate = sample_rate
        self._native = None
        if prefer_native:
            try:
                from openhush_tpu_torch.utils.native import NativeRing
                self._native = NativeRing(min_capacity)
            except (RuntimeError, MemoryError, ImportError):
                self._native = None
        if self._native is not None:
            self.capacity = self._native.capacity
        else:
            capacity = 1
            while capacity < min_capacity:
                capacity <<= 1
            self.capacity = capacity
        self.mask = self.capacity - 1
        self._buffer = (None if self._native is not None
                        else np.zeros(self.capacity, np.float32))
        self._write_pos = 0          # monotonic, never masked
        self._sequence = 0
        self._lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        return self._native is not None

    # -- producer -------------------------------------------------------------

    def push(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).ravel()
        n = len(samples)
        if n == 0:
            return
        if self._native is not None:
            self._native.push(samples)
            self._sequence += 1
            return
        if n > self.capacity:        # keep only the newest capacity samples
            samples = samples[-self.capacity:]
            n = self.capacity
        with self._lock:
            start = self._write_pos & self.mask
            first = min(n, self.capacity - start)
            self._buffer[start:start + first] = samples[:first]
            if first < n:
                self._buffer[:n - first] = samples[first:]
            self._write_pos += n
            self._sequence += 1

    # -- consumer -------------------------------------------------------------

    def mark(self) -> AudioMark:
        return AudioMark(self.current_position(), self._sequence)

    def current_position(self) -> int:
        if self._native is not None:
            return self._native.position()
        with self._lock:
            return self._write_pos

    @property
    def write_position(self) -> int:
        return self.current_position()

    def extract_since(self, mark: AudioMark) -> np.ndarray:
        return self.extract_range(mark.position, self.current_position())

    def extract_range(self, from_pos: int, to_pos: int) -> np.ndarray:
        """Extract [from_pos, to_pos) handling wraparound: if the span
        exceeds capacity, return only the newest `capacity` samples
        (parity: extract_range, ring_buffer.rs:240-280)."""
        requested = to_pos - from_pos
        if requested <= 0:
            return np.zeros(0, np.float32)
        if requested > self.capacity:
            log.warning(
                "Chunk extraction: buffer wrapped, requested %d samples "
                "but only %d available", requested,
                min(requested, self.capacity))
        if self._native is not None:
            return self._native.extract_range(from_pos, to_pos)
        available = min(requested, self.capacity)
        if requested > self.capacity:
            from_pos = to_pos - self.capacity
        with self._lock:
            start = from_pos & self.mask
            out = np.empty(available, np.float32)
            first = min(available, self.capacity - start)
            out[:first] = self._buffer[start:start + first]
            if first < available:
                out[first:] = self._buffer[:available - first]
        return out

    def duration_secs(self) -> float:
        return self.capacity / self.sample_rate
