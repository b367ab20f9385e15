"""Transcription tracker: ordering, cross-chunk dedup, backpressure.

Behavioral parity with src/queue/mod.rs:60-300:
- streaming mode outputs completed chunks immediately (sorted by key),
  ordered mode buffers until sequence order;
- dedup removes up to 10 leading words of a new chunk that appear in the
  last ≤50 characters of previous output;
- backpressure strategies drop_oldest / drop_newest / warn with max_pending
  and a high-water warning mark.

A copy of openhush_tpu/runtime/tracker.py.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TranscriptionJob:
    """Parity: TranscriptionJob (src/queue/mod.rs:18-27)."""
    audio: "object"                 # np.ndarray, mono 16 kHz
    sequence_id: int
    chunk_id: int
    is_final: bool = False


@dataclasses.dataclass
class ChunkResult:
    """Parity: TranscriptionResult (src/queue/mod.rs:30-43)."""
    text: str
    sequence_id: int
    chunk_id: int
    is_final: bool
    duration_secs: float


@dataclasses.dataclass
class QueueStats:
    pending_count: int
    waiting_count: int


class TranscriptionTracker:
    """Pending/completed bookkeeping with ordered or streaming output."""

    def __init__(self, streaming: bool = True):
        self.streaming = streaming
        self._pending: set[tuple[int, int]] = set()
        self._completed: dict[tuple[int, int], ChunkResult] = {}
        self._next_output_id = 0
        self._last_text_suffix = ""

    # -- admission -------------------------------------------------------------

    def add_pending(self, sequence_id: int, chunk_id: int,
                    max_pending: int = 10, high_water_mark: int = 8,
                    strategy: str = "warn") -> bool:
        """Returns False iff the job was rejected (drop_newest at capacity).
        Parity: add_pending_with_config (src/queue/mod.rs:111-175)."""
        count = len(self._pending)
        if max_pending > 0 and count >= max_pending:
            if strategy == "drop_oldest":
                if self._pending:
                    oldest = min(self._pending)
                    self._pending.discard(oldest)
                    log.warning(
                        "Backpressure: dropped oldest job (seq %d.%d) to "
                        "accept (seq %d.%d)", *oldest, sequence_id, chunk_id)
            elif strategy == "drop_newest":
                log.warning(
                    "Backpressure: rejecting job (seq %d.%d) - queue full "
                    "(%d/%d)", sequence_id, chunk_id, count, max_pending)
                return False
            else:
                log.warning("Queue at capacity (%d/%d) but accepting job "
                            "anyway", count, max_pending)
        elif high_water_mark > 0 and count >= high_water_mark:
            log.warning("Queue depth %d approaching limit %d - "
                        "transcription falling behind", count, max_pending)
        self._pending.add((sequence_id, chunk_id))
        return True

    def drop_pending(self, sequence_id: int, chunk_id: int) -> None:
        """Remove a pending entry whose job was lost (worker failure)."""
        self._pending.discard((sequence_id, chunk_id))

    # -- completion --------------------------------------------------------------

    def add_result(self, result: ChunkResult) -> None:
        key = (result.sequence_id, result.chunk_id)
        self._pending.discard(key)
        self._completed[key] = result

    def take_ready(self) -> list[ChunkResult]:
        if self.streaming:
            return self._take_streaming()
        return self._take_ordered()

    def _take_streaming(self) -> list[ChunkResult]:
        ready = sorted(self._completed.values(),
                       key=lambda r: (r.sequence_id, r.chunk_id))
        self._completed.clear()
        for r in ready:
            if self._last_text_suffix and r.text:
                r.text = self._deduplicate(r.text)
            if len(r.text) > 10:
                self._last_text_suffix = r.text[-50:]
        return ready

    def _take_ordered(self) -> list[ChunkResult]:
        ready = []
        while (self._next_output_id, 0) in self._completed:
            ready.append(self._completed.pop((self._next_output_id, 0)))
            self._next_output_id += 1
        return ready

    # -- dedup -------------------------------------------------------------------

    def _deduplicate(self, text: str) -> str:
        """Skip up to 10 leading words that already appear in the last output
        suffix (parity: deduplicate_text, src/queue/mod.rs:249-274)."""
        suffix = self._last_text_suffix
        words = text.split()
        if not words:
            return text
        skip = 0
        for i in range(1, min(len(words), 10) + 1):
            prefix = " ".join(words[:i])
            if prefix in suffix:
                skip = i
        if skip:
            log.debug("Deduplicating: skipping %d words", skip)
            return " ".join(words[skip:])
        return text

    def reset_dedup(self) -> None:
        self._last_text_suffix = ""

    # -- stats -------------------------------------------------------------------

    def stats(self) -> QueueStats:
        return QueueStats(len(self._pending), len(self._completed))

    def is_empty(self) -> bool:
        return not self._pending and not self._completed

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def waiting_count(self) -> int:
        return len(self._completed)
