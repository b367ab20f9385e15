"""Sentence accumulation for streaming translation.

Parity: src/translation/sentence_buffer.rs:9-120 — chunks accumulate until a
sentence terminator (`.`, `!`, `?`, optionally followed by closing quotes)
followed by whitespace or end-of-buffer; a 1024-char force-flush (checked
before extraction, flushing everything) bounds latency; `flush()` empties
the remainder at stream end.

A copy of openhush_tpu/text/sentence_buffer.py.
"""

from __future__ import annotations

MAX_BUFFER = 1024
TERMINATORS = ".!?"
CLOSERS = "\"'’”»)]"


class SentenceBuffer:
    def __init__(self, max_buffer: int = MAX_BUFFER):
        self.max_buffer = max_buffer
        self._buf = ""

    def add(self, text: str) -> list[str]:
        """Add a chunk; return complete sentences ready to translate."""
        self._buf += text
        out: list[str] = []

        if len(self._buf) > self.max_buffer:
            forced = self._buf.strip()
            self._buf = ""
            return [forced] if forced else []

        while True:
            split = self._split_first_sentence()
            if split is None:
                break
            sentence, self._buf = split
            if sentence.strip():
                out.append(sentence.strip())
        return out

    def _split_first_sentence(self) -> tuple[str, str] | None:
        buf = self._buf
        for i, ch in enumerate(buf):
            if ch in TERMINATORS:
                end = i
                while end + 1 < len(buf) and buf[end + 1] in CLOSERS:
                    end += 1
                if end + 1 >= len(buf) or buf[end + 1].isspace():
                    return buf[:end + 1], buf[end + 1:]
        return None

    def flush(self) -> str | None:
        """Return whatever remains (stream end)."""
        rest = self._buf.strip()
        self._buf = ""
        return rest or None

    def is_empty(self) -> bool:
        return not self._buf.strip()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def pending(self) -> str:
        return self._buf
