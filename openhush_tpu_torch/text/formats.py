"""Output formatters: text / timestamped / SRT / VTT, byte-compatible with the
reference (src/recording.rs:73-194)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class TranscribedSegment:
    """Parity: TranscribedSegment (src/recording.rs:118-131)."""
    start_secs: float
    end_secs: float
    text: str
    speaker_id: Optional[int] = None


FORMATS = ("text", "timestamped", "srt", "vtt")


def parse_format(s: str) -> str:
    """Parity: OutputFormat::from_str (src/recording.rs:86-101)."""
    aliases = {"text": "text", "txt": "text",
               "timestamped": "timestamped", "ts": "timestamped",
               "srt": "srt", "subrip": "srt",
               "vtt": "vtt", "webvtt": "vtt"}
    key = s.lower()
    if key not in aliases:
        raise ValueError(
            f"Unknown format '{s}'. Use: text, timestamped, srt, vtt")
    return aliases[key]


def format_timestamp(secs: float) -> str:
    """HH:MM:SS (src/recording.rs:166-172)."""
    total = int(secs)
    return f"{total // 3600:02}:{(total % 3600) // 60:02}:{total % 60:02}"


def _hmsms(secs: float) -> tuple[int, int, int, int]:
    total_ms = int(secs * 1000.0)
    return (total_ms // 3600000, (total_ms % 3600000) // 60000,
            (total_ms % 60000) // 1000, total_ms % 1000)


def format_srt_timestamp(secs: float) -> str:
    """HH:MM:SS,mmm (src/recording.rs:175-182)."""
    h, m, s, ms = _hmsms(secs)
    return f"{h:02}:{m:02}:{s:02},{ms:03}"


def format_vtt_timestamp(secs: float) -> str:
    """HH:MM:SS.mmm (src/recording.rs:185-192)."""
    h, m, s, ms = _hmsms(secs)
    return f"{h:02}:{m:02}:{s:02}.{ms:03}"


def format_timestamped(seg: TranscribedSegment) -> str:
    start = format_timestamp(seg.start_secs)
    if seg.speaker_id is not None:
        return f"[{start}] Speaker {seg.speaker_id}: {seg.text}"
    return f"[{start}] {seg.text}"


def format_srt(seg: TranscribedSegment, index: int) -> str:
    start = format_srt_timestamp(seg.start_secs)
    end = format_srt_timestamp(seg.end_secs)
    text = (f"<v Speaker {seg.speaker_id}>{seg.text}"
            if seg.speaker_id is not None else seg.text)
    return f"{index}\n{start} --> {end}\n{text}\n"


def format_vtt(seg: TranscribedSegment) -> str:
    start = format_vtt_timestamp(seg.start_secs)
    end = format_vtt_timestamp(seg.end_secs)
    text = (f"<v Speaker {seg.speaker_id}>{seg.text}"
            if seg.speaker_id is not None else seg.text)
    return f"{start} --> {end}\n{text}\n"


def render(segments: Sequence[TranscribedSegment], fmt: str) -> str:
    """Render a whole transcript in one of the four formats. SRT entries are
    newline-separated with 1-based indices; VTT starts with the WEBVTT
    header (as written by the reference's save path, src/recording.rs:506)."""
    fmt = parse_format(fmt)
    if fmt == "text":
        return "\n".join(s.text for s in segments) + ("\n" if segments else "")
    if fmt == "timestamped":
        return "\n".join(format_timestamped(s) for s in segments) + \
            ("\n" if segments else "")
    if fmt == "srt":
        return "\n".join(format_srt(s, i + 1)
                         for i, s in enumerate(segments))
    # vtt
    body = "\n".join(format_vtt(s) for s in segments)
    return "WEBVTT\n\n" + body
