"""Long-form transcription batched ACROSS files on one device: the port of
openhush_tpu/runtime/longform.py.

Each file runs its own seek loop (window N+1's start depends on window N's
timestamps, so a file is sequential), one window in flight per file, over
one continuous-batching EngineServer that batches the in-flight windows of
different files into one decode step (`openhush transcribe *.wav`).

Semantics against the one-shot engine (runtime/engine.py:transcribe): the
same timestamp-pair segment parsing and seek advance (shared code), the
same temperature ladder and no-speech skip (the server's per-window ladder,
same thresholds); condition_on_previous_text is OFF (the server admits
sot-sequence prompts only, whisper.cpp's `no_context`). With `beam_size`
the server is a BeamEngineServer (runtime/beam_server.py): concurrent
beam-search groups.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from openhush_tpu_torch.ops import mel as mel_ops
from openhush_tpu_torch.runtime import batcher, beam_batcher, engine
from openhush_tpu_torch.runtime.beam_server import BeamEngineServer
from openhush_tpu_torch.runtime.engine import (
    FRAMES_PER_SECOND, TranscriptionResult, parse_window_segments)
from openhush_tpu_torch.runtime.server import EngineServer, hbm_fit_count


@dataclasses.dataclass
class _FileState:
    session_id: int
    audio: np.ndarray
    content_frames: int
    seek: int = 0                      # mel frames consumed
    next_window: int = 0
    inflight: Optional[dict] = None    # submitted-window bookkeeping
    language: Optional[str] = None     # pinned after the first window
    segments: list = dataclasses.field(default_factory=list)
    started_at: float = 0.0
    finished_at: float = 0.0
    windows: int = 0


def transcribe_files(server, audios, *, language: str = "auto",
                     task: str = "transcribe", timestamps: bool = True,
                     ) -> list[TranscriptionResult]:
    """Run one seek loop per audio over a shared EngineServer. `server` may
    be running (start()) or driven synchronously: this function calls
    run_once itself when the server has no live loop thread. Returns one
    TranscriptionResult per input, in order."""
    files = []
    for audio in audios:
        audio = np.asarray(audio, np.float32)
        sid = server.open_session()
        files.append(_FileState(
            session_id=sid, audio=audio,
            content_frames=len(audio) // mel_ops.HOP_LENGTH,
            language=None if language in ("auto", "", None) else language,
            started_at=time.monotonic()))

    driven = server._thread is None or not server._thread.is_alive()
    pending = set(range(len(files)))
    while pending:
        # Submit the next window for every file with nothing in flight.
        for i in list(pending):
            f = files[i]
            if f.inflight is not None:
                continue
            if f.seek >= f.content_frames:
                f.finished_at = time.monotonic()
                server.close_session(f.session_id)
                pending.discard(i)
                continue
            start = f.seek * mel_ops.HOP_LENGTH
            window = f.audio[start:start + mel_ops.N_SAMPLES]
            segment_frames = min(len(window) // mel_ops.HOP_LENGTH,
                                 f.content_frames - f.seek)
            f.inflight = {
                "time_offset": f.seek * mel_ops.HOP_LENGTH
                / mel_ops.SAMPLE_RATE,
                "segment_frames": segment_frames,
                "segment_duration": segment_frames / FRAMES_PER_SECOND,
            }
            server.submit_window(
                f.session_id, window, window_id=f.next_window,
                language=f.language or "auto", task=task,
                timestamps=timestamps)
            f.next_window += 1
            f.windows += 1
        if driven:
            server.run_once()
        # Harvest finished windows → segments + seek advance.
        progressed = False
        for i in list(pending):
            f = files[i]
            if f.inflight is None:
                continue
            res = server.poll(f.session_id)      # non-blocking
            if res is None:
                continue
            progressed = True
            meta, f.inflight = f.inflight, None
            if f.language is None:
                f.language = res.language
            if res.skipped_silence:
                f.seek += meta["segment_frames"]
                continue
            segs, frames_advance = parse_window_segments(
                server.tokenizer, res.tokens, meta["time_offset"],
                meta["segment_duration"], meta["segment_frames"],
                avg_logprob=res.avg_logprob,
                no_speech_prob=res.no_speech_prob,
                compression_ratio=res.compression_ratio,
                temperature=res.temperature)
            for s in segs:
                s.id = len(f.segments)
                f.segments.append(s)
            f.seek += frames_advance
        if not driven and not progressed:
            time.sleep(0.002)

    return [
        TranscriptionResult(
            text="".join(s.text for s in f.segments).strip(),
            language=f.language or "en",
            segments=f.segments,
            duration_ms=int((f.finished_at - f.started_at) * 1000),
            windows=f.windows)
        for f in files
    ]


def make_server(cfg, params, tokenizer, *, n_files: int,
                beam_size: Optional[int] = None,
                max_new_tokens: int = 224,
                n_slots: Optional[int] = None, dtype=None,
                temperatures: Optional[tuple] = None,
                **kw) -> EngineServer:
    """A server sized for a batched long-form job: slots capped by the
    memory budgeter, decode length right-sized to the per-window token
    budget (prompt ≤ 5 + max_new + 1, 64-aligned like the one-shot path).
    `temperatures` defaults to the engine's ladder. With `beam_size`, a
    BeamEngineServer whose n_slots counts beam groups."""
    dtype = dtype or torch.bfloat16
    max_len = min(cfg.n_text_ctx, ((5 + max_new_tokens + 1 + 63) // 64) * 64)
    want = n_slots or min(16, max(1, n_files))
    temperatures = (engine.TEMPERATURES if temperatures is None
                    else temperatures)
    if beam_size:
        fit = hbm_fit_count(params, functools.partial(
            beam_batcher.state_bytes, cfg, beam_size=beam_size, dtype=dtype,
            max_len=max_len))
        want = max(1, min(want, fit) if fit is not None else want)
        return BeamEngineServer(
            cfg, params, beam_size=beam_size, n_slots=want,
            tokenizer=tokenizer, max_decode_len=max_len,
            temperatures=temperatures, dtype=dtype, **kw)
    fit = hbm_fit_count(params, functools.partial(
        batcher.state_bytes, cfg, dtype=dtype, max_len=max_len))
    want = max(1, min(want, fit) if fit is not None else want)
    return EngineServer(
        cfg, params, n_slots=want, tokenizer=tokenizer,
        max_decode_len=max_len, temperatures=temperatures,
        dtype=dtype, max_admissions_per_turn=want, **kw)
