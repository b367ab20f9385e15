"""Long-form recording sessions (`openhush record`), on the GPU.

Parity: src/recording.rs (577 LoC) — streams audio from a source (system
audio/mic/WAV file), transcribes in 5 s chunks with 0.5 s overlap
(:28-32), optional per-chunk speaker diarization, live stdout, and
text/timestamped/SRT/VTT output with a final flush on interrupt
(:237-506). Here chunks flow through the continuous-batching engine server
instead of a blocking per-chunk FFI call, so transcription of chunk N
overlaps capture of chunk N+1 by construction. The model (K1-K5 through
`EngineServer`, at the full audio_ctx 1500) and the diarizer run on the
card; `cmd_record` builds both on CUDA and fails without it, and tests pass
device="cpu".

Port of openhush_tpu/runtime/recording.py. Differences from it:
- A session on a file ends by itself (ROADMAP C, F3). The reference's loop
  ends only while fewer than 0.5 s of samples are buffered, but every cut
  keeps the 0.5 s overlap, so after the first chunk the buffer never falls
  below that and `record --source file:...` runs until Ctrl+C or
  --max-duration. Here the loop ends once the source's thread has
  finished, fewer than one chunk's samples remain and no window is in
  flight; `finish` then submits the remainder (>= 0.1 s) and drains it, as
  the reference's does.
- The buffer is shared by the source's thread (which appends) and the loop
  (which cuts chunks) under a lock; the reference swaps it unlocked, so a
  block that arrives during a cut can be lost.
- `cmd_record` builds its engine without a draft model (ROADMAP C): the
  reference's engine loads `transcription.draft_model` and its server
  never uses it. On random weights (OPENHUSH_ALLOW_RANDOM_INIT=1, a dev
  mode) the server's temperature ladder is neutralized as `start`'s is
  (runtime/daemon._build_daemon): untrained logits would send every window
  through all six rungs.
- A source that cannot start (`monitor` without parec/pw-record) ends
  `record` with exit 1 and its message, before the server starts; the
  reference's raises out of the session with a traceback.
- The session keeps each window's submit-to-text latency and the
  diarizer's host time for each chunk (`latencies`, `diarize_secs`), and
  logs them at debug level.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np

from openhush_tpu_torch.text import formats

log = logging.getLogger(__name__)

CHUNK_DURATION_SECS = 5.0
CHUNK_OVERLAP_SECS = 0.5
SAMPLE_RATE = 16_000
CHUNK_SAMPLES = int(CHUNK_DURATION_SECS * SAMPLE_RATE)
OVERLAP_SAMPLES = int(CHUNK_OVERLAP_SECS * SAMPLE_RATE)


class CaptureUnavailable(RuntimeError):
    """The session's audio source could not start."""


@dataclasses.dataclass
class RecordingConfig:
    """Parity: RecordingConfig (src/recording.rs:104-116)."""
    source: str = "mic"                   # mic|monitor|both|file:<path>
    output_file: Optional[str] = None
    enable_diarization: bool = False
    live_mode: bool = True
    output_format: str = "text"


class RecordingSession:
    """Capture → chunk → transcribe (→ diarize) → format loop. The default
    diarizer runs on `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: RecordingConfig, server, audio_source,
                 tokenizer=None, diarizer=None, stdout=None, device=None):
        self.config = config
        self.server = server
        self.source = audio_source
        self.stdout = stdout or sys.stdout
        self.segments: list[formats.TranscribedSegment] = []
        self._buffer = np.zeros(0, np.float32)
        self._buffer_lock = threading.Lock()
        self._consumed_secs = 0.0
        self._session_id: Optional[int] = None
        self._pending = 0
        self._stop = False
        self._chunk_speakers: dict[int, list] = {}
        self._submitted_at: dict[int, float] = {}
        # window id (ms) → submit-to-result seconds; the diarizer's host
        # seconds for each chunk.
        self.latencies: dict[int, float] = {}
        self.diarize_secs: list[float] = []
        self.diarizer = diarizer
        if config.enable_diarization and diarizer is None:
            from openhush_tpu_torch.models.diarization import (
                DiarizationEngine)
            self.diarizer = DiarizationEngine.from_local(device=device)

    # -- loop -------------------------------------------------------------------

    def run(self, max_duration: Optional[float] = None) -> None:
        self._session_id = self.server.open_session()
        try:
            self.source.start(self._on_audio)
        except RuntimeError as e:
            raise CaptureUnavailable(str(e)) from e
        if hasattr(self.server, "start"):
            self.server.start()
        fmt = formats.parse_format(self.config.output_format)
        if self.config.live_mode and fmt == "vtt":
            print("WEBVTT\n", file=self.stdout)
        started = time.monotonic()
        try:
            while not self._stop:
                if max_duration and time.monotonic() - started > max_duration:
                    break
                self._maybe_submit_chunk()
                self._drain()
                if self._source_done() and self._pending == 0 and \
                        self._buffered() < CHUNK_SAMPLES:
                    break  # file source exhausted and everything drained
                time.sleep(0.01)
        finally:
            self.finish()

    def stop(self) -> None:
        self._stop = True

    def finish(self) -> None:
        """Final flush: submit the remainder, wait for results, save.
        Parity: Ctrl+C final flush + save_to_file (recording.rs:506)."""
        try:
            self.source.stop()
        except Exception:  # noqa: BLE001
            pass
        with self._buffer_lock:
            rest, self._buffer = self._buffer, np.zeros(0, np.float32)
        if len(rest) >= SAMPLE_RATE // 10:
            self._submit(rest)
        deadline = time.monotonic() + 120
        while self._pending > 0 and time.monotonic() < deadline:
            self._drain()
            time.sleep(0.01)
        if hasattr(self.server, "stop"):
            self.server.stop()
        if self.config.output_file:
            self.save_to_file(self.config.output_file)

    # -- internals ----------------------------------------------------------------

    def _source_done(self) -> bool:
        thread = getattr(self.source, "_thread", None)
        return thread is not None and not thread.is_alive()

    def _buffered(self) -> int:
        with self._buffer_lock:
            return len(self._buffer)

    def _on_audio(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32)
        with self._buffer_lock:
            self._buffer = np.concatenate([self._buffer, samples])

    def _maybe_submit_chunk(self) -> None:
        with self._buffer_lock:
            if len(self._buffer) < CHUNK_SAMPLES:
                return
            chunk = self._buffer[:CHUNK_SAMPLES]
            self._buffer = self._buffer[CHUNK_SAMPLES - OVERLAP_SAMPLES:]
        self._submit(chunk)

    def _submit(self, chunk: np.ndarray) -> None:
        offset = self._consumed_secs
        self._consumed_secs += max(
            0.0, len(chunk) / SAMPLE_RATE - CHUNK_OVERLAP_SECS)
        window_id = int(offset * 1000)
        self._submitted_at[window_id] = time.monotonic()
        self.server.submit_window(
            self._session_id, chunk, window_id=window_id, timestamps=False)
        self._pending += 1
        if self.diarizer is not None:
            t0 = time.perf_counter()
            self._chunk_speakers[window_id] = self.diarizer.diarize_chunk(
                chunk, offset_secs=offset)
            self.diarize_secs.append(time.perf_counter() - t0)
            log.debug("diarized the chunk at %d ms in %.2f ms", window_id,
                      self.diarize_secs[-1] * 1e3)

    def _drain(self) -> None:
        while True:
            res = self.server.poll(self._session_id)
            if res is None:
                return
            self._pending -= 1
            t_sub = self._submitted_at.pop(res.window_id, None)
            if t_sub is not None:
                self.latencies[res.window_id] = time.monotonic() - t_sub
                log.debug("window at %d ms: submit -> result %.1f ms",
                          res.window_id,
                          self.latencies[res.window_id] * 1e3)
            offset = res.window_id / 1000.0
            text = res.text.strip()
            if not text:
                continue
            speaker = dominant_speaker(
                self._chunk_speakers.get(res.window_id, []))
            seg = formats.TranscribedSegment(
                start_secs=offset,
                end_secs=offset + CHUNK_DURATION_SECS,
                text=text, speaker_id=speaker)
            self.segments.append(seg)
            if self.config.live_mode:
                self._emit_live(seg)

    def _emit_live(self, seg: formats.TranscribedSegment) -> None:
        fmt = formats.parse_format(self.config.output_format)
        if fmt == "text":
            print(seg.text, file=self.stdout, flush=True)
        elif fmt == "timestamped":
            print(formats.format_timestamped(seg), file=self.stdout,
                  flush=True)
        elif fmt == "srt":
            print(formats.format_srt(seg, len(self.segments)),
                  file=self.stdout, flush=True)
        else:
            print(formats.format_vtt(seg), file=self.stdout, flush=True)

    def save_to_file(self, path: str) -> None:
        self.segments.sort(key=lambda s: s.start_secs)
        with open(path, "w") as f:
            f.write(formats.render(self.segments,
                                   self.config.output_format))
        log.info("Saved %d segments to %s", len(self.segments), path)


def dominant_speaker(segments) -> Optional[int]:
    """The speaker with the most speech in a chunk's diarization segments
    (None for none)."""
    durations: dict[int, float] = {}
    for s in segments:
        durations[s.speaker_id] = durations.get(
            s.speaker_id, 0.0) + s.end_secs - s.start_secs
    return max(durations, key=durations.get) if durations else None


# ---------------------------------------------------------------------------
# CLI entry (dispatched via daemon_cli: `openhush record ...`)
# ---------------------------------------------------------------------------

def build_server(model: str, language: str = "auto", device=None):
    """The engine and the server `record` runs → (engine, server): the
    engine without a draft (draft_model="", whatever the config or
    OPENHUSH_DRAFT_MODEL say), random weights only under
    OPENHUSH_ALLOW_RANDOM_INIT=1 (and then the ladder neutralized), the
    server at the model's full audio_ctx with no preprocess. On CUDA
    unless `device` says otherwise."""
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    from openhush_tpu_torch.runtime.server import EngineServer

    allow_random = os.environ.get("OPENHUSH_ALLOW_RANDOM_INIT") == "1"
    eng = WhisperEngine(model, language=language,
                        allow_random_init=allow_random, draft_model="",
                        device=device)
    guards = ({} if not eng.random_init
              else dict(temperatures=(0.0,), logprob_threshold=-1e9,
                        no_speech_threshold=2.0))
    return eng, EngineServer(eng.cfg, eng.params, tokenizer=eng.tokenizer,
                             dtype=eng.dtype, **guards)


def cmd_record(args: list[str]) -> int:
    import argparse

    from openhush_tpu_torch.audio.capture import FileSource, SoundDeviceSource
    from openhush_tpu_torch.audio.wav import load_wav
    from openhush_tpu_torch.device import resolve_device
    from openhush_tpu_torch.utils.config import Config

    p = argparse.ArgumentParser(prog="openhush record")
    p.add_argument("--source", "-s", default="mic",
                   help="mic|monitor|both|file:<path>")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--format", "-F", default="text")
    p.add_argument("--diarize", action="store_true")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--max-duration", type=float, default=None)
    p.add_argument("--device", default=None,
                   help="run elsewhere than on CUDA (e.g. cpu)")
    ns = p.parse_args(args)

    try:
        formats.parse_format(ns.format)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    try:
        device = resolve_device(ns.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1

    config = Config.load_or_default()
    model = ns.model or config.transcription.effective_model()
    try:
        eng, server = build_server(model, config.transcription.language,
                                   device=device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    log.info("record: %s on %s (%s weights), audio_ctx %d", model,
             device.type, "random" if eng.random_init else "loaded",
             server.audio_ctx)

    if ns.source.startswith("file:"):
        source = FileSource(load_wav(ns.source[5:]), realtime=False)
    elif ns.source == "mic":
        try:
            source = SoundDeviceSource()
        except Exception as e:  # noqa: BLE001
            print(f"Microphone capture unavailable ({e})", file=sys.stderr)
            return 1
    elif ns.source == "monitor":
        from openhush_tpu_torch.audio.system_audio_hosts import (
            open_system_source)
        try:
            source = open_system_source()
        except RuntimeError as e:
            print(f"System-audio capture unavailable ({e})",
                  file=sys.stderr)
            return 1
    elif ns.source == "both":
        from openhush_tpu_torch.audio.system_audio import MixedSource
        from openhush_tpu_torch.audio.system_audio_hosts import (
            open_system_source)
        try:
            source = MixedSource(SoundDeviceSource(), open_system_source())
        except Exception as e:  # noqa: BLE001
            print(f"Mixed capture unavailable ({e})", file=sys.stderr)
            return 1
    else:
        print(f"unknown source {ns.source!r}", file=sys.stderr)
        return 2

    session = RecordingSession(
        RecordingConfig(source=ns.source, output_file=ns.output,
                        enable_diarization=ns.diarize, live_mode=True,
                        output_format=ns.format),
        server, source, device=device)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, lambda *a: session.stop())
    try:
        session.run(max_duration=ns.max_duration)
    except CaptureUnavailable as e:
        print(f"Capture unavailable ({e})", file=sys.stderr)
        return 1
    return 0
