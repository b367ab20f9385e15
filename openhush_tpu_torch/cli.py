"""openhush-torch CLI: the `transcribe` subcommand of openhush_tpu/cli.py for
one file, on the GPU.

Usage: python -m openhush_tpu_torch.cli transcribe FILE [--model large-v3]
[--format text|json|srt|vtt|timestamped] [--random-init] [--device cpu]

The transcript (text block, JSON object, or subtitle body) goes to stdout,
with the reference's JSON keys (src/main.rs:1028-1036); progress lines go
to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_transcribe(sub):
    p = sub.add_parser("transcribe", help="Transcribe one audio file")
    p.add_argument("file", nargs="+")
    p.add_argument("--format", "-f", default="text",
                   help="text|json|srt|vtt|timestamped")
    p.add_argument("--model", "-m", default="large-v3",
                   help="tiny|base|small|medium|large-v2|large-v3|large-v3-turbo")
    p.add_argument("--language", "-l", default=None)
    p.add_argument("--translate", action="store_true")
    p.add_argument("--random-init", action="store_true",
                   help="run with random weights when no checkpoint exists "
                        "(smoke tests only)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr)


def cmd_transcribe(args) -> int:
    from openhush_tpu_torch.audio.wav import load_wav
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    from openhush_tpu_torch.text import formats

    if len(args.file) > 1:
        print("Several files at once are batched by the serving path, which "
              "is not ported yet; pass one file", file=sys.stderr)
        return 2
    path = args.file[0]
    if not os.path.exists(path):
        print(f"File not found: {path}", file=sys.stderr)
        return 1
    fmt = args.format.lower()

    t_load = time.monotonic()
    try:
        audio = load_wav(path)
    except (ValueError, OSError) as e:
        print(f"Cannot load audio: {e}", file=sys.stderr)
        return 1
    duration = len(audio) / 16000.0
    _progress(f"Loaded: {duration:.2f}s audio (1 file(s)) in "
              f"{(time.monotonic() - t_load) * 1000:.0f}ms")

    t_model = time.monotonic()
    try:
        engine = WhisperEngine(args.model, language=args.language or "auto",
                               translate=args.translate, dtype=args.dtype,
                               allow_random_init=args.random_init or
                               os.environ.get(
                                   "OPENHUSH_ALLOW_RANDOM_INIT") == "1",
                               device=args.device)
    except (FileNotFoundError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    _progress(f"Model loaded: {args.model} on {engine.device} in "
              f"{(time.monotonic() - t_model) * 1000:.0f}ms")

    t0 = time.monotonic()
    result = engine.transcribe(audio, language=args.language,
                               translate=args.translate)
    transcribe_s = time.monotonic() - t0

    if fmt == "json":
        # Key set parity: src/main.rs:1028-1036.
        print(json.dumps({
            "text": result.text,
            "language": result.language,
            "duration_ms": result.duration_ms,
            "audio_duration_secs": duration,
            "transcription_time_ms": int(transcribe_s * 1000),
            "real_time_factor": transcribe_s / max(duration, 1e-9),
            "model": args.model,
        }, indent=2))
    elif fmt in ("srt", "vtt", "timestamped"):
        segs = [formats.TranscribedSegment(s.start, s.end, s.text.strip())
                for s in result.segments]
        print(formats.render(segs, fmt), end="")
    else:
        print("\n--- Transcription ---")
        print(result.text)
        print("---")
        _progress(f"Time: {transcribe_s * 1000:.0f}ms "
                  f"(RTF: {transcribe_s / max(duration, 1e-9):.3f}x)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="openhush-torch",
        description="Whisper transcription on the GPU (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_transcribe(sub)
    args = parser.parse_args(argv)
    return cmd_transcribe(args)


def run() -> None:
    sys.exit(main())


if __name__ == "__main__":
    run()
