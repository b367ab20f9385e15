"""openhush-torch CLI: the subcommands of openhush_tpu/cli.py, on the GPU.

Usage: python -m openhush_tpu_torch.cli [--version] [-v] COMMAND ...

    transcribe FILE [FILE ...] [--model M] [--language L]
        [--format text|json|srt|vtt|timestamped] [--beam-size K]
        [--draft MODEL] [--random-init] [--device cpu]
    start [--no-tray] [--device cpu] | stop | status
    recording start|stop|toggle|continuous

The daemon subcommands go through runtime/daemon_cli.py to the port's
runtime/daemon.py (`start` runs the dictation daemon on the card; the others
talk to it over its Unix socket). The reference's other subcommands (model,
config, device, record, ...) name the ROADMAP item that ports them and exit
2. Logging: OPENHUSH_LOG, else -v (info) / -vv (debug), else the config
file's logging.level.

`transcribe` resolves its model, language and draft as the reference's
does (openhush_tpu/cli.py:54-56,79-80): the flag, else the config file
(utils/config.py: transcription.effective_model(), .language,
.draft_model), and the draft at last OPENHUSH_DRAFT_MODEL.

One file runs the one-shot engine's seek loop; several files run their seek
loops together through the continuous-batching server
(runtime/longform.py), as the reference CLI does. --beam-size K runs beam
search at T=0: the one-shot engine's, or the server's beam groups. --draft
MODEL (else the config file's, else OPENHUSH_DRAFT_MODEL) runs the one-shot
engine's T=0 rung as
speculative decoding with that draft; several files run the server without
it, as the reference's CLI does. The transcript (text
block, JSON object, or subtitle body; per file, headed, for several files,
and a JSON list with a "file" key) goes to stdout, with the reference's JSON
keys (src/main.rs:1028-1036); progress lines go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_transcribe(sub):
    p = sub.add_parser("transcribe",
                       help="Transcribe audio file(s); several files batch "
                            "through the continuous-batching server")
    p.add_argument("file", nargs="+")
    p.add_argument("--format", "-f", default="text",
                   help="text|json|srt|vtt|timestamped")
    p.add_argument("--model", "-m", default=None,
                   help="tiny|base|small|medium|large-v2|large-v3|large-v3-turbo")
    p.add_argument("--language", "-l", default=None)
    p.add_argument("--translate", action="store_true")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--random-init", action="store_true",
                   help="run with random weights when no checkpoint exists "
                        "(smoke tests only)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--draft", default=None, metavar="MODEL",
                   help="speculative decoding draft (e.g. large-v3-turbo "
                        "for large-v3); token-exact, speed only; one file "
                        "only")
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
    from openhush_tpu_torch.utils.config import Config

    files = args.file
    for f in files:
        if not os.path.exists(f):
            print(f"File not found: {f}", file=sys.stderr)
            return 1
    fmt = args.format.lower()
    config = Config.load_or_default()
    model = args.model or config.transcription.effective_model()
    language = args.language or config.transcription.language

    t_load = time.monotonic()
    try:
        audios = [load_wav(f) for f in files]
    except (ValueError, OSError) as e:
        print(f"Cannot load audio: {e}", file=sys.stderr)
        return 1
    total_secs = sum(len(a) for a in audios) / 16000.0
    _progress(f"Loaded: {total_secs:.2f}s audio ({len(files)} file(s)) in "
              f"{(time.monotonic() - t_load) * 1000:.0f}ms")

    t_model = time.monotonic()
    try:
        engine = WhisperEngine(model, language=language,
                               translate=args.translate, dtype=args.dtype,
                               allow_random_init=args.random_init or
                               os.environ.get(
                                   "OPENHUSH_ALLOW_RANDOM_INIT") == "1",
                               draft_model=args.draft
                               or config.transcription.draft_model or None,
                               device=args.device)
    except (FileNotFoundError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    _progress(f"Model loaded: {model} on {engine.device} in "
              f"{(time.monotonic() - t_model) * 1000:.0f}ms")

    t0 = time.monotonic()
    if len(files) > 1:
        results = _transcribe_batch(engine, audios, args)
    else:
        results = [engine.transcribe(audios[0], language=args.language,
                                     translate=args.translate,
                                     beam_size=args.beam_size)]
    transcribe_s = time.monotonic() - t0

    payloads = []
    for path, audio, result in zip(files, audios, results):
        duration = len(audio) / 16000.0
        share = transcribe_s * duration / max(total_secs, 1e-9)
        if fmt == "json":
            # Key set parity: src/main.rs:1028-1036.
            payload = {
                "text": result.text,
                "language": result.language,
                "duration_ms": result.duration_ms,
                "audio_duration_secs": duration,
                "transcription_time_ms": int(share * 1000),
                "real_time_factor": share / max(duration, 1e-9),
                "model": model,
            }
            if len(files) > 1:
                payload = {"file": path, **payload}
            payloads.append(payload)
        elif fmt in ("srt", "vtt", "timestamped"):
            if len(files) > 1:
                print(f"# {path}")
            segs = [formats.TranscribedSegment(s.start, s.end, s.text.strip())
                    for s in result.segments]
            print(formats.render(segs, fmt), end="")
        else:
            header = f" {path} " if len(files) > 1 else " Transcription "
            print(f"\n---{header}---")
            print(result.text)
            print("---")
    if fmt == "json":
        print(json.dumps(payloads[0] if len(payloads) == 1 else payloads,
                         indent=2))
    elif fmt not in ("srt", "vtt", "timestamped"):
        _progress(f"Time: {transcribe_s * 1000:.0f}ms "
                  f"(RTF: {transcribe_s / max(total_secs, 1e-9):.3f}x)")
    return 0


def _transcribe_batch(engine, audios, args):
    """Several files through the continuous-batching server: every file
    runs its own seek loop, one window in flight per file, and the server
    batches the in-flight windows of different files into one decode
    step; with --beam-size, concurrent beam groups. The server runs
    without the engine's draft, as the reference's does."""
    from openhush_tpu_torch.runtime import longform

    server = longform.make_server(engine.cfg, engine.params,
                                  engine.tokenizer, n_files=len(audios),
                                  beam_size=args.beam_size,
                                  dtype=engine.dtype)
    return longform.transcribe_files(
        server, audios, language=args.language or engine.language or "auto",
        task="translate" if args.translate else "transcribe")


def build_parser() -> argparse.ArgumentParser:
    from openhush_tpu_torch import __version__
    from openhush_tpu_torch.runtime.daemon_cli import SUBCOMMANDS
    p = argparse.ArgumentParser(
        prog="openhush-torch",
        description="Whisper transcription on the GPU (PyTorch/CUDA port)")
    p.add_argument("--version", action="version",
                   version=f"openhush-tpu-torch {__version__}")
    p.add_argument("--verbose", "-v", action="count", default=0)
    sub = p.add_subparsers(dest="command")
    _add_transcribe(sub)
    for name, helptext, _ in SUBCOMMANDS:
        sub.add_parser(name, help=helptext, add_help=False,
                       prefix_chars="\x00").add_argument(
            "args", nargs=argparse.REMAINDER)
    return p


def _setup_logging(verbose: int) -> None:
    """Priority: OPENHUSH_LOG > --verbose count > the config file's
    logging.level (the reference's utils/tracing.setup_logging)."""
    import logging

    level = os.environ.get("OPENHUSH_LOG")
    if not level:
        if verbose:
            level = "debug" if verbose >= 2 else "info"
        else:
            from openhush_tpu_torch.utils.config import Config
            try:
                level = Config.load_or_default().logging.level
            except Exception:  # noqa: BLE001 — a broken file must not stop
                level = "info"
    numeric = getattr(logging, str(level).upper(), logging.INFO)
    logging.basicConfig(
        level=numeric,
        format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")
    logging.getLogger().setLevel(numeric)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _setup_logging(args.verbose)
    if args.command == "transcribe":
        return cmd_transcribe(args)
    if args.command is None:
        parser.print_help()
        return 0
    from openhush_tpu_torch.runtime import daemon_cli
    return daemon_cli.dispatch(args.command, args.args)


def run() -> None:
    sys.exit(main())


if __name__ == "__main__":
    run()
