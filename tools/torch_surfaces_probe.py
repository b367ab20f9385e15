"""Run the dictation daemon's and `record`'s phases of chip_smoke.py alone,
on one GPU.

    python3 tools/torch_surfaces_probe.py [--record-only]
    python3 tools/torch_surfaces_probe.py --daemon-only [--repeat N]

Builds the port's kernels, then runs chip_smoke.py's phase 10 (the daemon
at large-v3 over IPC, the REST API, D-Bus where dbus-daemon is on PATH and
F2's pair of presses; then `start` as a subprocess) and phase 11 (`record
--diarize` on 45 s of two synthetic speakers in a subprocess, its windows
held to a plain server's and its speakers to the diarizer's, then an
in-process repeat under a trace), with the K1-K5 launches each read.
About 4 min of command (phase 11 alone, --record-only: about 1.5 min).
--daemon-only runs phase 10 alone, N times in one process with --repeat
(about 2.5 min a run): each run holds the daemon's outputs to the
tracker's replay of its drains, the check a run that failed there logs.
Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_surfaces_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from openhush_tpu_torch import cli
    from openhush_tpu_torch.audio import capture
    from openhush_tpu_torch.models import diarization
    from openhush_tpu_torch.ops import (_build, decode_attention, dsp,
                                        flash_attention, frontend, quantize)
    from openhush_tpu_torch.runtime import daemon, ipc, recording
    from openhush_tpu_torch.runtime import server as server_mod
    from openhush_tpu_torch.text import tokenizer
    from openhush_tpu_torch.training import speaker

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record-only", action="store_true", help="phase 11 alone")
    ap.add_argument("--daemon-only", action="store_true", help="phase 10 alone")
    ap.add_argument("--repeat", type=int, default=1, help="runs of phase 10")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t = time.monotonic()
    _build.library()
    print(f"build {time.monotonic() - t:.1f} s", flush=True)
    counters = [frontend.log_mel_energies, flash_attention.flash_attention,
                quantize.quantize_heads_kv, decode_attention.attend_decode,
                decode_attention.attend_decode_pipelined]
    for run in range(0 if args.record_only else args.repeat):
        t = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            launches = cs.phase_daemon(daemon, ipc, server_mod, tokenizer,
                                       capture, cli,
                                       counters + [dsp.limiter_gain], tmp)
        print(f"phase 10 dictation daemon (run {run + 1} of {args.repeat}): "
              f"{time.monotonic() - t:.1f} s; launches {launches}", flush=True)
    if args.daemon_only:
        return 0
    t = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        launches = cs.phase_record(recording, diarization, speaker, counters,
                                   tmp)
    print(f"phase 11 record: {time.monotonic() - t:.1f} s; launches "
          f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
