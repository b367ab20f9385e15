"""Phase 4e's beam servers for two trees of the port, in turns, on one GPU:
chip_smoke.py's phase_serving with beam_size=5 (large-v3 on the engine's
random bf16 weights, int8 cross-KV, BEAM_GROUPS = 4 groups on the 5-45 s
requests of BEAM_SECS), once with a bf16 self-cache and once with an int8
one, each twice in a process (the first run of a process pays its warmup).

    python3 tools/torch_beam_server_probe.py [--parent DIR]

DIR is another checkout of the repo (for example the parent commit's, from
`git archive`). Each run is a process of its own that imports the port
from its tree and this tree's chip_smoke.py for the harness, so both sides
are measured by the same code; with --parent the order is parent, this
tree, this tree, parent. Each process builds its tree's kernels at first
use (the build is kept in that tree's openhush_tpu_torch/build/). Prints
the card's name and power limit, every run's phase_serving lines prefixed
by its tree, then a table: x-realtime of transcribe_files, host wall per
grouped beam step with every group busy (untraced), and device busy per
step and the idle share from the traced dispatch. Needs one GPU; exits 1
without one.
"""

import argparse
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATTERNS = {
    "x_realtime": r"= ([0-9.]+)x realtime;",
    "host_ms_per_step": r"busy beam groups: ([0-9.]+) ms host wall per decode step",
    "busy_ms_per_step": r"= ([0-9.]+) ms/step, device idle share",
    "idle_share": r"device idle share ([0-9.]+)",
}


def child(tree: Path) -> int:
    """One process: the two beam servers, twice each, on `tree`'s port."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from openhush_tpu_torch.models.whisper import model as whisper
    from openhush_tpu_torch.ops import decode_attention as da
    from openhush_tpu_torch.ops import flash_attention, frontend, quantize
    from openhush_tpu_torch.runtime import longform
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    import openhush_tpu_torch
    cs.log(f"the port from {Path(openhush_tpu_torch.__file__).parent}")
    counters = [frontend.log_mel_energies, flash_attention.flash_attention,
                quantize.quantize_heads_kv, da.attend_decode, da.attend_decode_pipelined,
                da.attend_decode_beam]
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    n_layer = eng.cfg.n_text_layer
    for int8_self in (False, True, False, True):
        cs.log(f"== {'int8' if int8_self else 'bf16'} self-cache")
        cs.phase_serving(eng, longform, whisper, counters, n_layer,
                         int8_self_cache=int8_self, beam_size=cs.BEAM)
    return 0


def run(label: str, tree: Path) -> list[dict]:
    """Runs a child on `tree`, relays its lines, and returns each server
    run's numbers in order."""
    p = subprocess.run([sys.executable, __file__, "--tree", str(tree)], capture_output=True,
                       text=True)
    runs = []
    for line in p.stdout.splitlines():
        print(f"[{label}] {line}", flush=True)
        if line.startswith("== "):
            runs.append({"self_cache": line[3:7]})
        for key, pat in PATTERNS.items():
            m = re.search(pat, line)
            if m and runs and key not in runs[-1]:
                runs[-1][key] = float(m.group(1))
    if p.returncode:
        print(p.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"{label}: the run on {tree} exited {p.returncode}")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout of the repo, run in turns with this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_beam_server_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        return child(Path(args.tree))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    trees = [("as is", ROOT)]
    if args.parent:
        parent = ("parent", Path(args.parent).resolve())
        trees = [parent, trees[0], trees[0], parent]
    table = [(label, i, r) for label, tree in trees
             for i, r in enumerate(run(label, tree))]
    print("tree     run  self-cache  x-realtime  host ms/step  busy ms/step  idle share")
    for label, i, r in table:
        print(f"{label:8s} {i:3d}  {r['self_cache']:10s}  "
              + "  ".join(f"{r.get(k, float('nan')):10.4f}" for k in PATTERNS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
