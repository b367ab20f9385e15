"""Run chip_smoke.py's phase 13 (multi-device) alone, on the GPU.

    python3 tools/torch_multichip_probe.py

Builds the port's kernels, then runs phase 13: dryrun_multichip(8) (a 4x2
mesh with every serving and training stage, then the 1x2 and 2x2
sub-meshes, each held to a mesh of one rank), K2-K7 at a 1x2 rank's 10
heads against their plain versions, and large-v3 at full width on a 1x2
mesh against one rank (30 s of audio through K1-K5 and 32 greedy batcher
steps, the first step's logits under a fixed limit that a control with the
row-parallel biases counted twice must fail, one fp32 train step through
K2's residual mode, K6 and K7), with the launch counts, walls,
all-reduces and peak memory of each rank. The ranks are processes of their own: NCCL with a card a rank where
there are enough cards, else gloo with all of them on one card. About 2
min of command. Prints the card's name and power limit first.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_multichip_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.ops import _build
    from openhush_tpu_torch.parallel import dryrun, world

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t = time.monotonic()
    _build.library()
    print(f"build {time.monotonic() - t:.1f} s", flush=True)
    t = time.monotonic()
    launches = cs.phase_multichip(dryrun, world, get_config)
    print(f"phase 13 multichip: {time.monotonic() - t:.1f} s; launches "
          f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
