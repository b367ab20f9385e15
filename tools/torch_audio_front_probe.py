"""Check and time the audio front of the PyTorch port on one GPU.

    python3 tools/torch_audio_front_probe.py [--dsp-only]

Builds the port's kernels, then runs chip_smoke.py's two audio-front
phases alone: the three DSP recurrences of csrc/dsp.cu against their plain
versions (the envelope and the limiter's gain on a 30 s window and a 5 s
chunk, the noise floor on [3000, 22]: bits, two launches, times, bounds;
the envelope and the limiter's gain also on the hard inputs, against the
plain version at 48,037 and 300 samples and against the serial walk at
30 s, each time beside the serial walk's), and, unless --dsp-only, the daemon's audio front on large-v3 bf16 random
weights (build_preprocess card against CPU, a server with the preprocess,
the VAD engines, Silero and the wake-word detector card against CPU, host
wall and device time per chunk and window). About 80 s of command with
--dsp-only, 3 min without. Prints the card's name and power limit first.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_audio_front_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from openhush_tpu_torch.models import silero, vad, wakeword
    from openhush_tpu_torch.ops import (_build, decode_attention, denoise,
                                        dsp, flash_attention, frontend,
                                        quantize)
    from openhush_tpu_torch.runtime import daemon, longform
    from openhush_tpu_torch.runtime.engine import WhisperEngine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t = time.monotonic()
    _build.library()
    print(f"build {time.monotonic() - t:.1f} s", flush=True)
    t = time.monotonic()
    for r in cs.phase_dsp_kernels(dsp, denoise):
        print({k: v for k, v in r.items() if k != "counter"})
    print(f"DSP kernels {time.monotonic() - t:.1f} s", flush=True)
    if "--dsp-only" in sys.argv:
        return 0
    t = time.monotonic()
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    counters = [frontend.log_mel_energies, flash_attention.flash_attention,
                quantize.quantize_heads_kv, decode_attention.attend_decode,
                decode_attention.attend_decode_pipelined]
    launches = cs.phase_audio_front(eng, longform, dsp, denoise, daemon, vad,
                                    silero, wakeword, counters)
    print(f"audio front {time.monotonic() - t:.1f} s; DSP launches in the "
          f"server run {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
