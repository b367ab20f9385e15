"""Probe of the port's W8A16 kernel (csrc/w8a16.cu: the int8 decoder
weights' product) on one GPU.

    python3 tools/torch_w8a16_probe.py [--alone] [--host] [--variant FILE]
                                       [--unchecked] [--calls N]

Prints the card's name and power limit and ptxas's registers and spills
for the W8A16 kernels, then runs chip_smoke.phase_w8a16: every shape of
chip_smoke's phase 2 held to the tolerance helper and to itself over two
launches, timed beside the plain version, the cast-plus-mm pair, the bound
and torch._weight_int8pack_mm where the card's torch has it. --host first
prints the host microseconds a call of the dense bf16 product and bias
add, the plain version, the wrapper and the wrapper's parts, at the
one-shot's [1280, 1280] product.
--alone builds csrc/w8a16.cu by itself (nvcc alone, seconds, into the
git-ignored openhush_tpu_torch/build/probe/) instead of the whole kernel
library (~70-90 s). --variant FILE (repeatable) builds a hand-changed copy
of w8a16.cu with the same entry point the same way, checks it at every
bf16 shape against this tree's kernel (the tolerance helper, its own bits
over two launches; --unchecked skips that, for timing builds that compute
something else) and times the two in turns (this, variant, variant,
this) at each shape. --calls N instead times a large-v3 decoder call with
int8 decoder weights against one with bf16 weights, N times each in turns
(phase 4b's decode trace, the whole library built), and prints each
side's host and device medians. Needs one GPU; exits 1 without one.
"""

import argparse
import ctypes
import functools
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openhush_tpu_torch.models.whisper import model as whisper  # noqa: E402
from openhush_tpu_torch.ops import _build, w8a16  # noqa: E402

OUT = _build.BUILD_DIR / "probe"


def build_alone(src: Path, name: str) -> ctypes.CDLL:
    """nvcc of one source into its own library, loaded with the entry's
    argument types; ptxas's lines printed."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    t = time.monotonic()
    run = subprocess.run([_build.nvcc(), *_build.ARCH, *_build.FLAGS,
                          "-shared", str(src), "-o", str(so)],
                         capture_output=True, text=True)
    print(f"build {src.name} as {name}: rc {run.returncode} in "
          f"{time.monotonic() - t:.1f} s", flush=True)
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Function properties" in line or "Compiling" in line:
            print("  " + line.strip())
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {src}")
    lib = ctypes.CDLL(str(so))
    lib.oh_w8a16.argtypes = _build.SIGNATURES["oh_w8a16"]
    lib.oh_w8a16.restype = ctypes.c_int
    return lib


def compare(variants, checked=True):
    """Each variant against this tree's kernel at every bf16 shape of
    phase 2 (unless not `checked`: a timing build that computes something
    else), then in turns (this, variant, variant, this)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 121)
    base = _build._lib
    for I, O in chip_smoke.W8A16_SHAPES:
        ws = [whisper._quantize_weight(0.05 * torch.randn(
            I, O, generator=g, device=dev)) for _ in range(
            max(2, -(-int(64e6) // (I * O))))]
        for M in chip_smoke.W8A16_MS:
            x = torch.randn(M, I, generator=g, device=dev).to(torch.bfloat16)
            calls = chip_smoke.rotate([functools.partial(
                w8a16.mm_w8a16, x, w) for w in ws])
            ours = w8a16.mm_w8a16(x, ws[0])
            line = f"  [{M}, {I}] x [{I}, {O}]:"
            for name, lib in variants:
                _build._lib = lib
                y, again = (w8a16.mm_w8a16(x, ws[0]) for _ in range(2))
                torch.cuda.synchronize()
                ok, ratio = w8a16.within_tolerance(y, x, ws[0])
                if checked:
                    chip_smoke.check(ok and torch.equal(y, again),
                                     f"{name} at [{M}, {I}] x [{I}, {O}]")
                times = []
                for which in (base, lib, lib, base):
                    _build._lib = which
                    times.append(chip_smoke.time_ms(calls))
                _build._lib = base
                line += (f" this {(times[0] + times[3]) / 2:.4f} ms, {name} "
                         f"{(times[1] + times[2]) / 2:.4f} ms (equal to this: "
                         f"{torch.equal(y, ours)}, {ratio:.3f} of the "
                         f"tolerance);")
            print(line, flush=True)


def host_costs(n=2000):
    """Host microseconds a call at the one-shot's [1, 1, 1280] x [1280,
    1280] with a bias (no synchronisation inside the loop; the card keeps
    up): the dense bf16 product and bias add, the plain version, the
    wrapper, and the wrapper's parts."""
    dev = torch.device("cuda")
    x = torch.randn(1, 1, 1280, device=dev).to(torch.bfloat16)
    w = whisper._quantize_weight(torch.randn(1280, 1280, device=dev))
    b = torch.randn(1280, device=dev).to(torch.bfloat16)
    wd = torch.randn(1280, 1280, device=dev).to(torch.bfloat16)
    y = w8a16.mm_w8a16(x, w, b)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(), b.data_ptr(),
            y.data_ptr(), 1, 1280, 1280, 1, stream)
    parts = {
        "dense x @ w + b": lambda: x @ wd + b,
        "plain version": lambda: w8a16.mm_w8a16_plain(x, w, b),
        "mm_w8a16": lambda: w8a16.mm_w8a16(x, w, b),
        "  its checks": lambda: w8a16._check(x, w["q"], w["s"], b),
        "  torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "  torch._C._cuda_getCurrentRawStream": lambda: (
            torch._C._cuda_getCurrentRawStream(0)),
        "  new_empty": lambda: x.new_empty((1, 1, 1280)),
        "  the C entry alone": lambda: lib.oh_w8a16(*args),
    }
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        print(f"  host {name}: {us:.2f} us a call", flush=True)


def decoder_calls(pairs: int):
    """A large-v3 decoder call with int8 weights against one with bf16
    weights, on the host clock and the device's: phase 4b's decode trace
    (chip_smoke.phase_trace: 32 greedy calls untraced, then traced) of the
    bf16 engine and of the int8 one (int8 decoder weights and the W8A8
    encoder, as phase 4d), in turns (bf16, int8, int8, bf16, ...), `pairs`
    times each; then each side's median (for an even count the upper of
    the middle two)."""
    from openhush_tpu_torch.models.whisper import decoding
    from openhush_tpu_torch.ops import frontend
    from openhush_tpu_torch.runtime.engine import WhisperEngine
    eng = WhisperEngine("large-v3", dtype="bfloat16", allow_random_init=True)
    eng8 = WhisperEngine("large-v3", params=eng.params, quantize_weights=True,
                         quantize_encoder=True)
    got = {"bf16": [], "int8": []}
    for i in range(pairs):
        for name in (("bf16", "int8") if i % 2 == 0 else ("int8", "bf16")):
            call = chip_smoke.phase_trace(eng if name == "bf16" else eng8,
                                          decoding, whisper, frontend)
            got[name].append(call)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    for name, calls in got.items():
        host = [c["host_ms"] for c in calls]
        dev = [c["device_ms"] for c in calls if c["device_ms"] is not None]
        print(f"  {name} decoder call: host ms {['%.2f' % h for h in host]}, "
              f"median {med(host):.2f}; device ms median "
              f"{med(dev) if dev else 'not measured'}", flush=True)
    ratio = med([c["host_ms"] for c in got["int8"]]) / med(
        [c["host_ms"] for c in got["bf16"]])
    print(f"  int8 against bf16, median host wall a call: {ratio:.2f}x",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8a16_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--alone", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--unchecked", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--calls", type=int, default=0)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t = time.monotonic()
    if args.alone and not args.calls:
        _build._lib = build_alone(_build.CSRC / "w8a16.cu", "w8a16")
    else:
        so = _build.build()
        _build.library()
        print(f"library built in {time.monotonic() - t:.1f} s", flush=True)
        log = open(str(so) + ".log").read()
        part = log[log.index("== w8a16.cu"):]
        part = part[:part.index("\n== ") if "\n== " in part else None]
        for line in part.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
    if args.calls:
        decoder_calls(args.calls)
        return 0
    if args.host:
        host_costs()
    t = time.monotonic()
    chip_smoke.phase_w8a16(w8a16, whisper)
    print(f"phase_w8a16: {time.monotonic() - t:.1f} s", flush=True)
    if args.variant:
        compare([(Path(v).name, build_alone(Path(v), f"variant{i}"))
                 for i, v in enumerate(args.variant)],
                checked=not args.unchecked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
