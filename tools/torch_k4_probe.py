"""Probe of the port's K4 kernel (openhush_tpu_torch/csrc/decode_attention.cu:
the decode step's self-attention, one CTA per (head, query, row)) on one GPU,
at the decode step's shapes: large-v3, 20 heads, bf16 cache of T = 128 rows,
batch 8 with per-row lengths (the serving step) and batch 1 with 100 visible
keys (the one-shot step).

    python3 tools/torch_k4_probe.py [--parent FILE]
    python3 tools/torch_k4_probe.py --beam [--parent FILE]

Prints the card's name and power limit, then K4's time as the source stands
and for diagnostic builds whose outputs are wrong on purpose, each cut short
after one part of the kernel's chain:
  - "return at entry": the launch alone (the CTA writes zeros and returns);
  - "loads only": the query, K's and V's rows asked for and waited on;
  - "scores only": the loads, then the scores of the K rows;
  - "softmax, no values": everything up to the probs, no value sum.
With --parent, the same times for another copy of decode_attention.cu (for
example the parent commit's, from `git show`), in turns with this one.
With --beam, K4's beam mode instead, at chip_smoke.py's phase 2 shapes
(K = 5 beams, G=4 groups over T=128 positions and G=1 over T=448, bf16 and
int8 caches, random-parent ancestries, each through its source-row
table), this source and, with --parent, the other in turns, both through
ops/decode_attention.py's attend_decode_beam (so the other source must
take the same source-row table); the two outputs are held within 1e-2 of
each other.
Every time is the mean device time of 64 launches (chip_smoke.time_ms), each
on another of 32 copies of the cache (cold in the 50 MB L2). Each build is
nvcc alone into a shared library under the git-ignored
openhush_tpu_torch/build/probe/, loaded with ctypes in place of the port's
library. Needs one GPU; exits 1 without one.
"""

import argparse
import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openhush_tpu_torch.ops import _build  # noqa: E402
from openhush_tpu_torch.ops import decode_attention as da  # noqa: E402
from openhush_tpu_torch.ops import quantize  # noqa: E402

OUT = _build.BUILD_DIR / "probe"
SRC = _build.CSRC / "decode_attention.cu"
STOP = ("    if (threadIdx.x < HEAD_DIM) store_f32(out + qo_off + threadIdx.x, 0.f);\n"
        "    return;\n")
# Where each diagnostic build stops: a line of K4's kernel, and what goes
# before it.
CUTS = {
    "return at entry": ("  const long long row0 = (long long)b * (BEAM ? S : 1) * T;",
                        "  {\n" + STOP + "  }\n"),
    "loads only": ("  // -- the query, in this warp's copy:",
                   "  {\n    cp_async_wait<0>();\n    __syncthreads();\n"
                   "    if (qa + qb == 1e30f) store_f32(out + qo_off, 1.f);\n"
                   + STOP + "  }\n"),
    "scores only": ("  // -- softmax (fp32): each warp over its own rows",
                    "  {\n    __syncthreads();\n"
                    "    if (lmax == 1e30f) store_f32(out + qo_off, 1.f);\n"
                    + STOP + "  }\n"),
    "softmax, no values": ("  // -- values: each thread sums its 16 B of columns",
                           "  {\n    __syncthreads();\n"
                           "    if (sc[0] == 1e30f) store_f32(out + qo_off, 1.f);\n"
                           + STOP + "  }\n"),
}


def build(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_").replace(",", "")
    src, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    src.write_text(text)
    r = subprocess.run([_build.nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                        "-fPIC", "-shared", "-I", str(_build.CSRC), str(src), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.oh_decode_attention.argtypes = _build.SIGNATURES["oh_decode_attention"]
    lib.oh_decode_attention.restype = ctypes.c_int
    return lib


def beam(libs: dict) -> None:
    """K4's beam mode of each library, in turns, at phase 2's shapes."""
    dev, H, D, K, L = "cuda", 20, 64, chip_smoke.BEAM, 32
    g = torch.Generator(device=dev).manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    cases = {}
    for G, T in ((4, 128), (1, 448)):
        pos = torch.randint(chip_smoke.PROMPT_LEN, T, (G,), generator=gen)
        mask = chip_smoke.beam_masks(G, K, T, pos, gen)
        rows = da.ancestry_rows(mask)
        lengths = (pos + 1).to(device=dev, dtype=torch.int32)
        q, kf, vf = rnd(G, K, H * D), rnd(G, K * T, H * D), rnd(G, K * T, H * D)
        k8, v8 = (torch.empty(G, K * T, H * D, dtype=torch.int8, device=dev)
                  for _ in range(2))
        ks, vs = (torch.empty(G, K * T, H, device=dev) for _ in range(2))
        quantize.quantize_heads_kv(kf, vf, H, (k8, ks, v8, vs))
        for mode, (k, v, kw) in (("bf16", (kf, vf, {})),
                                 ("int8", (k8, v8, dict(ks=ks, vs=vs)))):
            layers = [(k.clone(), v.clone(), {n: t.clone() for n, t in kw.items()})
                      for _ in range(L)]
            cases[f"{mode} G={G} T={T}"] = (q, rows, lengths, layers)
    outs = {}
    order = list(libs) + list(libs)[::-1]
    times = {name: {c: [] for c in cases} for name in libs}
    for name in order:
        _build._lib = libs[name]
        for c, (q, rows, lengths, layers) in cases.items():
            calls = [functools.partial(da.attend_decode_beam, q, k, v, rows, lengths, H, **kw)
                     for k, v, kw in layers]
            outs[name, c] = calls[0]()
            times[name][c].append(chip_smoke.time_ms(chip_smoke.rotate(calls), iters=2 * L))
    torch.cuda.synchronize()
    for name in libs:
        print(f"{name:8s} " + "  ".join(
            f"{c} {min(t):.4f} ms (of {', '.join(f'{x:.4f}' for x in t)})"
            for c, t in times[name].items()))
    if "parent" in libs:
        for c in cases:
            e = (outs["parent", c].float() - outs["as is", c].float()).abs().max().item()
            print(f"{c}: this source's output against the parent's, max_abs_err {e:.3e}")
            if not e <= 1e-2:
                raise RuntimeError(f"{c}: this source and the parent disagree by {e}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another decode_attention.cu to time in turns")
    ap.add_argument("--beam", action="store_true", help="time K4's beam mode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    text = SRC.read_text()
    if args.beam:
        sources = {"as is": text}
        if args.parent:
            sources["parent"] = Path(args.parent).read_text()
        beam({name: build(name, src) for name, src in sources.items()})
        return 0
    sources = {"as is": text}
    for name, (line, before) in CUTS.items():
        if text.count(line) != 1:
            raise RuntimeError(f"{name}: the cut's line is not in the source once")
        sources[name] = text.replace(line, before + line)
    if args.parent:
        sources["parent"] = Path(args.parent).read_text()
    libs = {name: build(name, src) for name, src in sources.items()}

    dev, H, D, T, L = "cuda", 20, 64, 128, 32
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    q = rnd(8, 1, H * D)
    lengths = (torch.randint(0, T, (8,), generator=g, device=dev) + 1).to(torch.int32)
    layers = [(rnd(8, T, H * D), rnd(8, T, H * D)) for _ in range(L)]
    shapes = {"B=8": (q, lengths, layers),
              "B=1, 100 keys": (q[:1], torch.tensor([100], dtype=torch.int32, device=dev),
                                [(k[:1].clone(), v[:1].clone()) for k, v in layers])}
    order = list(libs) + list(libs)[::-1]          # in turns, then back
    times = {name: {s: [] for s in shapes} for name in libs}
    for name in order:
        _build._lib = libs[name]
        for s, (qs, lens, kv) in shapes.items():
            times[name][s].append(chip_smoke.time_ms(chip_smoke.rotate([
                functools.partial(da.attend_decode, qs, k, v, lens, H, causal=True)
                for k, v in kv]), iters=2 * L))
    for name in libs:
        print(f"{name:20s} " + "  ".join(
            f"{s} {min(t):.4f} ms (of {', '.join(f'{x:.4f}' for x in t)})"
            for s, t in times[name].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
