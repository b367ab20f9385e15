"""Probe of the port's W8A8 encoder kernels (csrc/w8a8.cu: the per-row
quantize and the int8 product with its epilogue) on one GPU.

    python3 tools/torch_w8a8_probe.py [--alone] [--big] [--encoder]
                                      [--variant FILE] [--unchecked]

Prints the card's name and power limit and ptxas's registers and spills
for the W8A8 kernels, then runs chip_smoke.phase_w8a8: each kernel held to
its plain version at the encoder layer's shapes (1500 and 12000 rows on
large-v3 in bf16, tiny's widths in fp32), timed beside the plain version,
the bound and torch._int_mm with its folds. --alone builds csrc/w8a8.cu by
itself (nvcc alone, seconds, into the git-ignored
openhush_tpu_torch/build/probe/) instead of the whole kernel library
(~50 s). --big also times every shape at 48000 rows (B = 32 windows),
after holding each output to the plain version. --encoder (the whole
library: the encoder's attention is K2) then prints the large-v3
encoder's device busy time a 30 s window at B = 1, 8 and 32, W8A8 against
bf16 on the same random weights, with each one's top kernels. --variant
FILE (repeatable) builds a hand-changed copy of w8a8.cu with the same
entry points the same way, holds its products and quantizes at every
bf16 phase-2 shape to this tree's bits (the layer-norm quantize within a
level on 1e-3; --unchecked skips that, for timing builds that compute
something else) and times the two in turns (this, variant, variant,
this).
Needs one GPU; exits 1 without one.
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
from openhush_tpu_torch.ops import _build, w8a8  # noqa: E402

OUT = _build.BUILD_DIR / "probe"


def build_alone(src: Path, name: str) -> ctypes.CDLL:
    """One source built into its own library under OUT (_build.build_one)."""
    return _build.build_one(src, name, OUT, "oh_w8a8_")


def big(M=48000):
    """Every W8A8_PRODUCTS shape and W8A8_QUANTIZES shape at M rows in
    bf16: held to the plain version (the product's bits, GELU within one
    ulp; the quantize's bits, with the layer norm levels within one), timed
    beside the plain version, torch._int_mm with its folds and the
    bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 131)
    dt = torch.bfloat16
    for name, D, has_ln in chip_smoke.W8A8_QUANTIZES:
        ln = ((1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dt),
              (0.1 * torch.randn(D, generator=g, device=dev)).to(dt)
              ) if has_ln else None
        x = chip_smoke.w8a8_rows(M, D, dt, g)
        chip_smoke.check_w8a8_quantize(
            w8a8, f"quantize {name} [{M}, {D}]", x, ln)
        ms = chip_smoke.time_ms(lambda: w8a8.quantize_rows(x, ln), 6, 1)
        plain_ms = chip_smoke.time_ms(
            lambda: w8a8.quantize_rows_plain(x, ln), 6, 1)
        bound, _ = chip_smoke.bound_ms(3 * M * D + 4 * M, 0, "bf16")
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound * 1e3:.3f} us (bytes)", flush=True)
    for name, I, O, biases, gelu, has_res in chip_smoke.W8A8_PRODUCTS:
        n = len(biases)
        ws = []
        for _ in range(n):
            w = whisper._quantize_weight(0.05 * torch.randn(
                I, O, generator=g, device=dev))
            w["q"] = w["q"].t().contiguous().t()
            ws.append(w)
        bs = [(0.5 * torch.randn(O, generator=g, device=dev)).to(dt)
              if b else None for b in biases]
        x8, xs = w8a8.quantize_rows_plain(chip_smoke.w8a8_rows(M, I, dt, g))
        res = (torch.randn(M, O, generator=g, device=dev).to(dt)
               if has_res else None)
        if n > 1:
            run = functools.partial(w8a8.mm_w8a8_group, x8, xs,
                                    list(zip(ws, bs)), out_dtype=dt)
            plain = functools.partial(w8a8.mm_w8a8_group_plain, x8, xs,
                                      list(zip(ws, bs)), out_dtype=dt)
            ok = all(torch.equal(a, b) for a, b in zip(run(), plain()))
        else:
            kw = dict(bias=bs[0], gelu=gelu, residual=res, out_dtype=dt)
            run = functools.partial(w8a8.mm_w8a8, x8, xs, ws[0], **kw)
            plain = functools.partial(w8a8.mm_w8a8_plain, x8, xs, ws[0], **kw)
            y, p = run(), plain()
            ok = bool(((y.float() - p.float()).abs()
                       <= chip_smoke.ulp_at(p, dt)).all()) if gelu else \
                torch.equal(y, p)
        chip_smoke.check(ok, f"{name} at {M} rows")
        x2 = x8.reshape(-1, I)
        lib = lambda: [torch._int_mm(x2, w["q"]).float() * xs[:, None]
                       * w["s"] for w in ws]
        ms, plain_ms, lib_ms = (chip_smoke.time_ms(f, 6, 1)
                                for f in (run, plain, lib))
        bound, by = chip_smoke.bound_ms(
            M * I + n * (I * O + 2 * M * O), n * 2 * M * I * O, "int8")
        print(f"  {name} [{M}, {I}] x {n} x [{I}, {O}]: the plain "
              f"version's {'bits' if not gelu else 'values within an ulp'}; "
              f"kernel {ms:.4f} ms ({n * 2 * M * I * O / ms / 1e9:.1f} "
              f"TOP/s), plain {plain_ms:.4f} ms, _int_mm + folds "
              f"{lib_ms:.4f} ms; bound {bound * 1e3:.3f} us ({by})",
              flush=True)


def compare(variants, checked=True):
    """Each variant against this tree's kernels at every bf16 phase-2
    shape: the same outputs (the layer-norm quantize's levels within one
    on 1e-3), then times in turns (this, variant, variant, this)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 132)
    dt = torch.bfloat16
    base = _build._lib

    def turns(fn, lib):
        times = []
        for which in (base, lib, lib, base):
            _build._lib = which
            times.append(chip_smoke.time_ms(fn, 6, 1))
        _build._lib = base
        return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2

    for M in chip_smoke.W8A8_MS:
        for name, D, has_ln in chip_smoke.W8A8_QUANTIZES:
            ln = ((1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dt),
                  (0.1 * torch.randn(D, generator=g, device=dev)).to(dt)
                  ) if has_ln else None
            x = chip_smoke.w8a8_rows(M, D, dt, g)
            ours = w8a8.quantize_rows(x, ln)
            line = f"  quantize {name} [{M}, {D}]:"
            for vname, lib in variants:
                _build._lib = lib
                theirs = w8a8.quantize_rows(x, ln)
                _build._lib = base
                d = (ours[0].int() - theirs[0].int()).abs()
                chip_smoke.check(not checked or d.max().item() <= 1 and (
                    (d > 0).float().mean().item() <= 1e-3) and (
                    has_ln or torch.equal(ours[0], theirs[0])),
                    f"{vname} quantize {name} at {M}")
                a, b = turns(lambda: w8a8.quantize_rows(x, ln), lib)
                line += f" this {a:.4f} ms, {vname} {b:.4f} ms;"
            print(line, flush=True)
        for name, I, O, biases, gelu, has_res in chip_smoke.W8A8_PRODUCTS:
            ws = []
            for _ in biases:
                w = whisper._quantize_weight(0.05 * torch.randn(
                    I, O, generator=g, device=dev))
                w["q"] = w["q"].t().contiguous().t()
                ws.append(w)
            bs = [(0.5 * torch.randn(O, generator=g, device=dev)).to(dt)
                  if b else None for b in biases]
            x8, xs = w8a8.quantize_rows_plain(chip_smoke.w8a8_rows(M, I, dt,
                                                                   g))
            res = (torch.randn(M, O, generator=g, device=dev).to(dt)
                   if has_res else None)
            if len(ws) > 1:
                run = functools.partial(w8a8.mm_w8a8_group, x8, xs,
                                        list(zip(ws, bs)), out_dtype=dt)
            else:
                run = functools.partial(w8a8.mm_w8a8, x8, xs, ws[0],
                                        bias=bs[0], gelu=gelu, residual=res,
                                        out_dtype=dt)
            ours = run()
            ours = ours if isinstance(ours, tuple) else (ours,)
            n = len(ws)
            line = f"  {name} [{M}, {I}] x {n} x [{I}, {O}]:"
            for vname, lib in variants:
                _build._lib = lib
                theirs = run()
                _build._lib = base
                theirs = theirs if isinstance(theirs, tuple) else (theirs,)
                chip_smoke.check(not checked or all(torch.equal(a, b) for a, b in zip(
                    ours, theirs)), f"{vname} {name} at {M}")
                a, b = turns(run, lib)
                line += (f" this {a:.4f} ms ({n * 2 * M * I * O / a / 1e9:.0f}"
                         f" TOP/s), {vname} {b:.4f} ms "
                         f"({n * 2 * M * I * O / b / 1e9:.0f} TOP/s);")
            print(line, flush=True)


def encoder(batches=(1, 8, 32)):
    """The large-v3 encoder's device busy time a window, W8A8 against bf16,
    at each batch, with the top kernels of each."""
    from torch.profiler import ProfilerActivity, profile
    from openhush_tpu_torch.models.whisper import weights
    from openhush_tpu_torch.models.whisper.config import get_config
    from openhush_tpu_torch.ops import frontend
    cfg = get_config("large-v3")
    params = weights.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        chip_smoke.SEED), torch.bfloat16)
    p8 = whisper.quantize_encoder_weights(params)
    audio = torch.from_numpy(chip_smoke.speechlike(30.0, chip_smoke.SEED + 5)
                             ).cuda()[None]
    mel1 = frontend.log_mel(audio, cfg.n_mels).to(torch.bfloat16)
    with torch.inference_mode():
        for B in batches:
            m = mel1.expand(B, -1, -1).contiguous()
            for name, p in (("bf16", params), ("W8A8", p8)):
                whisper.encode(cfg, p, m)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    whisper.encode(cfg, p, m)
                    torch.cuda.synchronize()
                busy, by_name = chip_smoke.device_time(prof)
                print(f"  encoder B={B} {name}: device busy "
                      f"{busy / 1e3:.3f} ms a call, {busy / 1e3 / B:.3f} ms "
                      f"a window", flush=True)
                for k, us in sorted(by_name.items(), key=lambda kv: -kv[1]
                                    )[:6]:
                    print(f"    {us / busy:6.1%}  {us / 1e3:8.3f} ms  "
                          f"{k[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alone", action="store_true")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--encoder", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_w8a8_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.alone and args.encoder:
        print("torch_w8a8_probe: --encoder needs the whole library (K2), "
              "not --alone", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.alone:
        _build._lib = build_alone(_build.CSRC / "w8a8.cu", "w8a8")
    else:
        t = time.monotonic()
        so = _build.build()
        _build.library()
        print(f"library built in {time.monotonic() - t:.1f} s")
        log = Path(str(so) + ".log").read_text()
        section = log[log.index("== w8a8.cu"):].split("\n== ")[0]
        for line in section.splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "Performance Loss", "Compiling")):
                print("  " + line.strip())
    t = time.monotonic()
    chip_smoke.phase_w8a8(w8a8, whisper)
    print(f"phase_w8a8: {time.monotonic() - t:.1f} s", flush=True)
    if args.variant:
        compare([(Path(v).name, build_alone(Path(v), f"variant{i}"))
                 for i, v in enumerate(args.variant)], not args.unchecked)
    if args.big:
        big()
    if args.encoder:
        encoder()
    return 0


if __name__ == "__main__":
    sys.exit(main())
