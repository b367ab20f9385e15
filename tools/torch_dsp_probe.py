"""Check and time csrc/dsp.cu's segment kernels (the compressor's envelope,
the limiter's gain) on one GPU.

    python3 tools/torch_dsp_probe.py [--variant FILE ...] [--cycles]

Builds this tree's csrc/dsp.cu alone (nvcc, sm_90a, the flags of
ops/_build.py: a few seconds) and each --variant FILE (a hand-changed copy
with the same extern "C" entry points), all at once. Runs chip_smoke.py's
DSP inputs (speech-like audio at 4x, 30 s and 5 s; the eight hard inputs at
30 s) through every build, holds each output to this tree's serial walk
(oh_*_serial) bit for bit, and times the builds in turns (this tree, the
variants, the variants, this tree; each build's lower time). With --cycles
it also builds a copy of this tree's dsp.cu with clock64 reads in
summary_kernel and prints, for the 30 s window, each phase's cycles (the
staging, the hull constants and row pass, the low and the high walks) and
the walks' cycles a step. Prints the card's name and power limit first.
About a minute of command.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("oh_envelope", "oh_limiter_gain", "oh_envelope_serial",
           "oh_limiter_gain_serial", "oh_dsp_scratch_floats")

# clock64 reads in summary_kernel: (anchor, text put after it).
CYCLE_PATCHES = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "__device__ long long g_cycles[8][64][4];\n"),
    ("  pdl_trigger();\n  init_bar(&bar);\n",
     "  const long long t0 = clock64();\n"),
    ("  stage_rows(sm, x + (long long)sig * n, n, j0, k1, aligned, &bar);\n"
     "  __syncthreads();\n",
     "  const long long t1 = clock64();\n"),
    ("    if (r >= k0) run[r] = same;\n  }\n  __syncthreads();\n",
     "  const long long t2 = clock64();\n"),
    ("    ends[warp][lane] = s;\n  }\n",
     "  if (blockIdx.x < 8) {\n"
     "    long long* c = g_cycles[blockIdx.x][threadIdx.x];\n"
     "    c[0] = t1 - t0, c[1] = t2 - t1, c[2] = clock64() - t2;\n"
     "  }\n"),
]
CYCLE_ENTRY = """
extern "C" int oh_dsp_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
}
"""


def with_cycles(src: str) -> str:
    for anchor, text in CYCLE_PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"--cycles: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + CYCLE_ENTRY


def build_all(sources, out_dir):
    """Compile each .cu into a shared library, all at once; return the
    loaded libraries."""
    from openhush_tpu_torch.ops import _build
    procs = []
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"dsp{i}.so")
        procs.append((src, so, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-shared", src,
             "-o", so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for src, so, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
        lib = ctypes.CDLL(so)
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = _build.RESTYPES.get(name, ctypes.c_int)
        libs.append(lib)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_dsp_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--cycles", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from openhush_tpu_torch.ops import denoise, dsp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    tree = os.path.join(ROOT, "openhush_tpu_torch", "csrc", "dsp.cu")
    with tempfile.TemporaryDirectory() as tmp:
        sources = [tree] + args.variant
        if args.cycles:
            cyc = os.path.join(tmp, "dsp_cycles.cu")
            with open(tree) as f, open(cyc, "w") as g:
                g.write(with_cycles(f.read()))
            sources.append(cyc)
        libs = build_all(sources, tmp)
        names = ["this tree"] + args.variant + (["cycles"] if args.cycles
                                                 else [])
        att, rel = dsp.smoothing_coeff(5.0), dsp.smoothing_coeff(50.0)
        rc = dsp.smoothing_coeff(50.0)

        def run(lib, kind, x, serial=False):
            x = x.contiguous()
            y = torch.empty_like(x)
            n, n_sig = x.shape[-1], x.numel() // x.shape[-1]
            st = torch.cuda.current_stream().cuda_stream
            coeffs = (att, rel) if kind == "envelope" else (rc,)
            name = "oh_envelope" if kind == "envelope" else "oh_limiter_gain"
            if serial:
                err = getattr(lib, name + "_serial")(
                    x.data_ptr(), y.data_ptr(), n, n_sig, *coeffs, st)
            else:
                scratch = torch.empty(lib.oh_dsp_scratch_floats(n, n_sig),
                                      device=x.device)
                err = getattr(lib, name)(x.data_ptr(), y.data_ptr(), n, n_sig,
                                         *coeffs, scratch.data_ptr(), st)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return y

        a30, tg30, _, _ = cs.dsp_inputs(dsp, denoise, 30.0, cs.SEED + 50)
        a5, tg5, _, _ = cs.dsp_inputs(dsp, denoise, 5.0, cs.SEED + 51)
        inputs = {"speech 30 s": (tg30, a30), "speech 5 s": (tg5, a5),
                  **cs.dsp_hard_inputs(dsp, 480000, cs.SEED + 54)}
        ok_all = True
        for label, (tg, a) in inputs.items():
            for kind, x in (("limiter_gain", tg), ("envelope", a)):
                ref = run(libs[0], kind, x, serial=True)
                same = [cs.same_bits(run(lib, kind, x), ref) for lib in libs]
                ok_all &= all(same)
                order = list(range(len(libs))) + list(
                    reversed(range(len(libs))))
                times = {i: [] for i in range(len(libs))}
                for i in order:
                    times[i].append(cs.time_ms(lambda: run(libs[i], kind, x),
                                               iters=10, warmup=2))
                serial_ms = cs.time_ms(lambda: run(libs[0], kind, x, True),
                                       iters=3, warmup=1)
                print(f"{kind}, {label}: the serial walk's bits "
                      f"{dict(zip(names, same))}; ms "
                      + ", ".join(f"{names[i]} {min(t):.4f}"
                                  for i, t in times.items())
                      + f" [serial walk {serial_ms:.4f}]", flush=True)

        if args.cycles:
            lib = libs[-1]
            lib.oh_dsp_cycles.argtypes = [ctypes.c_void_p]
            steps = {"limiter_gain": 9 * 512, "envelope": 17 * 512}
            for kind, x in (("limiter_gain", tg30), ("envelope", a30)):
                run(lib, kind, x)
                torch.cuda.synchronize()
                buf = np.zeros((8, 64, 4), np.int64)
                lib.oh_dsp_cycles(buf.ctypes.data)
                body = buf[1:]                  # CTAs whose lanes all warm
                low, high = body[:, 0:16, 2].max(), body[:, 32:48, 2].max()
                print(f"{kind}, 30 s, summary_kernel cycles (CTAs 1-7, most): "
                      f"staging {body[:, :, 0].max()}, constants and rows "
                      f"{body[:, :, 1].max()}, low walk {low} "
                      f"({low / steps[kind]:.1f} a step), high walk {high} "
                      f"({high / steps[kind]:.1f} a step)", flush=True)
    print("all bits equal" if ok_all else "BITS DIFFER")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
