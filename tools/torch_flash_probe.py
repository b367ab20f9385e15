"""Probe of the port's encoder flash-attention kernels on one GPU: K2 (the
forward, csrc/flash_attention_tc.cu, bf16 and fp32), K6 and K7 (the
backward, csrc/flash_attention_bwd_tc.cu) and the split pass of the fp32
kernels (csrc/flash_split.cu), at the large-v3 encoder's shapes (20 heads,
Dh=64, read through the [B, T, H*64] projection layout): fp32 at the
fine-tune's B=2, T=1500 and at B=1, T=333; bf16 at B=1, T=1500.

    python3 tools/torch_flash_probe.py [--parent DIR] [--variant DIR]

Prints the card's name and power limit; ptxas's registers and spills for
the flash kernels; each kernel's error against its plain version and
whether two launches give the same bits; then device times (mean of 20
launches, chip_smoke.time_ms): the split pass alone (three and four
operands), K2's fp32 residual and inference modes, K6 and K7 each with its
own split and on a split they share, one whole backward (one split, K6,
K7), SDPA's fp32 forward. With --parent DIR, a directory holding another
copy of csrc/ (for example the parent commit's, from `git archive`), its
kernels are built beside these (nvcc alone, one process a source, into the
git-ignored openhush_tpu_torch/build/probe/), K2's bf16 outputs of the two
are compared bit for bit, and the parent's K2 (bf16, fp32 residual mode),
K6 and K7 are timed in turns with this tree's (parent, this, this,
parent). With --variant DIR, a copy of this tree's csrc/ changed by hand
(the same entry points), the variant's K2 fp32, K6 and K7 are checked and
timed in turns with this tree's, through the same wrappers. Needs one GPU;
exits 1 without one.
"""

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openhush_tpu_torch.ops import _build  # noqa: E402
from openhush_tpu_torch.ops import flash_attention as fa  # noqa: E402

OUT = _build.BUILD_DIR / "probe"
H, D = 20, 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
# The parent's entry points (before the split pass had its own entry).
PARENT_SIGNATURES = {
    "oh_flash_attention": [_P] * 5 + [_I] * 4 + [_S, _F, _I, _P],
    "oh_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 4 + [_S, _F, _I, _P],
    "oh_flash_attention_bwd_dq": [_P] * 7 + [_I] * 4 + [_S, _F, _I, _P],
}


def build_other(csrc: Path, tag: str, signatures) -> ctypes.CDLL:
    """Every .cu of `csrc` built into OUT/<tag>.so, its entry points typed."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = OUT / f"{tag}_{src.stem}.o"
        procs.append((obj, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for obj, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out}")
        print(f"{tag} {obj.name}: " + " ".join(
            ln.strip() for ln in out.splitlines() if "spill" in ln
            and not ln.strip().startswith("0 bytes stack")), flush=True)
    so = OUT / f"{tag}.so"
    subprocess.run([_build.nvcc(), *_build.ARCH, "-shared",
                    *(str(o) for o, _ in procs), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout.strip()[-70:]
    except (OSError, subprocess.CalledProcessError):
        return name[-70:]


def inputs(B, T, dtype, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, T, H * D, generator=g, device="cuda").to(dtype)
            .view(B, T, H, D).transpose(1, 2) for _ in range(n)]


def rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def parent_calls(lib, q, k, v, do, lse, delta):
    """The parent's K2 (residual mode when q is fp32), K6 and K7 on these
    inputs, as functions of no argument → their outputs."""
    B, _, T, _ = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    dt = fa._DTYPES[q.dtype]

    def k2():
        o = fa._heads_like(q, T)
        l = (torch.empty(B, H, T, device="cuda")
             if q.dtype == torch.float32 else None)
        _build.check(lib.oh_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if l is None else l.data_ptr(), B, H, T, T,
            fa._strides(q, k, v, o), D ** -0.5, dt, stream), "parent K2")
        return o, l

    def k6():
        dk, dv = fa._heads_like(k, T), fa._heads_like(v, T)
        planes = torch.empty(6 * B * H * D * 2 * T, dtype=torch.bfloat16,
                             device="cuda")
        _build.check(lib.oh_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            planes.data_ptr(), B, H, T, T,
            fa._strides(q, k, v, do, None, dk, dv), D ** -0.5, dt, stream),
            "parent K6")
        return dk, dv

    def k7():
        dq = fa._heads_like(q, T)
        _build.check(lib.oh_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, T, T,
            fa._strides(q, k, v, do, dq, None, None), D ** -0.5, dt, stream),
            "parent K7")
        return dq

    return k2, k6, k7


def check(B, T):
    """fp32 K2 (both modes), K6, K7 against their plain versions, and the
    same bits over two launches → the checked inputs."""
    q, k, v, do = inputs(B, T, torch.float32, 4, T)
    o, lse = fa.flash_attention_lse(q, k, v)
    o_plain, lse_plain = fa.attend_lse(q, k, v)
    o_inf = fa.flash_attention(q, k, v)
    delta = fa.delta_rows(o, do)
    planes = fa.split_planes(q, k, v, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, planes)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, planes)
    dq_own = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    ref = fa.attend_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    print(f"fp32 B={B} T={T}: K2 lse max_abs_err "
          f"{(lse - lse_plain).abs().max().item():.3e}, output "
          f"{(o - o_plain).abs().max().item():.3e} (rel {rel(o, o_plain):.3e}),"
          f" inference = residual output: {torch.equal(o_inf, o)}; "
          f"K7 dq rel {rel(dq, ref[0]):.3e}, K6 dk rel {rel(dk, ref[1]):.3e}, "
          f"dv rel {rel(dv, ref[2]):.3e}; K7 on its own split = shared: "
          f"{torch.equal(dq, dq_own)}", flush=True)
    again = fa.flash_attention_lse(q, k, v)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    print(f"  same bits over two launches: K2 "
          f"{torch.equal(again[0], o) and torch.equal(again[1], lse)}, K7 "
          f"{torch.equal(dq2, dq)}", flush=True)
    return q, k, v, do, lse, delta


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a directory with another copy of csrc/")
    ap.add_argument("--variant", help="a changed copy of this tree's csrc/")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.monotonic()
    so = _build.build()
    _build.library()
    parent = (build_other(Path(args.parent), "parent", PARENT_SIGNATURES)
              if args.parent else None)
    variant = (build_other(Path(args.variant), "variant", _build.SIGNATURES)
               if args.variant else None)
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    name = None
    for line in open(str(so) + ".log"):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "flash" in name and ("registers" in line or "spill" in line):
            print(f"  {demangle(name)}: {line.strip()}")

    check(1, 333)
    q, k, v, do, lse, delta = check(2, 1500)
    tm = chip_smoke.time_ms
    planes = fa.split_planes(q, k, v, do)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def backward():
        p = fa.split_planes(q, k, v, do)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, p)
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, p)

    times = {
        "split pass, q k v": lambda: fa.split_planes(q, k, v),
        "split pass, q k v dO": lambda: fa.split_planes(q, k, v, do),
        "K2 fp32 residual mode (with its split)":
            lambda: fa.flash_attention_lse(q, k, v),
        "K2 fp32 inference mode (with its split)":
            lambda: fa.flash_attention(q, k, v),
        "K6 (with its own split)":
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
        "K7 (with its own split)":
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
        "K6 on given planes":
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, planes),
        "K7 on given planes":
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, planes),
        "backward: one split, K6, K7": backward,
        "SDPA fp32 forward": lambda: sdpa(q, k, v),
    }
    for label, fn in times.items():
        print(f"  {label} (fp32, B=2, T=1500): {tm(fn):.4f} ms", flush=True)

    if parent is not None:
        p_k2, p_k6, p_k7 = parent_calls(parent, q, k, v, do, lse, delta)
        pairs = {
            "K2 fp32 residual mode": (p_k2, lambda: fa.flash_attention_lse(q, k, v)),
            "K6": (p_k6, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)),
            "K7": (p_k7, lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
        }
        bq, bk, bv = inputs(1, 1500, torch.bfloat16, 3, 7)
        b_k2 = parent_calls(parent, bq, bk, bv, bq, None, None)[0]
        ours = fa.flash_attention(bq, bk, bv)
        theirs = b_k2()[0]
        torch.cuda.synchronize()
        print(f"K2 bf16 (B=1, T=1500): the same bits as the parent's: "
              f"{torch.equal(ours, theirs)}", flush=True)
        pairs["K2 bf16 (B=1)"] = (b_k2, lambda: fa.flash_attention(bq, bk, bv))
        for label, (p_fn, fn) in pairs.items():
            t = [tm(p_fn), tm(fn), tm(fn), tm(p_fn)]
            print(f"  {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, this tree "
                  f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    if variant is not None:
        ours = _build.library()
        calls = {
            "K2 fp32 residual mode": lambda: fa.flash_attention_lse(q, k, v),
            "K6 on given planes":
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, planes),
            "K7 on given planes":
                lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, planes),
        }
        bq, bk, bv = inputs(1, 1500, torch.bfloat16, 3, 7)
        calls["K2 bf16 (B=1)"] = lambda: fa.flash_attention(bq, bk, bv)
        ref_bf16 = fa.flash_attention(bq, bk, bv)
        _build._lib = variant
        print(f"K2 bf16 (B=1, T=1500): the variant gives this tree's bits: "
              f"{torch.equal(fa.flash_attention(bq, bk, bv), ref_bf16)}",
              flush=True)
        check(1, 333)
        check(2, 1500)
        for label, fn in calls.items():
            t = []
            for lib in (ours, variant, variant, ours):
                _build._lib = lib
                t.append(tm(fn))
            print(f"  {label}: this tree {t[0]:.4f} / {t[3]:.4f} ms, variant "
                  f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
        _build._lib = ours
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
