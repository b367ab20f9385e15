"""Probe of the port's log-mel kernel (K1, csrc/frontend.cu) and per-head
int8 quantize kernel (K3, csrc/quantize_heads.cu) on one GPU, at the
window preparation's shapes: one 30 s window (3000 frames, 128 mels) at
B = 1 and 8, and large-v3's cross K and V ([1, 1500, 1280] bf16, 20 heads,
32 decoder layers).

    python3 tools/torch_frontend_quant_probe.py [--parent DIR] [--variant DIR]

Prints the card's name and power limit; ptxas's registers and spills for
the two kernels; each kernel's error against its plain version (K1's log10
energies before the clamp and K3 at the shapes and tolerances of
chip_smoke.check_k1_energies and chip_smoke.check_k3; with --parent, the
parent's K1 errors too); then device times (mean of 20 launches,
chip_smoke.time_ms) in turns, plain, kernel, kernel, plain:
  - K1 (`log_mel_energies`) at B = 1 and 8, and at 1500 frames;
  - K3 hot in L2 (one layer's buffers again and again) and cold (rotating
    over 32 layers' buffers), one K+V launch and one tensor;
  - the quantize part of `compute_cross_kv_quant` over 32 layers (K+V
    launches into the stacked cache), and the whole function on random
    large-v3 weights, also under torch.profiler (device busy time).
With --parent DIR, a directory holding another copy of csrc/ (for example
the parent commit's, from `git archive`), its frontend.cu and
quantize_heads.cu are built (nvcc alone, into the git-ignored
openhush_tpu_torch/build/probe/) and timed in turns with this tree's
(parent, this, this, parent): K1 at B = 1 and 8, K3 one tensor hot and
cold, two launches against one K+V launch, and the parent's
`compute_cross_kv_quant` (two launches a layer, then torch.stack). With
--variant DIR (repeatable), a copy of this tree's csrc/ changed by hand
(the same entry points), the variant's K1 and K3 are checked against this
tree's and timed in turns with them (this, variant, variant, this),
through the same wrappers; last, the time of a launch that writes one
float, the floor under any launch in these loops. Needs one GPU; exits 1
without one.
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
from openhush_tpu_torch.models.whisper.config import get_config  # noqa: E402
from openhush_tpu_torch.ops import _build, frontend, mel, quantize  # noqa: E402

OUT = _build.BUILD_DIR / "probe"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The entry points before K3 took K and V in one launch and K1 read the
# audio itself.
PARENT_SIGNATURES = {
    "oh_log_mel": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
    "oh_quantize_heads": [_P, _P, _P, _LL, _I, _I, _P],
}
H, LAYERS = 20, 32
tm = chip_smoke.time_ms


def build_other(csrc: Path, tag: str, signatures) -> ctypes.CDLL:
    """`csrc`'s frontend.cu and quantize_heads.cu built into OUT/<tag>.so,
    their entry points typed."""
    OUT.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for name in ("frontend.cu", "quantize_heads.cu"):
        obj = OUT / f"{tag}_{Path(name).stem}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-c",
             str(csrc / name), "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out}")
    so = OUT / f"{tag}.so"
    subprocess.run([_build.nvcc(), *_build.ARCH, "-shared", *objs, "-o",
                    str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=4)
def parent_bases(n_mels):
    cos_b, sin_b = mel._dft_bases()
    return tuple(torch.from_numpy(a).cuda() for a in (
        cos_b, sin_b, mel.mel_filter_bank(n_mels)))


def k1_parent(lib, padded, n_frames, n_mels):
    cos_b, sin_b, fb = parent_bases(n_mels)
    out = torch.empty(padded.shape[0], n_frames, n_mels, device="cuda")
    _build.check(lib.oh_log_mel(
        padded.data_ptr(), padded.shape[1], cos_b.data_ptr(),
        sin_b.data_ptr(), fb.data_ptr(), out.data_ptr(), padded.shape[0],
        n_frames, n_mels, stream()), "parent oh_log_mel")
    return out


def parent_k1_errors(parent):
    """The parent's K1 against the plain version's log10 energies, at the
    shapes chip_smoke.check_k1_energies holds this tree's kernel to."""
    for i, (B, nf, nm) in enumerate(((1, 3000, 128), (2, 3000, 128),
                                     (8, 3000, 128), (1, 3000, 80),
                                     (1, 1500, 128))):
        audio = torch.cat([torch.from_numpy(chip_smoke.speechlike(30.0, i + b))
                           [None] for b in range(B)]).cuda()
        plain = mel.log_mel_energies(audio, nm, nf)
        theirs = k1_parent(parent, mel.reflect_pad(audio).contiguous(), nf, nm)
        print(f"parent K1 B={B} frames={nf} mels={nm}: log10 energies "
              f"max_abs_err {(theirs - plain).abs().max().item():.2e}",
              flush=True)


def parent_quantize(lib, x, q=None, s=None):
    B, T, HD = x.shape
    q = torch.empty(B, T, HD, dtype=torch.int8, device="cuda") if q is None else q
    s = torch.empty(B, T, H, device="cuda") if s is None else s
    _build.check(lib.oh_quantize_heads(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), B * T * H, HD // H,
        1 if x.dtype == torch.bfloat16 else 0, stream()), "parent quantize")
    return q, s


def parent_cross_kv_quant(lib, params, feats):
    """The parent's compute_cross_kv_quant: two launches a layer, then
    torch.stack of the per-layer tensors."""
    kq, ks, vq, vs = [], [], [], []
    for k, v in whisper._cross_kv_layers(params, feats):
        k8, k_s = parent_quantize(lib, k)
        v8, v_s = parent_quantize(lib, v)
        kq.append(k8), ks.append(k_s), vq.append(v8), vs.append(v_s)
    return [torch.stack(t) for t in (kq, ks, vq, vs)]


def busy_ms(fn, runs=3):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy, by_name = chip_smoke.device_time(prof)
    return busy / 1e3 / runs, {n: us / 1e3 / runs for n, us in by_name.items()}


def turns(label, a, b, names=("plain", "kernel")):
    t = [tm(a), tm(b), tm(b), tm(a)]
    print(f"  {label}: {names[0]} {t[0]:.4f} / {t[3]:.4f} ms, {names[1]} "
          f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_frontend_quant_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a directory with another copy of csrc/")
    ap.add_argument("--variant", action="append", default=[],
                    help="a changed copy of this tree's csrc/ (repeatable)")
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
    variants = {d: build_other(Path(d), f"variant{i}", {
        k: _build.SIGNATURES[k] for k in ("oh_log_mel", "oh_quantize_heads_kv")})
        for i, d in enumerate(args.variant)}
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    name = None
    for line in open(str(so) + ".log"):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("log_mel" in name or "quantize" in name) and (
                "registers" in line or "spill" in line):
            print(f"  {name[-60:]}: {line.strip()}")

    chip_smoke.check_k1_energies(frontend, mel)
    if parent is not None:
        parent_k1_errors(parent)
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, B, T, heads, head_dim in chip_smoke.K3_SHAPES:
        k, v = ((scale * torch.randn(B, T, heads * head_dim, generator=g,
                                     device="cuda")).to(dtype)
                for scale in (3.0, 1.0))
        chip_smoke.check_k3(quantize, k, v, heads)

    print("K1 times (one 30 s window a row, 128 mels):", flush=True)
    for B, nf in ((1, 3000), (8, 3000), (1, 1500)):
        audio = torch.cat([torch.from_numpy(chip_smoke.speechlike(30.0, b))
                           [None] for b in range(B)]).cuda()
        ours = lambda: frontend.log_mel_energies(audio, 128, nf)
        turns(f"B={B} frames={nf}", lambda: mel.log_mel_energies(
            audio, 128, nf), ours)
        if parent is not None:
            padded = mel.reflect_pad(audio).contiguous()
            turns(f"B={B} frames={nf}, the parent's kernel on padded audio",
                  lambda: k1_parent(parent, padded, nf, 128), ours,
                  ("parent", "this tree"))
            turns(f"B={B} frames={nf}, the parent's wrapper (reflect pad, "
                  f"then its kernel)", lambda: k1_parent(
                      parent, mel.reflect_pad(audio).contiguous(), nf, 128),
                  ours, ("parent", "this tree"))

    print("K3 times ([1, 1500, 1280] bf16, 20 heads):", flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    cfg = get_config("large-v3")
    shape = (LAYERS, 1, 1500, cfg.n_text_state)
    xk, xv = ((3 * torch.randn(*shape, generator=g, device="cuda"))
              .to(torch.bfloat16) for _ in range(2))
    outs = [torch.empty(s, dtype=d, device="cuda") for s, d in (
        (shape, torch.int8), (shape[:3] + (H,), torch.float32))] * 2
    outs = [torch.empty_like(t) for t in outs]
    kv = lambda l: quantize.quantize_heads_kv(
        xk[l], xv[l], H, tuple(t[l] for t in outs))
    one = lambda l: quantize.quantize_heads(xk[l], H)
    layers = range(LAYERS)
    cold = lambda f: chip_smoke.rotate([functools.partial(f, l) for l in layers])
    plain_kv = lambda: quantize.quantize_heads_kv_plain(
        xk[0], xv[0], H, tuple(t[0] for t in outs))
    turns("K+V launch, hot", plain_kv, functools.partial(kv, 0))
    print(f"  K+V launch, cold: {tm(cold(kv), iters=64):.4f} ms; one tensor, "
          f"hot {tm(functools.partial(one, 0)):.4f} ms, cold "
          f"{tm(cold(one), iters=64):.4f} ms", flush=True)
    if parent is not None:
        pone = lambda l: parent_quantize(parent, xk[l])
        ptwo = lambda l: (parent_quantize(parent, xk[l]),
                          parent_quantize(parent, xv[l]))
        turns("one tensor, hot", functools.partial(pone, 0),
              functools.partial(one, 0), ("parent", "this tree"))
        turns("one tensor, cold", cold(pone), cold(one), ("parent", "this tree"))
        turns("K and V, hot: two parent launches / one K+V launch",
              functools.partial(ptwo, 0), functools.partial(kv, 0),
              ("parent", "this tree"))
        turns("K and V, cold: two parent launches / one K+V launch",
              cold(ptwo), cold(kv), ("parent", "this tree"))

    ours = _build.library()
    audio = torch.cat([torch.from_numpy(chip_smoke.speechlike(30.0, b))
                       [None] for b in range(8)]).cuda()
    calls = {"K1 B=1": lambda: frontend.log_mel_energies(audio[:1], 128, 3000),
             "K1 B=8": lambda: frontend.log_mel_energies(audio, 128, 3000),
             "K3 K+V launch, hot": functools.partial(kv, 0),
             "K3 K+V launch, cold": cold(kv),
             "K3 one tensor, hot": functools.partial(one, 0)}
    for name, variant in variants.items():
        ref = frontend.log_mel_energies(audio, 128, 3000)
        _build._lib = variant
        got = frontend.log_mel_energies(audio, 128, 3000)
        kv(0)
        qp = quantize.quantize_heads_plain(xk[0], H)
        torch.cuda.synchronize()
        print(f"variant {name}: K1 B=8 vs this tree max_abs_err "
              f"{(got - ref).abs().max().item():.2e}; K3 K+V scales exact "
              f"{torch.equal(outs[1][0], qp[1])}, levels differing "
              f"{int((outs[0][0] != qp[0]).sum())}", flush=True)
        for label, fn in calls.items():
            t = []
            for lib in (ours, variant, variant, ours):
                _build._lib = lib
                t.append(tm(fn, iters=64 if "cold" in label else 20))
            print(f"  {label}: this tree {t[0]:.4f} / {t[3]:.4f} ms, variant "
                  f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
        _build._lib = ours
    floor = torch.empty(1, device="cuda")
    print(f"a launch that writes one float (torch fill_), the floor of a "
          f"launch in this loop: {tm(lambda: floor.fill_(1.0)):.4f} ms",
          flush=True)

    # compute_cross_kv_quant on random large-v3 decoder weights, one window.
    d = cfg.n_text_state
    w = lambda *s: (0.02 * torch.randn(*s, generator=g, device="cuda")
                    ).to(torch.bfloat16)
    params = {"decoder": {"layers": {"xk_w": w(LAYERS, d, d),
                                     "xv_w": w(LAYERS, d, d),
                                     "xv_b": w(LAYERS, d)}}}
    feats = w(1, 1500, d) * 50
    ours = whisper.compute_cross_kv_quant(cfg, params, feats)
    this_fn = lambda: whisper.compute_cross_kv_quant(cfg, params, feats)
    print("compute_cross_kv_quant (large-v3, one window):", flush=True)
    if parent is not None:
        theirs = parent_cross_kv_quant(parent, params, feats)
        same = all(torch.equal(a, b) for a, b in zip(
            (ours.k, ours.k_scale, ours.v, ours.v_scale), theirs))
        print(f"  the parent's bits: {same}", flush=True)
        parent_fn = lambda: parent_cross_kv_quant(parent, params, feats)
        turns("whole function", parent_fn, this_fn, ("parent", "this tree"))
        for label, fn in (("parent", parent_fn), ("this tree", this_fn)):
            busy, by_name = busy_ms(fn)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            print(f"  traced, {label}: device busy {busy:.4f} ms; "
                  + "; ".join(f"{n[:50]} {ms:.4f}" for n, ms in top),
                  flush=True)
    else:
        print(f"  whole function {tm(this_fn):.4f} ms; traced device busy "
              f"{busy_ms(this_fn)[0]:.4f} ms", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
