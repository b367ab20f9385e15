"""Probe of the port's K5 kernel (openhush_tpu_torch/csrc/decode_attention.cu:
the int8 cross-attention as a thread-block cluster split over T) on one GPU,
at the serving step's shape: large-v3, 20 heads, T = 1500, int8 K/V with
per-(position, head) scales, batch 8 and batch 1.

    python3 tools/torch_k5_probe.py
    python3 tools/torch_k5_probe.py --multi [--parent FILE]
    python3 tools/torch_k5_probe.py --ptxas

Prints the card's name and power limit, then:
  1. how many clusters of 8 CTAs of 128 threads the card holds at once
     (cudaOccupancyMaxActiveClusters), at several sizes of shared memory;
  2. the time of a kernel that only loads K as K5 does (a slice of rows per
     CTA, 16-byte cp.async per thread), for rows of 64 B (one head to a CTA)
     and 128 B (two), with and without a cluster of 8;
  3. K5's time as the source stands (two heads to a cluster) and with one
     head to a cluster, then diagnostic builds of the one-head kernel whose
     outputs are wrong on purpose: without the scale loads, without V's
     loads, without the exchanges between ranks, and with K's loads alone.
With --multi, K5 with S queries a row instead (ops/decode_attention.py's
attend_decode_pipelined, causal off), at chip_smoke.py's phase 2 shapes:
G=4 and G=1 beam groups of K=5 beams (S=5), the spec server's verify (B=8,
S=4) and the one-shot verify (B=1, S=5), and the S=1 steps at B=8 and
B=1, int8 K/V with scales, T = 1500, every key visible. It times this
source (the multi-query mode: a cluster per row), the same with one head
to a cluster, and, with --parent, another decode_attention.cu (for
example the parent commit's, whose K5 takes a cluster per query) through
the same wrapper, in turns and back, and says whether each build's
outputs equal this source's bit for bit. The builds run at once.
With --ptxas, the registers, stack and spills ptxas gave each K5 instance
(the per-query and the multi-query kernel's) in the port's library build
(`<lib>.so.log`), one line an instance with its template arguments.
Every time is the mean device time of 64 launches (chip_smoke.time_ms), each
on another of 32 copies of the inputs (cold in the 50 MB L2). Each build
is nvcc alone into a shared library under the git-ignored
openhush_tpu_torch/build/probe/, loaded with ctypes in place of the port's
library. Needs one GPU; exits 1 without one.
"""

import argparse
import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openhush_tpu_torch.ops import _build, quantize  # noqa: E402
from openhush_tpu_torch.ops import decode_attention as da  # noqa: E402

OUT = _build.BUILD_DIR / "probe"
SRC = _build.CSRC / "decode_attention.cu"

LOADS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int ROWB>
__device__ void body(const int8_t* k, int T, int HD) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int CH = ROWB / 16, RPP = 128 / CH;
  const int per = (T + 7) / 8, r0 = blockIdx.x * per, cnt = min(per, T - r0);
  const int8_t* base = k + ((long long)blockIdx.z * T + r0) * HD + blockIdx.y * ROWB;
  const int c = threadIdx.x % CH;
  for (int r = threadIdx.x / CH; r < cnt; r += RPP)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(sm + (r * CH + c) * 16)),
                   "l"(base + (long long)r * HD + c * 16) : "memory");
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
template <int ROWB> __global__ void __launch_bounds__(128) plain_k(const int8_t* k, int T, int HD) {
  body<ROWB>(k, T, HD);
}
template <int ROWB> __global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(128)
clus_k(const int8_t* k, int T, int HD) { body<ROWB>(k, T, HD); }

template <typename K> int go(K kern, int rowb, const void* k, int B, int T, int HD, void* st) {
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  kern<<<dim3(8, HD / rowb, B), 128, (size_t)((T + 7) / 8) * rowb, (cudaStream_t)st>>>(
      (const int8_t*)k, T, HD);
  return (int)cudaGetLastError();
}
extern "C" int loads(int variant, const void* k, int B, int T, int HD, void* st) {
  switch (variant) {
    case 0: return go(plain_k<64>, 64, k, B, T, HD, st);
    case 1: return go(plain_k<128>, 128, k, B, T, HD, st);
    case 2: return go(clus_k<64>, 64, k, B, T, HD, st);
    default: return go(clus_k<128>, 128, k, B, T, HD, st);
  }
}
extern "C" int resident_clusters(int smem) {
  cudaFuncSetAttribute(clus_k<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 8;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(8, 20, 8);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (const void*)clus_k<64>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
"""

# K5 builds: name -> source edits (old text, new text) of decode_attention.cu.
ONE_HEAD = [("  const bool pairs = sizeof(KV) == 1 && H % 2 == 0 &&",
             "  const bool pairs = false &&")]
# --multi: (label, B, S) at phase 2's shapes.
MULTI_SHAPES = (("G=4/S=5 (beam server)", 4, 5), ("G=1/S=5 (one-shot beam)", 1, 5),
                ("B=8/S=4 (spec server verify)", 8, 4), ("B=1/S=5 (one-shot verify)", 1, 5),
                ("B=8/S=1 (serving step)", 8, 1), ("B=1/S=1 (one-shot step)", 1, 1))
NO_SCALES = [
    ("if (QUANT && hc == 0) cp_async4(kss + r * G + g, ksb + (long long)r * H + g);",
     "if (QUANT && hc == 0) kss[r * G + g] = 1.f;"),
    ("cp_async4(vss + i, vsb + (long long)(i / G) * H + i % G);", "vss[i] = 1.f;")]
NO_V = [("      cp_async16(rows + r * RC + c, vb + (long long)r * HD + c * L::VALS);", "      ;")]
NO_EXCHANGE = [
    ("oh_tma::mbar_wait_cluster(&got_max, 0);", "__syncthreads();"),
    ("oh_tma::mbar_wait_cluster(&got_sum, 0);", "__syncthreads();"),
    ("oh_tma::mbar_wait_cluster(&got_pv, 0);", "__syncthreads();"),
    ("st_async(at_rank(slot + rank * N + i, dst), __float_as_uint(pick(x, i)), at_rank(bar, dst));",
     "slot[rank * N + i] = pick(x, i);")]
BUILDS = {
    "as committed (two heads to a cluster)": [],
    "one head to a cluster": ONE_HEAD,
    "one head, no scale loads (wrong outputs)": ONE_HEAD + NO_SCALES,
    "one head, no V loads (wrong outputs)": ONE_HEAD + NO_V,
    "one head, no exchanges (wrong outputs)": ONE_HEAD + NO_EXCHANGE,
    "one head, K's loads alone (wrong outputs)": ONE_HEAD + NO_SCALES + NO_V + NO_EXCHANGE,
}


def build_all(sources: dict, symbol: str, argtypes) -> dict:
    """Compile each (name: .cu text) alone into OUT/<name>.so, one nvcc
    process each, all at once, and load them."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(source)
        procs[name] = (cu, so, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-I", str(_build.CSRC), "-shared",
             str(cu), "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (cu, so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cu}:\n{out[-4000:]}{err[-4000:]}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build(name: str, source: str, symbol: str, argtypes) -> ctypes.CDLL:
    """Compile `source` (a .cu text) alone into OUT/<name>.so and load it."""
    return build_all({name: source}, symbol, argtypes)[name]


def edited(text: str, edits) -> str:
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    return text


def multi(parent) -> None:
    """K5 with S queries a row, at MULTI_SHAPES, for each build in turns
    and back, each layer's inputs a copy of their own (cold in L2)."""
    sources = {"as is": SRC.read_text()}
    sources["one head a cluster"] = edited(sources["as is"], ONE_HEAD)
    if parent:
        sources["parent"] = Path(parent).read_text()
    built = build_all({f"k5_multi_{i}": src for i, src in enumerate(sources.values())},
                      "oh_decode_attention", _build.SIGNATURES["oh_decode_attention"])
    libs = dict(zip(sources, built.values()))
    dev, H, D, T = torch.device("cuda"), 20, 64, 1500
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 18)
    shapes = {}
    for label, B, S in MULTI_SHAPES:
        q = torch.randn(B, S, H * D, generator=g, device=dev).to(torch.bfloat16)
        (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(
            torch.randn(B, T, H * D, generator=g, device=dev).to(torch.bfloat16), H)
            for _ in range(2))
        shapes[label] = (q, [tuple(x.clone() for x in (k8, v8, ks, vs)) for _ in range(32)])
    order = list(libs) + list(libs)[::-1]
    times = {name: {s: [] for s in shapes} for name in libs}
    outs = {}
    for name in order:
        _build._lib = libs[name]
        for label, (q, layers) in shapes.items():
            k8, v8, ks, vs = layers[0]
            outs[name, label] = da.attend_decode_pipelined(q, k8, v8, None, H, ks=ks, vs=vs)
            times[name][label].append(chip_smoke.time_ms(chip_smoke.rotate([
                functools.partial(da.attend_decode_pipelined, q, kl, vl, None, H, ks=ksl, vs=vsl)
                for kl, vl, ksl, vsl in layers]), iters=64))
    for name in libs:
        print(f"{name:20s} " + "  ".join(
            f"{s} {min(t):.4f} ms (of {', '.join(f'{x:.4f}' for x in t)})"
            for s, t in times[name].items()))
    for name in libs:
        if name != "as is":
            for label in shapes:
                same = torch.equal(outs[name, label], outs["as is", label])
                e = (outs[name, label].float() - outs["as is", label].float()).abs().max().item()
                print(f"{label}: {name}'s outputs against this source's: "
                      f"{'equal bit for bit' if same else f'max_abs_err {e:.3e}'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="time K5 with S queries a row at phase 2's shapes")
    ap.add_argument("--parent", help="with --multi: another decode_attention.cu to time in turns")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills of each K5 instance")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k5_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.multi:
        multi(args.parent)
        return 0
    if args.ptxas:
        log = Path(str(_build.build()) + ".log").read_text().splitlines()
        for i, line in enumerate(log):
            kernel = re.search(r"(split|multi)_kernelI(\w*?)EEv", line)
            if "Compiling entry" in line and kernel:
                info = [x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"{kernel.group(1)}<{kernel.group(2)}>: {'; '.join(info)}")
        return 0
    dev = torch.device("cuda")
    B, H, D, T = 8, 20, 64, 1500
    HD = H * D
    P, I = ctypes.c_void_p, ctypes.c_int

    lib = build("loads", LOADS, "loads", [I, P, I, I, I, P])
    lib.resident_clusters.argtypes, lib.resident_clusters.restype = [I], I
    for smem in (12032, 16000, 28000, 36000):
        print(f"clusters of 8 held at once, {smem} B of shared memory a CTA: "
              f"{lib.resident_clusters(smem)}")
    copies = [torch.randint(-127, 128, (B, T, HD), dtype=torch.int8, device=dev)
              for _ in range(32)]
    st = torch.cuda.current_stream().cuda_stream

    def load(variant, k, b):
        assert lib.loads(variant, k.data_ptr(), b, T, HD, st) == 0

    names = ("64 B rows", "128 B rows", "64 B rows, cluster of 8", "128 B rows, cluster of 8")
    for variant, what in enumerate(names):
        for b in (8, 1):
            ms = chip_smoke.time_ms(chip_smoke.rotate(
                [functools.partial(load, variant, k, b) for k in copies]), iters=64)
            print(f"K's loads alone, {what}, batch {b} ({b * T * HD / 1e6:.1f} MB): "
                  f"{ms:.4f} ms")
    del copies

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 10)
    q = torch.randn(B, 1, HD, generator=g, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = (quantize.quantize_heads_plain(
        torch.randn(B, T, HD, generator=g, device=dev).to(torch.bfloat16), H)
        for _ in range(2))
    plain = da.attend_decode_plain(q, k8, v8, None, H, ks=ks, vs=vs)
    layers = [tuple(x.clone() for x in (k8, v8, ks, vs)) for _ in range(32)]
    text = SRC.read_text()
    for i, (what, edits) in enumerate(BUILDS.items()):
        source = edited(text, edits)
        _build._lib = build(f"k5_{i}", source, "oh_decode_attention",
                            _build.SIGNATURES["oh_decode_attention"])
        out = da.attend_decode_pipelined(q, k8, v8, None, H, ks=ks, vs=vs)
        err = (out.float() - plain.float()).abs().max().item()
        times = [chip_smoke.time_ms(chip_smoke.rotate([
            functools.partial(da.attend_decode_pipelined, q[:b], kl[:b], vl[:b], None, H,
                              ks=ksl[:b], vs=vsl[:b])
            for kl, vl, ksl, vsl in layers]), iters=64) for b in (8, 1)]
        print(f"K5, {what}: batch 8 {times[0]:.4f} ms, batch 1 {times[1]:.4f} ms; "
              f"max_abs_err against the plain version {err:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
