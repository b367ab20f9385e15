"""Probe of the port's K5 kernel (openhush_tpu_torch/csrc/decode_attention.cu:
the int8 cross-attention as a thread-block cluster split over T) on one GPU,
at the serving step's shape: large-v3, 20 heads, T = 1500, int8 K/V with
per-(position, head) scales, batch 8 and batch 1.

    python3 tools/torch_k5_probe.py

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
Every time is the mean device time of 64 launches (chip_smoke.time_ms), each
on another of 32 copies of the inputs (cold in the 50 MB L2). Each build
is nvcc alone into a shared library under the git-ignored
openhush_tpu_torch/build/probe/, loaded with ctypes in place of the port's
library. Needs one GPU; exits 1 without one.
"""

import ctypes
import functools
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
ONE_HEAD = [("      if (H % 2 == 0 && smem_split<KV>(T, 2) <= MAX_SMEM_SPLIT)",
             "      if (false)")]
NO_SCALES = [
    ("if (QUANT && hc == 0) cp_async4(kss + r * G + g, ksb + (long long)r * H + g);",
     "if (QUANT && hc == 0) kss[r * G + g] = 1.f;"),
    ("cp_async4(vss + i, vsb + (long long)(i / G) * H + i % G);", "vss[i] = 1.f;")]
NO_V = [("      cp_async16(rows + r * RC + c, vb + (long long)r * HD + c * L::VALS);", "      ;")]
NO_EXCHANGE = [
    ("oh_tma::mbar_wait_cluster(&got_max, 0);", "__syncthreads();"),
    ("oh_tma::mbar_wait_cluster(&got_sum, 0);", "__syncthreads();"),
    ("oh_tma::mbar_wait_cluster(&got_pv, 0);", "__syncthreads();"),
    ("st_async(at_rank(slot + rank * G + g, dst), __float_as_uint(pick(x, g)), at_rank(bar, dst));",
     "slot[rank * G + g] = pick(x, g);")]
BUILDS = {
    "as committed (two heads to a cluster)": [],
    "one head to a cluster": ONE_HEAD,
    "one head, no scale loads (wrong outputs)": ONE_HEAD + NO_SCALES,
    "one head, no V loads (wrong outputs)": ONE_HEAD + NO_V,
    "one head, no exchanges (wrong outputs)": ONE_HEAD + NO_EXCHANGE,
    "one head, K's loads alone (wrong outputs)": ONE_HEAD + NO_SCALES + NO_V + NO_EXCHANGE,
}


def build(name: str, source: str, symbol: str, argtypes) -> ctypes.CDLL:
    """Compile `source` (a .cu text) alone into OUT/<name>.so and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(source)
    r = subprocess.run([_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-I", str(_build.CSRC),
                        "-shared", str(cu), "-o", str(so)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    getattr(lib, symbol).argtypes = argtypes
    getattr(lib, symbol).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k5_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
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
        source = text
        for old, new in edits:
            assert old in source, old
            source = source.replace(old, new)
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
