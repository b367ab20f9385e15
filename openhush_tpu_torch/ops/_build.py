"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface. At first use they are
compiled for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and linked into one shared library under
``openhush_tpu_torch/build/`` (git-ignored), named by a hash of the sources
and flags: a changed source builds anew, an unchanged one is loaded as it
is. The library is loaded with ctypes, so nothing here includes PyTorch's
headers. There is no ``--use_fast_math``: it would turn ``/`` and ``log10f``
into approximations, and the kernels' parity with the reference needs the
IEEE versions. decode_attention.cu alone also takes ``--split-compile=0``
(SOURCE_FLAGS), which optimizes its 86 kernels on all cores: the build's
wall time is that source's, 97.9 s without the flag and 49.2 s with it on
an H100 machine's 8 cores (tools/torch_build_flags_probe.py). The flag
changes the SASS of most kernels, so no other source, which would gain a
second at most, takes it.

Nothing is compiled or loaded when this module is imported; only the kernel
wrappers call :func:`library`, and only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
SOURCE_FLAGS = {"decode_attention.cu": ["--split-compile=0"]}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# extern "C" entry points and their argument types; each returns a
# cudaError_t as int (0 = launched), except those in RESTYPES.
SIGNATURES = {
    "oh_log_mel": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
    "oh_flash_attention": [_P] * 6 + [_I] * 4
                          + [ctypes.POINTER(_LL), _F, _I, _P],
    "oh_flash_attention_split": [_P] * 5 + [_I] * 4
                                + [ctypes.POINTER(_LL), _P],
    "oh_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 4
                                  + [ctypes.POINTER(_LL), _F, _I, _P],
    "oh_flash_attention_bwd_dq": [_P] * 8 + [_I] * 4
                                 + [ctypes.POINTER(_LL), _F, _I, _P],
    "oh_quantize_heads_kv": [_P] * 6 + [_LL, _I, _I, _P],
    "oh_decode_attention": [_P] * 6 + [_I, _I] + [_P] * 3 + [_I] * 4
                           + [_F, _I, _I, _I, _P],
    "oh_envelope": [_P, _P, _LL, _I, _F, _F, _P, _P],
    "oh_limiter_gain": [_P, _P, _LL, _I, _F, _P, _P],
    "oh_envelope_serial": [_P, _P, _LL, _I, _F, _F, _P],
    "oh_limiter_gain_serial": [_P, _P, _LL, _I, _F, _P],
    "oh_dsp_scratch_floats": [_LL, _I],
    "oh_noise_floor": [_P, _P, _P, _I, _I, _I, _P],
    "oh_w8a16_group": [_P] + ([_P] * 4 + [_I]) * 3 + [_I] * 4 + [_P],
    "oh_w8a16_cluster": [_I] * 4,
    "oh_w8a8_quantize": [_P] * 5 + [_I] * 4 + [_F, _P],
    "oh_w8a8_mm": [_P, _P] + ([_P] * 5 + [_I]) * 3 + [_I] * 6 + [_P],
}

RESTYPES = {"oh_dsp_scratch_floats": _LL}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libopenhush_kernels_{h.hexdigest()[:16]}.so"


def compile_command(src: Path, out, *extra: str, flags=None, cc=None
                    ) -> list[str]:
    """nvcc's command line for one source into `out` (`extra` says what:
    "-c" for an object, "-shared" for a library of its own), with FLAGS
    and the source's SOURCE_FLAGS unless `flags` is given."""
    if flags is None:
        flags = FLAGS + SOURCE_FLAGS.get(src.name, [])
    return [cc or nvcc(), *ARCH, *flags, *extra, str(src), "-o", str(out)]


def load(so, prefix: str = "") -> ctypes.CDLL:
    """A built library loaded with the argument and result types of the
    SIGNATURES entries whose names start with `prefix` (every entry by
    default); each of them must be in it."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        if name.startswith(prefix):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


_PTXAS_LINES = ("registers", "spill", "error", "warning",
                "Function properties", "Compiling", "Performance Loss")


def build_one(src: Path, name: str, out_dir: Path, prefix: str
              ) -> ctypes.CDLL:
    """A library of one source (a copy of a csrc file may include its
    headers), built into `out_dir/<name>.so` on every call and loaded apart
    from :func:`library`, with the argument types of the SIGNATURES whose
    names start with `prefix`; ptxas's register and spill lines printed.
    The probes build variants of a kernel with it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{name}.so"
    t = time.monotonic()
    run = subprocess.run(compile_command(src, so, "-I", str(CSRC), "-shared"),
                         capture_output=True, text=True)
    print(f"build {src.name} as {name}: rc {run.returncode} in "
          f"{time.monotonic() - t:.1f} s", flush=True)
    for line in (run.stdout + run.stderr).splitlines():
        if any(k in line for k in _PTXAS_LINES):
            print("  " + line.strip())
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {src}")
    return load(so, prefix)


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists. The
    compiler's output (ptxas register and shared-memory counts included)
    is kept beside it as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                compile_command(src, obj, "-c", cc=cc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run([cc, *ARCH, "-shared", *objs, "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        Path(str(so) + ".log").write_text("\n".join(log))
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
