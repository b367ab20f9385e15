"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface. At first use they are
compiled for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and linked into one shared library under
``openhush_tpu_torch/build/`` (git-ignored), named by a hash of the sources
and flags: a changed source builds anew, an unchanged one is loaded as it
is. The library is loaded with ctypes, so nothing here includes PyTorch's
headers. There is no ``--use_fast_math``: it would turn ``/`` and ``log10f``
into approximations, and the kernels' parity with the reference needs the
IEEE versions.

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
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libopenhush_kernels_{h.hexdigest()[:16]}.so"


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
                [cc, *ARCH, *FLAGS, "-c", str(src), "-o", obj],
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
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
