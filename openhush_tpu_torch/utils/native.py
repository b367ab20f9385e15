"""ctypes bindings for the native SPSC ring (native/openhush_native.cpp).

The port's counterpart of openhush_tpu/utils/native.py. The repo's C++
source is read, never written: at first use it is compiled with g++ into
the git-ignored ``openhush_tpu_torch/build/``, named by a hash of the source
and flags (the reference runs ``make`` inside ``native/``). Only the ring
is bound here: the port's DSP runs on the card (ops/dsp.py, csrc/dsp.cu),
so the library's host DSP entry points are not used. Without a compiler
:func:`load` returns None and runtime/ring_buffer.py keeps its numpy ring,
as the reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SOURCE = (Path(__file__).resolve().parent.parent.parent / "native"
          / "openhush_native.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_attempted = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libopenhush_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        log.warning("native build unavailable: no C++ compiler")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        try:
            r = subprocess.run([cxx, *FLAGS, "-o", out, str(SOURCE)],
                               capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native build unavailable: %s", e)
            return False
        if r.returncode != 0:
            log.warning("native build failed: %s", r.stderr[-500:])
            return False
        os.replace(out, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native ring; None if unavailable."""
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            if _build_attempted:
                return None
            _build_attempted = True
            if not _build(so):
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("native library load failed: %s", e)
            return None
        lib.oh_ring_create.restype = ctypes.c_void_p
        lib.oh_ring_create.argtypes = [ctypes.c_uint64]
        lib.oh_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.oh_ring_capacity.restype = ctypes.c_uint64
        lib.oh_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.oh_ring_push.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint64]
        lib.oh_ring_position.restype = ctypes.c_uint64
        lib.oh_ring_position.argtypes = [ctypes.c_void_p]
        lib.oh_ring_extract.restype = ctypes.c_uint64
        lib.oh_ring_extract.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_uint64,
                                        ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """Lock-free SPSC ring (producer thread + consumer thread only)."""

    def __init__(self, min_capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.oh_ring_create(min_capacity)
        if not self._handle:
            raise MemoryError("oh_ring_create failed")
        self.capacity = int(lib.oh_ring_capacity(self._handle))

    def push(self, samples: np.ndarray) -> None:
        a = np.ascontiguousarray(samples, np.float32).ravel()
        self._lib.oh_ring_push(self._handle, _fptr(a), len(a))

    def position(self) -> int:
        return int(self._lib.oh_ring_position(self._handle))

    def extract_range(self, from_pos: int, to_pos: int) -> np.ndarray:
        if to_pos <= from_pos:
            return np.zeros(0, np.float32)
        n = min(to_pos - from_pos, self.capacity)
        out = np.empty(n, np.float32)
        got = self._lib.oh_ring_extract(self._handle, from_pos, to_pos,
                                        _fptr(out))
        return out[:got]

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.oh_ring_destroy(self._handle)
            self._handle = None
