"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, at first use, and reached through ``ctypes``. The
library is named by a content hash of the sources, so an edit rebuilds and
an unchanged tree reuses the last build. A failed build raises with nvcc's
output: there is no path that carries on without the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_kernels", "build_seconds"]

_HERE = Path(__file__).resolve().parent
_SRC_DIR = _HERE / "csrc"
_BUILD_DIR = _HERE / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: wall seconds the last build in this process took (0.0: reused a build)
build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC, or put the CUDA toolkit's "
                       "bin directory on PATH): the CUDA kernels cannot be "
                       "built")


def _library_path() -> Path:
    sources = sorted(_SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libsrt_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    global build_seconds
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(_SRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is None:
            so = _library_path()
            if so.exists():
                build_seconds = 0.0
            else:
                _build(so)
            lib = ctypes.CDLL(str(so))
            # pointers and the stream as c_void_p: a bare int would be cut
            # to 32 bits
            lib.srt_axpy_f32.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64, ctypes.c_void_p]
            lib.srt_axpy_f32.restype = ctypes.c_int
            _LIB = lib
        return _LIB
