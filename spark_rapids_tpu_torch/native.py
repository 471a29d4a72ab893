"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain C
interface, at first use, and reached through ``ctypes``. The library is
named by a content hash of the sources, so an edit rebuilds and an
unchanged tree reuses the last build. A failed build raises with nvcc's
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
               "-O3", "-Xcompiler", "-fPIC"]

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


def _run_all(cmds) -> None:
    """Runs the commands side by side; raises with the output of the first
    that fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def _build(so: Path) -> None:
    global build_seconds
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    sources = sorted(_SRC_DIR.glob("*.cu"))
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    _run_all([[nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for src, o in zip(sources, objs)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    for o in objs:
        o.unlink()
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
            lib.srt_nfa_match.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.srt_nfa_match.restype = ctypes.c_int
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.srt_pq_expand_hybrid.argtypes = [ptr, i32, ptr, i64, i64,
                                                 ptr, ptr]
            lib.srt_pq_gather_fixed.argtypes = [
                i32, ptr, ptr, ptr, i64, ptr, i64, ptr, i64, i64, i64, ptr,
                ptr]
            lib.srt_pq_gather_byte_array.argtypes = [
                ptr, ptr, ptr, i64, ptr, ptr, ptr, i64, i64, i64, i64, i64,
                i64, i64, i64, ptr, ptr, ptr]
            for fn in (lib.srt_pq_expand_hybrid, lib.srt_pq_gather_fixed,
                       lib.srt_pq_gather_byte_array):
                fn.restype = ctypes.c_int
            lib.srt_ba_walk.argtypes = [ptr, i64, i64, ptr, ptr]
            lib.srt_ba_walk.restype = ctypes.c_int64
            lib.srt_d128_mul_rescaled.argtypes = [
                ptr, i32, ptr, i32, i64, i32, i32, ptr, ptr, ptr]
            lib.srt_d128_rescale.argtypes = [ptr, i32, i64, i32, i32, ptr,
                                             ptr, ptr]
            lib.srt_d128_segment_sum.argtypes = [
                ptr, i32, ptr, ptr, i32, i64, i64, i32, ptr, ptr, ptr, ptr]
            for fn in (lib.srt_d128_mul_rescaled, lib.srt_d128_rescale,
                       lib.srt_d128_segment_sum):
                fn.restype = ctypes.c_int
            lib.srt_d128_segment_sum_scratch.argtypes = [i64, i64]
            lib.srt_d128_segment_sum_scratch.restype = ctypes.c_int64
            lib.srt_d128_segment_sum_small_cap.argtypes = []
            lib.srt_d128_segment_sum_small_cap.restype = ctypes.c_int32
            lib.srt_seg_scan.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr,
                                         ptr, ptr]
            lib.srt_frame_bounds.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                             i32, i32, ptr]
            lib.srt_frame_reduce.argtypes = [ptr, ptr, ptr, ptr, i64, i32,
                                             i32, i64, ptr, ptr, ptr, ptr]
            for fn in (lib.srt_seg_scan, lib.srt_frame_bounds,
                       lib.srt_frame_reduce):
                fn.restype = ctypes.c_int
            lib.srt_seg_scan_scratch_bytes.argtypes = [i64]
            lib.srt_frame_reduce_scratch_bytes.argtypes = [i64, i64]
            for fn in (lib.srt_seg_scan_scratch_bytes,
                       lib.srt_frame_reduce_scratch_bytes):
                fn.restype = ctypes.c_int64
            _LIB = lib
        return _LIB
