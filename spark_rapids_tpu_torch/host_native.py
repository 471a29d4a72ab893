"""The host native library (``csrc/host_native.cpp``) — the port of
``spark_rapids_tpu/native/__init__.py``: the LZ4 block codec of the shuffle
serializer, xxhash64, Spark's murmur3 over host columns, a stable hash
partition, a hashed priority queue and a host arena.

The C++ source is built with ``g++ -O3 -shared -fPIC`` at first use into
``_build/`` (named by a hash of the source and the flags, so an edit
rebuilds and an unchanged tree reuses the last build) and reached through
``ctypes``. Worker processes may build at once: each compiles to a file of
its own pid and ``os.replace``s it into place. A failed build raises
``HostNativeBuildError``; nothing carries on without the library (the JAX
package's pure-Python fallbacks are not ported: a codec or a checksum that
silently differs between processes is a fault).

This is host code in both packages, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["load_host_native", "HostNativeBuildError", "lz4_compress",
           "lz4_decompress", "xxhash64", "murmur3_columns", "hash_partition",
           "HashedPriorityQueue", "HostArena"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "host_native.cpp"
_BUILD_DIR = _HERE / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class HostNativeBuildError(RuntimeError):
    """The host library could not be built or loaded."""


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libsrt_host_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise HostNativeBuildError("g++ not found (set CXX): the host "
                                   "native library cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostNativeBuildError(f"g++ failed ({proc.returncode}) on "
                                   f"{_SRC}:\n{proc.stderr}")
    os.replace(tmp, so)


_SIGS = {
    "srtpu_lz4_compress_bound": ("i64", ["i64"]),
    "srtpu_lz4_compress": ("i64", ["ptr", "i64", "ptr", "i64"]),
    "srtpu_lz4_decompress": ("i64", ["ptr", "i64", "ptr", "i64"]),
    "srtpu_xxhash64_buffer": ("u64", ["ptr", "i64", "u64"]),
    "srtpu_murmur3_int": (None, ["ptr", "i64", "ptr"]),
    "srtpu_murmur3_long": (None, ["ptr", "i64", "ptr"]),
    "srtpu_murmur3_double": (None, ["ptr", "i64", "ptr"]),
    "srtpu_murmur3_bytes": (None, ["ptr", "ptr", "i64", "ptr"]),
    "srtpu_hash_partition": (None, ["ptr", "i64", "i32", "ptr", "ptr",
                                    "ptr"]),
    "srtpu_pq_create": ("ptr", []),
    "srtpu_pq_destroy": (None, ["ptr"]),
    "srtpu_pq_push": ("i64", ["ptr", "i64", "i64"]),
    "srtpu_pq_update": ("int", ["ptr", "i64", "i64"]),
    "srtpu_pq_remove": ("int", ["ptr", "i64"]),
    "srtpu_pq_pop": ("int", ["ptr", "ptr", "ptr"]),
    "srtpu_pq_size": ("i64", ["ptr"]),
    "srtpu_arena_create": ("ptr", ["i64"]),
    "srtpu_arena_destroy": (None, ["ptr"]),
    "srtpu_arena_alloc": ("i64", ["ptr", "i64"]),
    "srtpu_arena_free": ("int", ["ptr", "i64"]),
    "srtpu_arena_used": ("i64", ["ptr"]),
    "srtpu_arena_base": ("ptr", ["ptr"]),
}
_CTYPES = {"i64": ctypes.c_int64, "u64": ctypes.c_uint64,
           "i32": ctypes.c_int32, "int": ctypes.c_int,
           "ptr": ctypes.c_void_p, None: None}


def load_host_native() -> ctypes.CDLL:
    """The host library, built on first use; raises if it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = _library_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise HostNativeBuildError(f"cannot load {so}: {e}") from e
            for name, (res, args) in _SIGS.items():
                fn = getattr(lib, name)
                fn.restype = _CTYPES[res]
                fn.argtypes = [_CTYPES[a] for a in args]
            _LIB = lib
        return _LIB


def _ptr(buf) -> int:
    """The address of a numpy array's (or a bytes-like object's) data."""
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


# ---------------------------------------------------------------------------
# LZ4
# ---------------------------------------------------------------------------
def lz4_compress(data: bytes) -> bytes:
    """The LZ4 block of ``data``: the same bytes as the JAX package's
    ``native.lz4_compress``."""
    lib = load_host_native()
    n = len(data)
    src = np.frombuffer(data, dtype=np.uint8) if n else np.zeros(1, np.uint8)
    out = np.empty(lib.srtpu_lz4_compress_bound(n), dtype=np.uint8)
    written = lib.srtpu_lz4_compress(_ptr(src), n, _ptr(out), out.size)
    if written < 0:
        raise RuntimeError("lz4 compression failed")
    return out[:written].tobytes()


def lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    lib = load_host_native()
    src = np.frombuffer(data, dtype=np.uint8) if len(data) \
        else np.zeros(1, np.uint8)
    out = np.empty(max(uncompressed_size, 1), dtype=np.uint8)
    got = lib.srtpu_lz4_decompress(_ptr(src), len(data), _ptr(out),
                                   uncompressed_size)
    if got != uncompressed_size:
        raise RuntimeError(f"lz4 decompression: {got} != {uncompressed_size}")
    return out[:uncompressed_size].tobytes()


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------
def xxhash64(data: bytes, seed: int = 0) -> int:
    lib = load_host_native()
    src = np.frombuffer(data, dtype=np.uint8) if len(data) \
        else np.zeros(1, np.uint8)
    return int(lib.srtpu_xxhash64_buffer(_ptr(src), len(data),
                                         seed & (2 ** 64 - 1)))


def murmur3_columns(columns: List[Tuple[np.ndarray, Optional[np.ndarray]]],
                    seed: int = 42) -> np.ndarray:
    """Spark's chained murmur3_x86_32 over host numpy columns, uint32.

    ``columns`` is a list of (values, validity or None), values a
    fixed-width numpy array or an object array of strings. A null leaves the
    running hash unchanged (Spark's rule). Narrow integers widen to int32; a
    float32 hashes its bits after -0.0 -> 0.0 and NaN -> the canonical NaN
    (float64 is normalised the same way in the C++)."""
    lib = load_host_native()
    n = len(columns[0][0]) if columns else 0
    h = np.full(max(n, 1), seed & 0xFFFFFFFF, dtype=np.uint32)
    for values, validity in columns:
        keep = h.copy() if validity is not None and not validity.all() \
            else None
        if values.dtype.kind in "biu" and values.dtype not in (np.int32,
                                                               np.int64):
            values = values.astype(np.int32)
        elif values.dtype == np.float32:
            f = np.where(values == 0.0, np.float32(0.0), values)
            f = np.where(np.isnan(f), np.float32("nan"), f).astype(np.float32)
            values = f.view(np.int32)
        if values.dtype == object:
            encoded = [v.encode("utf-8") if isinstance(v, str) else b""
                       for v in values]
            offsets = np.zeros(n + 1, dtype=np.int32)
            np.cumsum([len(b) for b in encoded], out=offsets[1:])
            blob = np.frombuffer(b"".join(encoded) or b"\0", dtype=np.uint8)
            lib.srtpu_murmur3_bytes(_ptr(blob), _ptr(offsets), n, _ptr(h))
        elif values.dtype in (np.int32, np.int64, np.float64):
            fn = {np.dtype(np.int32): lib.srtpu_murmur3_int,
                  np.dtype(np.int64): lib.srtpu_murmur3_long,
                  np.dtype(np.float64): lib.srtpu_murmur3_double}[
                      values.dtype]
            v = np.ascontiguousarray(values)
            if n:
                fn(_ptr(v), n, _ptr(h))
        else:
            raise TypeError(f"unhashable column dtype {values.dtype}")
        if keep is not None:
            h[:n] = np.where(validity, h[:n], keep[:n])
    return h[:n]


def hash_partition(hashes: np.ndarray, num_partitions: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (pids int32, counts int64, order int64): Spark's ``Pmod(hash, p)``
    of each uint32 hash taken as int32, the rows per partition, and the
    stable row order that makes each partition one slice."""
    lib = load_host_native()
    h = np.ascontiguousarray(hashes, dtype=np.uint32)
    n = len(h)
    pids = np.empty(max(n, 1), dtype=np.int32)
    counts = np.empty(num_partitions, dtype=np.int64)
    order = np.empty(max(n, 1), dtype=np.int64)
    lib.srtpu_hash_partition(_ptr(h) if n else _ptr(pids), n, num_partitions,
                             _ptr(pids), _ptr(counts), _ptr(order))
    return pids[:n], counts, order[:n]


# ---------------------------------------------------------------------------
# Hashed priority queue and host arena
# ---------------------------------------------------------------------------
class HashedPriorityQueue:
    """Pop-lowest-priority queue with O(log n) update by handle (reference:
    HashedPriorityQueue.java); equal priorities pop in push order."""

    def __init__(self):
        self._lib = load_host_native()
        self._q = self._lib.srtpu_pq_create()

    def push(self, priority: int, payload: int = 0) -> int:
        return int(self._lib.srtpu_pq_push(self._q, priority, payload))

    def update(self, handle: int, priority: int) -> bool:
        return bool(self._lib.srtpu_pq_update(self._q, handle, priority))

    def remove(self, handle: int) -> bool:
        return bool(self._lib.srtpu_pq_remove(self._q, handle))

    def pop(self) -> Optional[Tuple[int, int]]:
        """-> (priority, payload) of the lowest entry, or None."""
        payload, priority = ctypes.c_int64(), ctypes.c_int64()
        if self._lib.srtpu_pq_pop(self._q, ctypes.addressof(payload),
                                  ctypes.addressof(priority)):
            return int(priority.value), int(payload.value)
        return None

    def __len__(self) -> int:
        return int(self._lib.srtpu_pq_size(self._q))

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.srtpu_pq_destroy(self._q)
            self._q = None


class HostArena:
    """Offset-based first-fit host arena with coalescing free (reference:
    RMM ARENA / AddressSpaceAllocator.scala). ``alloc`` returns an offset,
    or None when full (the caller spills and retries)."""

    def __init__(self, capacity: int):
        self._lib = load_host_native()
        self.capacity = capacity
        self._a = self._lib.srtpu_arena_create(capacity)
        if not self._a:
            raise MemoryError(f"arena of {capacity} bytes")

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.srtpu_arena_alloc(self._a, size)
        return None if off < 0 else int(off)

    def free(self, offset: int) -> bool:
        return bool(self._lib.srtpu_arena_free(self._a, offset))

    @property
    def used(self) -> int:
        return int(self._lib.srtpu_arena_used(self._a))

    def _check(self, offset: int, size: int) -> None:
        if offset < 0 or size < 0 or offset + size > self.capacity:
            raise IndexError(f"arena range [{offset}, {offset + size}) "
                             f"outside its {self.capacity} bytes")

    def write(self, offset: int, data: bytes) -> None:
        self._check(offset, len(data))
        ctypes.memmove(self._lib.srtpu_arena_base(self._a) + offset, data,
                       len(data))

    def read(self, offset: int, size: int) -> bytes:
        self._check(offset, size)
        return ctypes.string_at(self._lib.srtpu_arena_base(self._a) + offset,
                                size)

    def __del__(self):
        if getattr(self, "_a", None):
            self._lib.srtpu_arena_destroy(self._a)
            self._a = None
