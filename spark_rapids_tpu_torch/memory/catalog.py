"""Buffer catalog: the process registry of spillable device tables — the
port of ``spark_rapids_tpu/memory/catalog.py`` for what the grace join, the
out-of-core sort and the upload cache use (reference:
RapidsBufferCatalog.scala:40,156, SpillableColumnarBatch.scala,
DeviceMemoryEventHandler.scala:33, SpillPriorities.scala).

An operator registers a table and gets a ``SpillableDeviceTable`` handle;
when a registration or a restore would pass the device budget, the
lowest-priority unpinned buffers move down a tier (device -> host, and
host -> disk when the host tier is full), and ``acquire`` brings a buffer
back. The spill order is the JAX package's: lowest priority first, ties
oldest first, a pinned buffer skipped and queued again behind the others.

The device budget follows the JAX formula: ``memory.pool.size``, or when
that is 0, ``allocFraction`` (capped by ``maxAllocFraction``) of the
session device's memory. Those three keys run their JAX defaults until
ROADMAP Queue 1 (memory and robustness) reads them.

Not ported: the memory profiler, tracer spans, the debug allocator and the
strict pool mode (ROADMAP Queue 1: memory and robustness; breadth).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..columnar.device import DeviceTable
from ..conf import (DISK_SPILL_CHECKSUM, DISK_SPILL_DIRECT,
                    HOST_SPILL_STORAGE_SIZE, OOM_SPILL_ENABLED, RapidsConf)
from .stores import (DeviceStore, DiskStore, HostStore, StorageTier,
                     StoredTable, _host_arrays_to_table,
                     _table_to_host_arrays)

__all__ = ["SpillPriorities", "BufferCatalog", "SpillableDeviceTable",
           "get_catalog", "set_catalog", "peek_catalog"]

_POOL_SIZE = "spark.rapids.tpu.memory.pool.size"
_ALLOC_FRACTION = "spark.rapids.memory.gpu.allocFraction"
_MAX_ALLOC_FRACTION = "spark.rapids.memory.gpu.maxAllocFraction"
#: the JAX package's device memory when it cannot read one (8 GiB)
_FALLBACK_DEVICE_BYTES = 8 * 1024 ** 3


class SpillPriorities:
    """Lower value spills first (reference: SpillPriorities.scala)."""
    INPUT = 0
    OUTPUT_FOR_SHUFFLE = 10
    BROADCAST = 50
    ACTIVE_ON_DECK = 100


class _SpillQueue:
    """Pop-lowest-priority queue with removal by handle (the JAX package's
    ``native.HashedPriorityQueue``): a heap of ``(priority, handle)`` with
    lazy deletion. Handles grow, so equal priorities pop oldest push
    first, as the JAX queue's ordered map pops them."""

    def __init__(self):
        self._heap: List[Tuple[int, int]] = []
        self._entries: Dict[int, Tuple[int, int]] = {}
        self._next = 1

    def push(self, priority: int, payload: int) -> int:
        h = self._next
        self._next += 1
        self._entries[h] = (priority, payload)
        heapq.heappush(self._heap, (priority, h))
        return h

    def remove(self, handle: int) -> bool:
        return self._entries.pop(handle, None) is not None

    def pop(self) -> Optional[Tuple[int, int]]:
        """-> (priority, payload) of the lowest entry, or None."""
        while self._heap:
            _, h = heapq.heappop(self._heap)
            entry = self._entries.pop(h, None)
            if entry is not None:
                return entry
        return None

    def __len__(self) -> int:
        return len(self._entries)


def _device_memory_bytes(device: Optional[torch.device]) -> int:
    """The session device's memory; the JAX package's 8 GiB where there is
    no CUDA device to ask (the CPU)."""
    if device is not None and device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return _FALLBACK_DEVICE_BYTES


class BufferCatalog:
    def __init__(self, conf: Optional[RapidsConf] = None,
                 device_limit: Optional[int] = None,
                 host_limit: Optional[int] = None,
                 disk_dir: Optional[str] = None,
                 device: Optional[torch.device] = None):
        conf = conf or RapidsConf()
        if device_limit is None:
            device_limit = conf.get(_POOL_SIZE)
            if not device_limit:
                frac = min(float(conf.get(_ALLOC_FRACTION)),
                           float(conf.get(_MAX_ALLOC_FRACTION)))
                device_limit = int(_device_memory_bytes(device) * frac)
        if host_limit is None:
            host_limit = conf.get(HOST_SPILL_STORAGE_SIZE)
        self.device = DeviceStore(device_limit)
        self.host = HostStore(host_limit)
        self.disk = DiskStore(disk_dir,
                              direct=bool(conf.get(DISK_SPILL_DIRECT)),
                              checksum=bool(conf.get(DISK_SPILL_CHECKSUM)))
        self._buffers: Dict[int, StoredTable] = {}
        self._spill_pq = _SpillQueue()
        self._pq_handles: Dict[int, int] = {}  # buffer_id -> queue handle
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self._oom_callbacks: List[Callable[[], int]] = []
        self._oom_spill = bool(conf.get(OOM_SPILL_ENABLED))
        self.oom_events = 0
        self.spill_count = {StorageTier.HOST: 0, StorageTier.DISK: 0}
        self.spilled_bytes = {StorageTier.HOST: 0, StorageTier.DISK: 0}
        # device memory held outside the catalog (the upload cache): name ->
        # byte-count function, and the last count each gave
        self._external_bytes: Dict[str, Callable[[], int]] = {}
        self._external_cache: Dict[str, int] = {}
        self.peak_device_bytes = 0
        self.oom_callback_errors = 0
        self.diagnostics: deque = deque(maxlen=64)

    # -- registration ---------------------------------------------------------
    def register(self, table: DeviceTable,
                 priority: int = SpillPriorities.INPUT
                 ) -> "SpillableDeviceTable":
        nbytes = table.nbytes()
        with self._lock:
            if not self.device.fits(nbytes) and self._oom_spill:
                self.synchronous_spill(
                    nbytes - (self.device.limit_bytes - self.device.used_bytes))
            bid = next(self._ids)
            self._buffers[bid] = StoredTable(bid, table, priority, nbytes)
            self.device.used_bytes += nbytes
            self._note_peak_locked()
            self._pq_handles[bid] = self._spill_pq.push(priority, bid)
        return SpillableDeviceTable(self, bid)

    # -- spill machinery ------------------------------------------------------
    def synchronous_spill(self, target_bytes: int) -> int:
        """Move the lowest-priority unpinned device buffers down a tier
        until ``target_bytes`` are freed (reference:
        RapidsBufferStore.synchronousSpill) -> the bytes freed."""
        freed = 0
        with self._lock:
            pinned = []  # (priority, bid) popped while in use; queued again
            try:
                while freed < target_bytes:
                    entry = self._spill_pq.pop()
                    if entry is None:
                        break
                    priority, bid = entry
                    self._pq_handles.pop(bid, None)
                    stored = self._buffers.get(bid)
                    if stored is None or stored.tier != StorageTier.DEVICE:
                        continue
                    if stored.refcount > 0:
                        pinned.append((priority, bid))
                        continue
                    try:
                        self._spill_one(stored)
                    except Exception:
                        # the spill target failed (a full disk): the buffer
                        # stays spillable for a later pass
                        pinned.append((priority, bid))
                        raise
                    freed += stored.size_bytes
            finally:
                for priority, bid in pinned:
                    self._pq_handles[bid] = self._spill_pq.push(priority, bid)
        return freed

    def _spill_one(self, stored: StoredTable):
        """The JAX ``_spill_one_inner`` (its wrapper only adds metrics and
        a tracer span)."""
        # device -> host; when the host tier is full, its lowest priority
        # buffers go to disk first
        if not self.host.fits(stored.size_bytes):
            self._spill_host_to_disk(stored.size_bytes)
        if self.host.fits(stored.size_bytes):
            self.host.put(stored)
            self.device.used_bytes -= stored.size_bytes
            self.spill_count[StorageTier.HOST] += 1
            self.spilled_bytes[StorageTier.HOST] += stored.size_bytes
        else:  # straight to disk (the host tier is full after its spills)
            arrays, meta = _table_to_host_arrays(stored.device_table)
            stored.host_arrays = arrays
            stored.meta = meta
            stored.device_table = None
            self.disk.put(stored)
            self.device.used_bytes -= stored.size_bytes
            self.spill_count[StorageTier.DISK] += 1
            self.spilled_bytes[StorageTier.DISK] += stored.size_bytes

    def _spill_host_to_disk(self, need_bytes: int):
        victims = sorted((s for s in self._buffers.values()
                          if s.tier == StorageTier.HOST and s.refcount == 0),
                         key=lambda s: s.priority)
        for s in victims:
            if self.host.fits(need_bytes):
                break
            self.disk.put(s)
            self.host.used_bytes -= s.size_bytes
            self.spill_count[StorageTier.DISK] += 1
            self.spilled_bytes[StorageTier.DISK] += s.size_bytes

    # -- access ---------------------------------------------------------------
    def acquire(self, buffer_id: int) -> DeviceTable:
        """Pin a buffer and return it on the device, restored from a lower
        tier if it was spilled."""
        with self._lock:
            stored = self._buffers[buffer_id]
            if stored.closed:
                raise RuntimeError(f"buffer {buffer_id} already closed")
            # pin first, so a spill pass the restore starts cannot take it
            stored.refcount += 1
            if stored.tier == StorageTier.DISK:
                stored.host_arrays = self.disk.load(stored)
                self.disk.drop(stored)
                stored.tier = StorageTier.HOST
                self.host.used_bytes += stored.size_bytes
            if stored.tier == StorageTier.HOST:
                if not self.device.fits(stored.size_bytes) and self._oom_spill:
                    self.synchronous_spill(stored.size_bytes)
                table = _host_arrays_to_table(stored.host_arrays, stored.meta)
                self.host.drop(stored)
                stored.device_table = table
                stored.tier = StorageTier.DEVICE
                self.device.used_bytes += stored.size_bytes
                self._note_peak_locked()
                if buffer_id not in self._pq_handles:
                    self._pq_handles[buffer_id] = \
                        self._spill_pq.push(stored.priority, buffer_id)
            return stored.device_table

    def release(self, buffer_id: int):
        with self._lock:
            stored = self._buffers.get(buffer_id)
            if stored is not None:
                stored.refcount = max(0, stored.refcount - 1)

    def close_buffer(self, buffer_id: int):
        with self._lock:
            stored = self._buffers.pop(buffer_id, None)
            if stored is None:
                return
            stored.closed = True
            handle = self._pq_handles.pop(buffer_id, None)
            if handle is not None:
                self._spill_pq.remove(handle)
            if stored.tier == StorageTier.DEVICE:
                self.device.used_bytes -= stored.size_bytes
                stored.device_table = None
            elif stored.tier == StorageTier.HOST:
                self.host.drop(stored)
            else:
                self.disk.drop(stored)

    def tier_of(self, buffer_id: int) -> int:
        return self._buffers[buffer_id].tier

    def assert_no_leaks(self):
        """Every registered buffer closed, no pin outstanding."""
        with self._lock:
            leaks = [(bid, s.refcount) for bid, s in self._buffers.items()]
        if leaks:
            detail = "; ".join(f"buffer {bid} refcount={rc}"
                               for bid, rc in leaks[:10])
            raise AssertionError(f"{len(leaks)} leaked buffer(s): {detail}")

    def register_oom_callback(self, cb: Callable[[], int]) -> None:
        """A zero-argument callable run on device OOM before the catalog
        spills; it returns the bytes it released (droppable device caches,
        such as the upload cache, hook in here)."""
        with self._lock:
            if cb not in self._oom_callbacks:
                self._oom_callbacks.append(cb)

    # -- device memory held outside the catalog -------------------------------
    def register_external_bytes(self, name: str,
                                fn: Callable[[], int]) -> None:
        """Count device memory held outside the spill framework (the upload
        cache) in the catalog's use and peak. ``fn`` returns the source's
        device bytes; a source that raises counts 0."""
        with self._lock:
            self._external_bytes[name] = fn
            self._refresh_external_locked()
            self._note_peak_locked()

    def _refresh_external_locked(self) -> Dict[str, int]:
        for name, fn in self._external_bytes.items():
            try:
                self._external_cache[name] = int(fn() or 0)
            except Exception:  # a broken source counts 0, as in JAX
                self._external_cache[name] = 0
        return dict(self._external_cache)

    def note_external_change(self) -> None:
        """External sources call this after their device bytes grew, so the
        peak counts them."""
        with self._lock:
            self._refresh_external_locked()
            self._note_peak_locked()

    def external_device_bytes(self) -> int:
        with self._lock:
            return sum(self._refresh_external_locked().values())

    def device_in_use_bytes(self) -> int:
        """Catalog-resident plus externally held device bytes."""
        with self._lock:
            return self.device.used_bytes \
                + sum(self._refresh_external_locked().values())

    def _note_peak_locked(self) -> None:
        used = self.device.used_bytes + sum(self._external_cache.values())
        if used > self.peak_device_bytes:
            self.peak_device_bytes = used

    def handle_device_oom(self, context: str = "") -> int:
        """Device OOM (reference: DeviceMemoryEventHandler.scala:33): run
        the OOM callbacks, then move everything spillable down a tier (the
        size the failed allocation needed is unknown). -> bytes freed, 0
        when nothing was left to spill or drop."""
        cb_freed = 0
        with self._lock:
            callbacks = list(self._oom_callbacks)
        for cb in callbacks:
            try:
                cb_freed += int(cb() or 0)
            except Exception as e:
                # a broken cache dropper must not stop the recovery, nor
                # fail in silence: its bytes stay resident
                name = getattr(cb, "__qualname__",
                               getattr(cb, "__name__", repr(cb)))
                msg = f"OOM callback {name} failed: {type(e).__name__}: {e}"
                with self._lock:
                    self.oom_callback_errors += 1
                    self.diagnostics.append(msg)
                warnings.warn(msg, RuntimeWarning)
        with self._lock:
            target = self.device.used_bytes
        freed = self.synchronous_spill(max(target, 1))
        with self._lock:
            self.oom_events += 1
            self._refresh_external_locked()
        return freed + cb_freed

    def stats(self) -> dict:
        with self._lock:
            tiers: Dict[str, int] = {}
            for s in self._buffers.values():
                name = StorageTier.NAMES[s.tier]
                tiers[name] = tiers.get(name, 0) + 1
            return {
                "buffers": len(self._buffers),
                "tiers": tiers,
                "device_used": self.device.used_bytes,
                "host_used": self.host.used_bytes,
                "disk_used": self.disk.used_bytes,
                "external_bytes": self._refresh_external_locked(),
                "peak_device_bytes": self.peak_device_bytes,
                "spill_count": dict(self.spill_count),
                "spilled_bytes": dict(self.spilled_bytes),
                "oom_events": self.oom_events,
                "oom_callback_errors": self.oom_callback_errors,
            }

    def counters(self) -> dict:
        """Flat counters, spill tiers by name."""
        with self._lock:
            ext = self._refresh_external_locked()
            return {
                "buffers": len(self._buffers),
                "device_used_bytes": self.device.used_bytes,
                "host_used_bytes": self.host.used_bytes,
                "disk_used_bytes": self.disk.used_bytes,
                "external_device_bytes": sum(ext.values()),
                "peak_device_bytes": self.peak_device_bytes,
                "spills_to_host": self.spill_count[StorageTier.HOST],
                "spills_to_disk": self.spill_count[StorageTier.DISK],
                "spilled_bytes_host": self.spilled_bytes[StorageTier.HOST],
                "spilled_bytes_disk": self.spilled_bytes[StorageTier.DISK],
                "oom_events": self.oom_events,
                "oom_callback_errors": self.oom_callback_errors,
            }


class SpillableDeviceTable:
    """Operator-facing handle (reference: SpillableColumnarBatch):
    ``with handle as table`` pins the table for the block; ``get()``
    returns it without a pin."""

    def __init__(self, catalog: BufferCatalog, buffer_id: int):
        self.catalog = catalog
        self.buffer_id = buffer_id

    def get(self) -> DeviceTable:
        """The table on the device (restored from a lower tier). The
        acquire and release run under one hold of the catalog lock, so no
        spill pass runs between them."""
        with self.catalog._lock:
            table = self.catalog.acquire(self.buffer_id)
            self.catalog.release(self.buffer_id)
        return table

    def __enter__(self) -> DeviceTable:
        return self.catalog.acquire(self.buffer_id)

    def __exit__(self, *exc):
        self.catalog.release(self.buffer_id)

    @property
    def tier(self) -> int:
        return self.catalog.tier_of(self.buffer_id)

    def close(self):
        self.catalog.close_buffer(self.buffer_id)


_GLOBAL: Optional[BufferCatalog] = None
_GLOBAL_LOCK = threading.Lock()


def get_catalog(conf: Optional[RapidsConf] = None,
                device: Optional[torch.device] = None) -> BufferCatalog:
    """The process catalog, made on first use from ``conf`` (the session
    configuration of the first query that needs one) and the memory of
    ``device``; ``set_catalog`` replaces it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = BufferCatalog(conf, device=device)
        return _GLOBAL


def set_catalog(catalog: Optional[BufferCatalog]):
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = catalog


def peek_catalog() -> Optional[BufferCatalog]:
    """The process catalog if one exists; never makes one."""
    with _GLOBAL_LOCK:
        return _GLOBAL
