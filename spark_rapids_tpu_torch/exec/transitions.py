"""Host<->device transitions and batch coalescing — the port of
``spark_rapids_tpu/exec/transitions.py``.

- ``HostToDeviceExec``   ~ GpuRowToColumnarExec / HostColumnarToGpu
- ``DeviceToHostExec``   ~ GpuColumnarToRowExec / GpuBringBackToHost
- ``TpuCoalesceBatchesExec`` ~ GpuCoalesceBatches (GpuCoalesceBatches.scala:528)

The transition inserter (plan/transitions.py) places these where device
sections start and end, like GpuTransitionOverrides.scala:37.

The upload cache keeps each source batch's upload device-resident across
executions, as the JAX package does: a source that re-yields the same host
batch (the in-memory source caches its decoded batches) is served without
an upload. A cached ``DeviceTable`` is shared by every later run, so no
operator writes into the tensors of an input batch. Its byte budget bounds
it, and it registers with the buffer catalog: ``handle_device_oom`` drops
it (``clear_upload_cache`` is an OOM callback), and its bytes count in the
catalog's device use and peak. Not ported: the exclusive-ownership marks
that let a fused stage donate its input buffers (ROADMAP Queue 1: memory
and robustness).
"""
from __future__ import annotations

import threading
import weakref
from typing import Iterator, List, Optional

import torch

from ..columnar.device import (DeviceTable, concat_device_tables,
                               to_host_batched)
from ..columnar.host import HostTable
from ..conf import RapidsConf
from ..memory.catalog import get_catalog
from ..plan.physical import PhysicalPlan
from .base import NUM_OUTPUT_BATCHES, TpuExec

__all__ = ["HostToDeviceExec", "DeviceToHostExec", "TpuCoalesceBatchesExec",
           "clear_upload_cache", "upload_cache_stats"]

UPLOAD_BYTES = "uploadBytes"
UPLOAD_CACHE_HITS = "uploadCacheHits"
COALESCED_BYTES = "coalescedBytes"

# Upload memoization keyed by host-batch IDENTITY: sources that cache their
# decoded batches re-yield the same objects. A weakref death-callback drops
# the entry the moment its source batch is collected, so a recycled id()
# never aliases a stale upload. The inner key is (min_bucket, device): a CPU
# and a CUDA session in one process never share an entry.
#
# All cache state is guarded by _UPLOAD_LOCK, an RLock: the death-callback
# can fire from a GC pass at any allocation, also while this thread holds
# the lock.
_UPLOAD_LOCK = threading.RLock()
_UPLOAD_CACHE: dict = {}   # id(batch) -> (weakref, {(min_bucket, device): DeviceTable})
_CACHED_BYTES = 0          # running device-byte total of cached uploads
_CACHE_HITS = 0
_CACHE_INSERTS = 0
_CACHE_EVICTIONS = 0
#: a weak reference to the buffer catalog the cache last registered with
_HOOKED = None


def _drop_entry(key: int) -> None:
    """Weakref death-callback: remove a dead batch's uploads and keep the
    running byte counter consistent."""
    global _CACHED_BYTES, _CACHE_EVICTIONS
    with _UPLOAD_LOCK:
        entry = _UPLOAD_CACHE.pop(key, None)
        if entry is not None:
            _CACHED_BYTES -= sum(t.nbytes() for t in entry[1].values())
            _CACHE_EVICTIONS += 1


def clear_upload_cache() -> int:
    """Drop all device-resident scan uploads; returns the bytes released."""
    global _CACHED_BYTES
    with _UPLOAD_LOCK:
        freed = _CACHED_BYTES
        _UPLOAD_CACHE.clear()
        _CACHED_BYTES = 0
    return freed


def upload_cache_stats() -> dict:
    """Process-wide upload-cache counters (compare deltas: every session of
    the process shares them)."""
    with _UPLOAD_LOCK:
        return {"entries": len(_UPLOAD_CACHE), "bytes": _CACHED_BYTES,
                "hits": _CACHE_HITS, "inserts": _CACHE_INSERTS,
                "evictions": _CACHE_EVICTIONS}


def _cached_bytes() -> int:
    with _UPLOAD_LOCK:
        return _CACHED_BYTES


def _hook_oom(conf: Optional[RapidsConf], device: torch.device) -> None:
    """Register the cache with the process buffer catalog, once per
    catalog: dropped on device OOM, its bytes in the catalog's device use
    and peak. Called outside ``_UPLOAD_LOCK`` (the lock order is catalog,
    then cache)."""
    global _HOOKED
    cat = get_catalog(conf, device)
    if _HOOKED is None or _HOOKED() is not cat:
        cat.register_oom_callback(clear_upload_cache)
        cat.register_external_bytes("upload_cache", _cached_bytes)
        _HOOKED = weakref.ref(cat)
    cat.note_external_change()


class HostToDeviceExec(TpuExec):
    """Uploads each host batch into a bucketed device batch on ``device``,
    through the upload cache when ``cache_max_bytes`` is above 0."""

    def __init__(self, child: PhysicalPlan, min_bucket: int,
                 device: torch.device, cache_max_bytes: int = 0,
                 conf: Optional[RapidsConf] = None):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.schema = child.schema
        self.min_bucket = min_bucket
        self.device = device
        self.cache_max_bytes = cache_max_bytes
        self.conf = conf
        self.metrics[UPLOAD_BYTES] = 0
        self.metrics[UPLOAD_CACHE_HITS] = 0

    def _upload(self, batch: HostTable) -> DeviceTable:
        global _CACHED_BYTES, _CACHE_HITS, _CACHE_INSERTS
        if not self.cache_max_bytes:
            dtb = DeviceTable.from_host(batch, self.min_bucket, self.device)
            self.metrics[UPLOAD_BYTES] += dtb.nbytes()
            return dtb
        key = id(batch)
        inner = (self.min_bucket, self.device)
        with _UPLOAD_LOCK:
            entry = _UPLOAD_CACHE.get(key)
            hit = None
            if entry is not None and entry[0]() is batch:
                hit = entry[1].get(inner)
                if hit is not None:
                    _CACHE_HITS += 1
        if hit is not None:
            self.metrics[UPLOAD_CACHE_HITS] += 1
            return hit
        dtb = DeviceTable.from_host(batch, self.min_bucket, self.device)
        nbytes = dtb.nbytes()
        self.metrics[UPLOAD_BYTES] += nbytes
        cached = False
        with _UPLOAD_LOCK:
            # past the budget: served uncached, nothing evicted
            if _CACHED_BYTES + nbytes <= self.cache_max_bytes:
                entry = _UPLOAD_CACHE.get(key)
                if entry is None or entry[0]() is not batch:
                    if entry is not None:  # a stale id-aliased entry
                        _CACHED_BYTES -= sum(
                            t.nbytes() for t in entry[1].values())
                    ref = weakref.ref(batch,
                                      lambda _r, k=key: _drop_entry(k))
                    entry = _UPLOAD_CACHE[key] = (ref, {})
                if inner not in entry[1]:
                    entry[1][inner] = dtb
                    _CACHED_BYTES += nbytes
                    _CACHE_INSERTS += 1
                    cached = True
        if cached:
            _hook_oom(self.conf, self.device)
        return dtb

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        for batch in self.child.execute(pidx):
            dtb = self._upload(batch)
            self.account_batch(batch.num_rows)
            yield dtb


class DeviceToHostExec(PhysicalPlan):
    """Downloads the device batches, compacted to their active rows: with
    ``bulk`` (``spark.rapids.tpu.async.enabled``), a partition's batches
    are drained first and downloaded together, one device-to-host copy per
    plane type (``to_host_batched``); else each batch as it arrives."""

    def __init__(self, child: TpuExec, bulk: bool = True):
        self.child = child
        self.children = (child,)
        self.schema = child.schema
        self.bulk = bulk

    @property
    def num_partitions(self) -> int:
        return self.child.num_partitions

    def execute(self, pidx: int) -> Iterator[HostTable]:
        if self.bulk:
            yield from to_host_batched(list(self.child.execute_columnar(pidx)))
            return
        for batch in self.child.execute_columnar(pidx):
            yield batch.to_host()


class TpuCoalesceBatchesExec(TpuExec):
    """Concatenates small device batches up to a target row and/or byte
    goal (reference: the CoalesceGoal lattice, GpuCoalesceBatches.scala:
    93-200): rows (``target_rows``) and bytes (``target_bytes``, the
    TargetSize analogue, so wide schemas flush long before the row goal
    fills). The goals count capacities, not rows, so the accounting reads
    nothing from the device."""

    def __init__(self, child: PhysicalPlan, target_rows: int = 1 << 20,
                 min_bucket: int = 1024, target_bytes: int = 0):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.schema = child.schema
        self.target_rows = target_rows
        self.target_bytes = int(target_bytes)
        self.min_bucket = min_bucket
        self.metrics[COALESCED_BYTES] = 0

    def node_desc(self) -> str:
        goal = f"rows={self.target_rows}"
        if self.target_bytes:
            goal += f" bytes={self.target_bytes}"
        return goal

    def _over_bytes(self, pending_bytes: int, extra: int = 0) -> bool:
        return bool(self.target_bytes) \
            and pending_bytes + extra > self.target_bytes

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        pending: List[DeviceTable] = []
        pending_rows = 0
        pending_bytes = 0
        for batch in self.child_device_batches(pidx):
            n = batch.capacity
            nb = batch.nbytes()
            if pending and (pending_rows + n > self.target_rows
                            or self._over_bytes(pending_bytes, nb)):
                yield self._flush(pending)
                pending, pending_rows, pending_bytes = [], 0, 0
            pending.append(batch)
            pending_rows += n
            pending_bytes += nb
            if pending_rows >= self.target_rows \
                    or self._over_bytes(pending_bytes):
                yield self._flush(pending)
                pending, pending_rows, pending_bytes = [], 0, 0
        if pending:
            yield self._flush(pending)

    def _flush(self, pending: List[DeviceTable]) -> DeviceTable:
        out = concat_device_tables(pending, self.min_bucket)
        self.metrics[NUM_OUTPUT_BATCHES] += 1
        self.metrics[COALESCED_BYTES] += out.nbytes()
        return out
