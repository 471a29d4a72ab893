"""Cached (materialized) plans: ``df.cache()`` — the port of
``spark_rapids_tpu/exec/cache.py``.

Reference analogue: ParquetCachedBatchSerializer keeps ``df.cache()`` as
columnar batches. Here the storage belongs to the LOGICAL node, so every
execution of the same DataFrame after the first skips the upload and the
upstream work: the device path serves its cached ``DeviceTable``s, the host
engine its ``HostTable``s. The device batches are registered with the
buffer catalog (memory/catalog.py) as spillable at broadcast priority, so
they yield device memory under pressure and come back on the next read.

The node keeps each batch for the next execution, so it takes the
exclusive-ownership mark off a batch before its consumer sees it
(``take_exclusive``): a donating fused stage above must not free planes
the cache serves again.

With ``spark.rapids.tpu.cache.compressionCodec=zlib`` the host cache keeps
compressed frames of the shuffle serializer (shuffle/serializer.py) instead
of live tables; lz4 needs the native library (ROADMAP Queue 1: multi-GPU
across processes).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..memory.catalog import SpillPriorities, get_catalog
from ..plan.physical import PhysicalPlan
from .base import TpuExec

__all__ = ["CacheStorage", "CpuCacheExec", "TpuCacheExec",
           "CACHE_COMPRESS_CODEC", "CACHE_HITS"]

#: the host cache's codec: "none" (live tables) or "zlib" (frames)
CACHE_COMPRESS_CODEC = "spark.rapids.tpu.cache.compressionCodec"
CACHE_HITS = "cacheHits"


class CacheStorage:
    def __init__(self):
        self.host: Dict[int, List[HostTable]] = {}
        #: the compressed host cache: serialised frames
        self.host_blobs: Dict[int, List[bytes]] = {}
        # device entries are SpillableDeviceTable handles
        self.device: Dict[int, list] = {}


class CpuCacheExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, storage: CacheStorage,
                 codec: str = "none"):
        self.child = child
        self.children = (child,)
        self.storage = storage
        self.codec = codec
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        from ..shuffle.serializer import deserialize_table, serialize_table
        blobs = self.storage.host_blobs.get(pidx)
        if blobs is not None:
            for blob in blobs:
                yield deserialize_table(blob)
            return
        cached = self.storage.host.get(pidx)
        if cached is not None:
            yield from cached
            return
        acc: List[HostTable] = []
        for b in self.child.execute(pidx):
            acc.append(b)
            yield b
        if self.codec != "none":
            self.storage.host_blobs[pidx] = [serialize_table(b, self.codec)
                                             for b in acc]
            return
        self.storage.host[pidx] = acc


class TpuCacheExec(TpuExec):
    """The first full read of a partition registers its batches with the
    catalog; later reads get them back (restored if they spilled) and count
    ``cacheHits``."""

    def __init__(self, child: PhysicalPlan, storage: CacheStorage,
                 conf=None):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.storage = storage
        self.conf = conf
        self.schema = child.schema
        self.metrics[CACHE_HITS] = 0

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        cached = self.storage.device.get(pidx)
        if cached is not None:
            self.metrics[CACHE_HITS] += 1
            for handle in cached:
                self.account_batch()
                yield handle.get()
            return
        from .transitions import take_exclusive
        acc: List[DeviceTable] = []
        for b in self.child_device_batches(pidx):
            # kept for the next execution: no donation downstream
            take_exclusive(b)
            acc.append(b)
            self.account_batch()
            yield b
        # registered only after a full drain: an abandoned generator (under
        # a limit) leaves no catalog entry behind
        if acc:
            catalog = get_catalog(self.conf, acc[0].device)
            self.storage.device[pidx] = [
                catalog.register(b, SpillPriorities.BROADCAST) for b in acc]
        else:
            self.storage.device[pidx] = []
