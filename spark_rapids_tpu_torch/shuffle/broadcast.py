"""Cross-process broadcast materialisation — the port of
``spark_rapids_tpu/shuffle/broadcast.py`` (reference:
GpuBroadcastExchangeExec.scala:336-345: the build side runs once, is
serialised to host buffers, and every executor re-materialises it from
those bytes).

The designated builder runs the build, serialises it once and publishes it
on its shuffle transport under a reserved shuffle id; every other executor
fetches the bytes, deserialises them and uploads the table to its own
device, where it stays registered in the spill catalog at broadcast
priority (evicted last). No executor re-runs the build.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

from ..columnar.device import DeviceTable, resolve_device
from . import telemetry
from .serializer import deserialize_table, serialize_table
from .transport import BlockId, ShuffleFetchFailedException, ShuffleTransport

__all__ = ["BroadcastManager", "BROADCAST_SHUFFLE_ID"]

#: the reserved shuffle id of broadcast blocks (never a real shuffle)
BROADCAST_SHUFFLE_ID = -1


class BroadcastManager:
    """One executor's broadcast cache, backed by its shuffle transport."""

    def __init__(self, transport: ShuffleTransport, catalog=None,
                 min_bucket: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.transport = transport
        self.catalog = catalog
        self.min_bucket = min_bucket
        self.device = resolve_device(device, "BroadcastManager")
        self._handles: Dict[int, object] = {}   # bcast id -> handle or table
        self._lock = threading.Lock()
        self.builds = 0     # builds run here
        self.fetches = 0    # re-materialisations from a peer's bytes

    @staticmethod
    def block_of(bcast_id: int) -> BlockId:
        return BlockId(BROADCAST_SHUFFLE_ID, bcast_id, 0)

    def publish(self, bcast_id: int, table: DeviceTable) -> None:
        """The builder's side: serialise once and make it fetchable."""
        t0 = telemetry.clock()
        payload = serialize_table(table.to_host())
        telemetry.note_transfer(
            "transport", "serialize", shuffle_id=BROADCAST_SHUFFLE_ID,
            map_id=bcast_id, partition=0, t0=t0,
            logical_bytes=table.nbytes, wire_bytes=len(payload))
        t1 = telemetry.clock()
        self.transport.publish(self.block_of(bcast_id), payload)
        telemetry.note_transfer(
            "transport", "publish", shuffle_id=BROADCAST_SHUFFLE_ID,
            map_id=bcast_id, partition=0, t0=t1, wire_bytes=len(payload))

    def build_and_publish(self, bcast_id: int,
                          build_fn: Callable[[], DeviceTable]) -> DeviceTable:
        cached = self._cached(bcast_id)
        if cached is not None:
            return cached
        table = build_fn()
        self.builds += 1
        self.publish(bcast_id, table)
        return self._cache(bcast_id, table)

    def get(self, bcast_id: int) -> DeviceTable:
        """The consumer's side: the local cache, else fetch, deserialise
        and upload to this executor's device."""
        cached = self._cached(bcast_id)
        if cached is not None:
            return cached
        t0 = telemetry.clock()
        for _bid, payload in self.transport.fetch([self.block_of(bcast_id)]):
            self.fetches += 1
            telemetry.note_transfer(
                "transport", "fetch", shuffle_id=BROADCAST_SHUFFLE_ID,
                map_id=bcast_id, partition=0, t0=t0,
                wire_bytes=len(payload))
            t1 = telemetry.clock()
            host = deserialize_table(payload)
            table = DeviceTable.from_host(host, self.min_bucket, self.device)
            telemetry.note_transfer(
                "transport", "deserialize", shuffle_id=BROADCAST_SHUFFLE_ID,
                map_id=bcast_id, partition=0, t0=t1,
                logical_bytes=host.nbytes)
            return self._cache(bcast_id, table)
        raise ShuffleFetchFailedException(self.block_of(bcast_id),
                                          "broadcast block unavailable")

    def get_or_build(self, bcast_id: int,
                     build_fn: Optional[Callable[[], DeviceTable]] = None
                     ) -> DeviceTable:
        """Fetch when a peer built it already, else build here and
        publish."""
        try:
            return self.get(bcast_id)
        except ShuffleFetchFailedException:
            if build_fn is None:
                raise
            return self.build_and_publish(bcast_id, build_fn)

    def _cached(self, bcast_id: int) -> Optional[DeviceTable]:
        with self._lock:
            entry = self._handles.get(bcast_id)
        if entry is None:
            return None
        return entry if isinstance(entry, DeviceTable) else entry.get()

    def _cache(self, bcast_id: int, table: DeviceTable) -> DeviceTable:
        entry: object = table
        if self.catalog is not None:
            from ..memory.catalog import SpillPriorities
            entry = self.catalog.register(table, SpillPriorities.BROADCAST)
        with self._lock:
            self._handles[bcast_id] = entry
        return table if isinstance(entry, DeviceTable) else entry.get()

    def close(self) -> None:
        """Release every cached broadcast's catalog handle."""
        with self._lock:
            entries, self._handles = list(self._handles.values()), {}
        for e in entries:
            if not isinstance(e, DeviceTable):
                e.close()
