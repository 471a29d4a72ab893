"""Device-resident shuffle blocks — the port of
``spark_rapids_tpu/shuffle/buffer_catalog.py`` (reference:
ShuffleBufferCatalog.scala + RapidsCachingWriter).

Written shuffle partitions stay on the device as spillable buffers keyed by
(shuffle, map, reduce); readers in the same process take them directly (no
serialize/deserialize round trip), and the spill catalog moves them down a
tier under memory pressure. ``remove_shuffle`` frees a finished shuffle.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..columnar.device import DeviceTable
from ..memory.catalog import (SpillPriorities, SpillableDeviceTable,
                              get_catalog)

__all__ = ["ShuffleBufferCatalog"]

BlockKey = Tuple[int, int, int]  # (shuffle_id, map_id, reduce_id)


class ShuffleBufferCatalog:
    def __init__(self):
        self._blocks: Dict[BlockKey, SpillableDeviceTable] = {}
        self._lock = threading.Lock()

    def put(self, key: BlockKey, table: DeviceTable) -> SpillableDeviceTable:
        handle = get_catalog().register(table,
                                        SpillPriorities.OUTPUT_FOR_SHUFFLE)
        with self._lock:
            old = self._blocks.get(key)
            self._blocks[key] = handle
        if old is not None:  # a re-run map task overwrites its old output
            old.close()
        return handle

    def get(self, key: BlockKey) -> Optional[SpillableDeviceTable]:
        with self._lock:
            return self._blocks.get(key)

    def shuffle_ids(self) -> List[int]:
        with self._lock:
            return sorted({k[0] for k in self._blocks})

    def remove_shuffle(self, shuffle_id: int) -> int:
        """Close every block of a finished shuffle (unregisterShuffle)."""
        with self._lock:
            keys = [k for k in self._blocks if k[0] == shuffle_id]
            handles = [self._blocks.pop(k) for k in keys]
        for h in handles:
            h.close()
        return len(handles)
