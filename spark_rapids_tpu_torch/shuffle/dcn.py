"""The DCN tier: shuffle blocks that stay on the device between executors —
the port of ``spark_rapids_tpu/shuffle/dcn.py`` (reference: the UCX
shuffle plugin, UCX.scala:69 and UCXShuffleTransport.scala:47, which moves
blocks device to device with a TCP handshake beside it).

- ``MockDcnFabric`` and ``DcnShuffleTransport``: hosts of one process, each
  bound to a ``torch.device``. A published table stays on its owner's
  device (registered in the catalog at shuffle priority, so it stays
  spillable); a fetch moves it to the fetcher's device with ``.to(dst)``
  and counts the bytes of each link in ``fabric.link_bytes``. The fabric's
  ``fault`` hook injects transfer failures.
- ``TcpDcnShuffleTransport``: hosts are processes (``ProcessCluster``
  workers). A published table stays on the publisher's card and is
  serialised only when a peer asks for it (a lazy provider in the TCP
  block store); a fetched block is uploaded to the fetcher's device.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..columnar.device import DeviceColumn, DeviceTable, resolve_device
from ..utils import faults
from . import telemetry
from .transport import BlockId, ShuffleFetchFailedException

__all__ = ["MockDcnFabric", "DcnShuffleTransport", "TcpDcnShuffleTransport",
           "table_to"]


def table_to(table: DeviceTable, device: torch.device) -> DeviceTable:
    """Every plane of ``table`` copied to ``device``."""
    cols = tuple(DeviceColumn(c.data.to(device), c.validity.to(device),
                              c.dtype, c.all_valid,
                              None if c.lengths is None
                              else c.lengths.to(device))
                 for c in table.columns)
    return DeviceTable(cols, table.row_mask.to(device),
                       table.num_rows.to(device), table.names)


class _DeviceBlocks:
    """The published tables of one host: each kept on its device, as a
    spill-catalog handle at shuffle priority when there is a catalog."""

    def __init__(self, catalog=None):
        self.catalog = catalog
        self._blocks: Dict[BlockId, object] = {}   # handle or table
        self._lock = threading.Lock()

    def put(self, block: BlockId, table: DeviceTable) -> None:
        entry: object = table
        if self.catalog is not None:
            from ..memory.catalog import SpillPriorities
            entry = self.catalog.register(
                table, SpillPriorities.OUTPUT_FOR_SHUFFLE)
        with self._lock:
            old = self._blocks.get(block)
            self._blocks[block] = entry
        if old is not None and not isinstance(old, DeviceTable):
            old.close()

    def get(self, block: BlockId) -> Optional[DeviceTable]:
        with self._lock:
            entry = self._blocks.get(block)
        if entry is None or isinstance(entry, DeviceTable):
            return entry
        return entry.get()

    def shuffle_ids(self) -> set:
        with self._lock:
            return {b[0] for b in self._blocks}

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            doomed = [self._blocks.pop(b) for b in list(self._blocks)
                      if b[0] == shuffle_id]
        for e in doomed:
            if not isinstance(e, DeviceTable):
                e.close()


class MockDcnFabric:
    """The network between hosts of one process: a registry of hosts and
    the bytes moved over each (src, dst) link."""

    def __init__(self):
        self.hosts: Dict[str, "DcnShuffleTransport"] = {}
        self.link_bytes: Dict[Tuple[str, str], int] = {}
        self.transfers = 0
        self._lock = threading.Lock()
        #: failure injection: called before each transfer, may raise
        self.fault: Optional[Callable[[str, str, BlockId], None]] = None

    def attach(self, name: str, transport: "DcnShuffleTransport") -> None:
        with self._lock:
            self.hosts[name] = transport

    def transfer(self, src: str, dst: str, block: BlockId,
                 table: DeviceTable, device: torch.device) -> DeviceTable:
        if self.fault is not None:
            self.fault(src, dst, block)
        moved = table_to(table, device)
        with self._lock:
            self.link_bytes[(src, dst)] = \
                self.link_bytes.get((src, dst), 0) + table.nbytes()
            self.transfers += 1
        return moved


class DcnShuffleTransport:
    """A host of a ``MockDcnFabric``: blocks are device tables, published
    on the owner's device and fetched onto the fetcher's with no host
    serialisation between."""

    def __init__(self, fabric: MockDcnFabric, host_name: str,
                 device=None, catalog=None):
        self.fabric = fabric
        self.host_name = host_name
        self.device = resolve_device(device, "DcnShuffleTransport")
        self._blocks = _DeviceBlocks(catalog)
        fabric.attach(host_name, self)

    def publish_table(self, block: BlockId, table: DeviceTable) -> None:
        self._blocks.put(block, table)

    def _local(self, block: BlockId) -> Optional[DeviceTable]:
        return self._blocks.get(block)

    def fetch_tables(self, blocks: List[BlockId]
                     ) -> Iterator[Tuple[BlockId, DeviceTable]]:
        for b in blocks:
            local = self._local(b)
            if local is not None:
                yield b, local
                continue
            for name, host in list(self.fabric.hosts.items()):
                if name == self.host_name:
                    continue
                remote = host._local(b)
                if remote is not None:
                    yield b, self.fabric.transfer(name, self.host_name, b,
                                                  remote, self.device)
                    break
            else:
                raise ShuffleFetchFailedException(
                    b, f"block not on any of {len(self.fabric.hosts)} DCN "
                       "hosts")

    def remove_shuffle(self, shuffle_id: int) -> None:
        self._blocks.remove_shuffle(shuffle_id)

    def close(self) -> None:
        for sid in self._blocks.shuffle_ids():
            self._blocks.remove_shuffle(sid)


class TcpDcnShuffleTransport:
    """The DCN tier across processes: device-resident at both ends, host
    bytes only on the wire (shuffle/tcp.py). A published table is
    serialised, with ``codec``, only when a peer first asks for it."""

    def __init__(self, conf=None, device=None, catalog=None,
                 codec: str = "lz4"):
        from ..conf import RapidsConf
        from .tcp import TcpShuffleTransport
        self.device = resolve_device(device, "TcpDcnShuffleTransport")
        self.tcp = TcpShuffleTransport(conf or RapidsConf())
        self.codec = codec
        self._blocks = _DeviceBlocks(catalog)
        self._lock = threading.Lock()
        self.bytes_wired = 0

    @property
    def address(self) -> Tuple[str, int]:
        return self.tcp.address

    def add_peer(self, host: str, port: int) -> None:
        self.tcp.add_peer(host, port)

    def publish_table(self, block: BlockId, table: DeviceTable) -> None:
        action = faults.fire("dcn.publish")
        if action is not None and action != "delay":
            raise faults.FaultInjectedError("dcn.publish", action)
        self._blocks.put(block, table)
        t0 = telemetry.clock()
        self.tcp.store.put_lazy(block, lambda: self._serialize(block))
        telemetry.note_transfer(
            "dcn", "enqueue", shuffle_id=block[0], map_id=block[1],
            partition=block[2], t0=t0, logical_bytes=table.nbytes,
            queue_depth=self.tcp.store.lazy_depth())

    def _serialize(self, block: BlockId) -> bytes:
        """The lazy provider: runs on the TCP server's thread when a peer
        first asks for ``block``."""
        from .serializer import serialize_table
        table = self._blocks.get(block)
        if table is None:
            raise ShuffleFetchFailedException(
                block, "published table vanished before serialization")
        t0 = telemetry.clock()
        payload = serialize_table(table.to_host(), codec=self.codec)
        telemetry.note_transfer(
            "dcn", "serialize", shuffle_id=block[0], map_id=block[1],
            partition=block[2], t0=t0, logical_bytes=table.nbytes,
            wire_bytes=len(payload), queue_depth=self.tcp.store.lazy_depth())
        with self._lock:
            self.bytes_wired += len(payload)
        return payload

    def fetch_tables(self, blocks: List[BlockId]
                     ) -> Iterator[Tuple[BlockId, DeviceTable]]:
        from .serializer import deserialize_table
        local = {b: self._blocks.get(b) for b in blocks}
        remote = [b for b in blocks if local[b] is None]
        for b in blocks:
            if local[b] is not None:
                yield b, local[b]
        if not remote:
            return
        action = faults.fire("dcn.fetch")
        if action is not None and action != "delay":
            raise faults.FaultInjectedError("dcn.fetch", action)
        t_fetch = telemetry.clock()
        for b, payload in self.tcp.fetch(remote):
            telemetry.note_transfer(
                "dcn", "fetch", shuffle_id=b[0], map_id=b[1], partition=b[2],
                wire_bytes=len(payload), t0=t_fetch, queue_depth=len(remote))
            t_des = telemetry.clock()
            host = deserialize_table(payload)
            table = DeviceTable.from_host(host, None, self.device)
            telemetry.note_transfer(
                "dcn", "deserialize", shuffle_id=b[0], map_id=b[1],
                partition=b[2], t0=t_des, logical_bytes=table.nbytes)
            yield b, table
            t_fetch = telemetry.clock()

    def remove_shuffle(self, shuffle_id: int) -> None:
        self._blocks.remove_shuffle(shuffle_id)
        self.tcp.remove_shuffle(shuffle_id)

    def close(self) -> None:
        for sid in self._blocks.shuffle_ids():
            self._blocks.remove_shuffle(sid)
        self.tcp.close()
