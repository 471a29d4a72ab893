"""Device exchanges — the port of ``TpuLocalExchangeExec`` and
``TpuShuffleExchangeExec`` from ``spark_rapids_tpu/exec/exchange.py``.

With one device there is no locality to exploit and no transport to ride:
the whole input coalesces into ONE output partition that never leaves the
device. Single, hash and range partitioning are all satisfied by one
partition (all rows of any key land together; the sort above orders its one
partition), so the exchange never computes partition ids. Each map batch
is compacted and shrunk to the bucket of its row count first, since
post-filter and partial-aggregate batches are mostly masked slack.

With a mesh of two or more shards attached (``TorchSession.attach_mesh``),
a hash exchange runs across it: ``TpuShuffleExchangeExec``, output
partition ``i`` = mesh shard ``i`` (shuffle/ici.py ``mesh_exchange``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Iterator, List, Optional, Tuple

import torch

from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               concat_device_tables, shrink_to_fit)
from ..plan.physical import HashPartitioning, PhysicalPlan
from ..shuffle import telemetry
from .base import TpuExec

__all__ = ["TpuLocalExchangeExec", "TpuShuffleExchangeExec",
           "pad_table_capacity", "SHUFFLE_BYTES", "EXCHANGE_CHUNKS"]

#: metric names of the mesh exchange
SHUFFLE_BYTES = "shuffleBytes"
EXCHANGE_CHUNKS = "exchangeChunks"
EXCHANGE_SECONDS = "exchangeSeconds"
#: the shuffle observatory's ids of device exchanges (shuffle/telemetry.py)
_EXCHANGE_IDS = itertools.count()


class TpuLocalExchangeExec(TpuExec):
    def __init__(self, child: PhysicalPlan, partitioning, min_bucket: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.min_bucket = min_bucket
        self.schema = child.schema
        self._batches: Optional[List[DeviceTable]] = None
        self._mat_lock = threading.Lock()
        self.telemetry_sid = next(_EXCHANGE_IDS)

    @property
    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return "local n=1"

    def materialize(self) -> List[DeviceTable]:
        """Drain the child once; the batches stay on the node."""
        with self._mat_lock:
            if self._batches is None:
                from ..parallel.pipeline import exempt_admission
                with exempt_admission():
                    self._batches = self._drain()
            return self._batches

    def _drain(self) -> List[DeviceTable]:
        out = []
        for p in range(self.child.num_partitions):
            batches = list(self.child_device_batches(p))
            if not batches:
                continue
            # one device->host read for every row count of the partition
            counts = torch.stack([b.num_rows for b in batches]).tolist()
            for b, n in zip(batches, counts):
                if n:
                    shrunk = shrink_to_fit(b, self.min_bucket, num_rows=n)
                    telemetry.note_transfer(
                        "local", "enqueue", shuffle_id=self.telemetry_sid,
                        partition=p, logical_bytes=shrunk.nbytes)
                    out.append(shrunk)
                    self.account_batch(n)
        return out

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        yield from self.materialize()


def pad_table_capacity(table: DeviceTable, capacity: int) -> DeviceTable:
    """Grow a table's capacity; the new slots are masked off."""
    if capacity <= table.capacity:
        return table
    extra = capacity - table.capacity

    def pad(a: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, extra))

    cols = tuple(DeviceColumn(pad(c.data), pad(c.validity), c.dtype,
                              c.all_valid,
                              None if c.lengths is None else pad(c.lengths))
                 for c in table.columns)
    return DeviceTable(cols, pad(table.row_mask), table.num_rows,
                       table.names)


class TpuShuffleExchangeExec(TpuExec):
    """A hash exchange across a mesh; output partition ``i`` is shard ``i``.

    The child's batches stream through in chunks of ``chunk_rows``
    capacity, so only one chunk is staged at a time (registered with the
    spill catalog while in flight). For each chunk: one concat, padded to
    ``n`` equal shards; on each shard the ``partition_ids`` and
    ``counting_order`` kernels; ONE host read of the ``n x n`` counts (the
    count pass), which sizes the (source, destination) quota, bucketed so
    that chunks of one exchange share shapes; then ``mesh_exchange``. Each
    output shard with rows is registered with the spill catalog.

    Keep-sharded mode (exec/mesh.py): a mesh-stage consumer takes the
    exchanged chunks still sharded; a second chunk reverts the exchange to
    per-shard registration (kept chunks are not spillable, so the
    out-of-core contract wins), and a per-partition consumer splits late
    (``_ensure_split``). The per-partition rows and bytes (rows times the
    chunk's mean row width) are what AQE and the skew record read."""

    #: measurement switch: end each chunk's ``exchangeSeconds`` at the
    #: completion of its device work (a synchronize a chunk) instead of at
    #: its last launch; off on the query path
    sync_timing = False

    def __init__(self, child: PhysicalPlan, partitioning: HashPartitioning,
                 mesh, min_bucket: Optional[int] = None,
                 chunk_rows: int = 1 << 19):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.mesh = mesh
        self.min_bucket = min_bucket
        self.chunk_rows = max(int(chunk_rows), 1)
        self.schema = child.schema
        for k in (SHUFFLE_BYTES, EXCHANGE_CHUNKS):
            self.metrics[k] = 0
        self.metrics[EXCHANGE_SECONDS] = 0.0
        #: the (source, destination) quota of each chunk
        self.quotas: List[int] = []
        #: per partition, (spill handle, rows) of each exchanged chunk
        self._shards: Optional[List[List[Tuple[object, int]]]] = None
        self._keep_sharded = False
        self._sharded_chunks: Optional[list] = None
        self._sharded_chunk_rows: Optional[List[List[int]]] = None
        self._skew_rows: Optional[List[int]] = None
        self._skew_bytes: Optional[List[int]] = None
        self._mat_lock = threading.Lock()
        self.telemetry_sid = next(_EXCHANGE_IDS)

    @property
    def num_partitions(self) -> int:
        return self.mesh.size

    def node_desc(self) -> str:
        # the JAX package's tier name (spark.rapids.tpu.shuffle.mode=ici)
        return (f"ici keys={self.partitioning.key_names} "
                f"n={self.num_partitions}")

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        self._materialize()
        self._ensure_split()
        for handle, _rows in self._shards[pidx]:
            yield handle.get()

    def partition_stats(self) -> Tuple[List[int], List[int]]:
        """Per output partition: rows, and bytes estimated as rows times
        each chunk's mean row width."""
        self._materialize()
        return list(self._skew_rows), list(self._skew_bytes)

    def partition_handles(self, pidx: int) -> List[Tuple[object, int]]:
        """(spill handle, rows) of each exchanged chunk of partition
        ``pidx``."""
        self._materialize()
        self._ensure_split()
        return list(self._shards[pidx])

    # -- keep-sharded consumer API (exec/mesh.py) -----------------------------
    def request_keep_sharded(self) -> None:
        """Planner hook: the consumer is a mesh stage."""
        self._keep_sharded = True

    def sharded_chunks(self) -> Optional[List[tuple]]:
        """``(chunk, per-shard rows)`` of each exchanged chunk, still
        sharded, or None once the output split per partition."""
        self._materialize()
        with self._mat_lock:
            if self._shards is not None:
                return None
            return list(zip(self._sharded_chunks or [],
                            self._sharded_chunk_rows or []))

    def _ensure_split(self) -> None:
        if self._shards is not None:
            return
        with self._mat_lock:
            if self._shards is not None:
                return
            from ..parallel.pipeline import exempt_admission
            with exempt_admission():
                chunks, self._sharded_chunks = self._sharded_chunks, None
                rows, self._sharded_chunk_rows = \
                    self._sharded_chunk_rows, None
                shards: List[list] = [[] for _ in range(self.num_partitions)]
                for t, r in zip(chunks or [], rows or []):
                    self._register_split(t, r, shards)
                self._shards = shards

    # -- the exchange ---------------------------------------------------------
    def _materialize(self) -> None:
        with self._mat_lock:
            if self._shards is not None or self._sharded_chunks is not None:
                return
            # never wait on the task semaphore holding this shared lock
            from ..parallel.pipeline import exempt_admission
            with exempt_admission():
                self._materialize_locked()

    def _materialize_locked(self) -> None:
        from ..parallel.pipeline import maybe_prefetched
        n = self.num_partitions
        shards: List[list] = [[] for _ in range(n)]
        if self._keep_sharded:
            self._sharded_chunks, self._sharded_chunk_rows = [], []
        self._skew_rows, self._skew_bytes = [0] * n, [0] * n
        total = 0

        def all_child_batches():
            for p in range(self.child.num_partitions):
                yield from self.child_device_batches(p)

        pending: List[DeviceTable] = []
        staged = 0
        for b in maybe_prefetched(all_child_batches, stage="shuffle_map"):
            if not b.capacity:
                continue
            pending.append(b)
            staged += b.capacity
            if staged >= self.chunk_rows:
                total += self._exchange_chunk(pending, shards)
                pending, staged = [], 0
        if pending:
            total += self._exchange_chunk(pending, shards)
        if self._keep_sharded:
            self.metrics["numOutputBatches"] += len(self._sharded_chunks)
        else:
            self._shards = shards
            self.metrics["numOutputBatches"] += sum(len(s) for s in shards)
        self.metrics["numOutputRows"] += total

    def _exchange_chunk(self, batches: List[DeviceTable],
                        shards: List[list]) -> int:
        from ..memory.catalog import SpillPriorities, get_catalog
        from ..shuffle.ici import exchange_plan, mesh_exchange, shard_table
        n = self.num_partitions
        keys = self.partitioning.key_names
        t0 = time.perf_counter()
        table = concat_device_tables(batches, self.min_bucket)
        del batches
        chunk_nbytes = table.nbytes()
        self.metrics[SHUFFLE_BYTES] += chunk_nbytes
        self.metrics[EXCHANGE_CHUNKS] += 1
        # the observatory's enqueue bytes are the shuffleBytes metric's
        telemetry.note_transfer("ici", "enqueue",
                                shuffle_id=self.telemetry_sid,
                                logical_bytes=chunk_nbytes)
        per_shard = bucket_rows(max(1, -(-table.capacity // n)),
                                self.min_bucket)
        table = pad_table_capacity(table, per_shard * n)
        # the in-flight chunk is accounted: registering it may spill
        # finished output shards to make room
        inflight = get_catalog().register(table,
                                          SpillPriorities.ACTIVE_ON_DECK)
        try:
            sharded = shard_table(table, self.mesh)
            del table
            plans = [exchange_plan(s, keys, n) for s in sharded.shards]
            # the count pass: the n x n (source, destination) counts cross
            # to the host in one copy, and nothing else does
            first = self.mesh.devices[0]
            counts = torch.stack([p.counts[:n].to(first) for p in plans]) \
                .cpu().tolist()
            max_cnt = max((c for row in counts for c in row), default=0)
            quota = min(per_shard, bucket_rows(max(max_cnt, 1),
                                               self.min_bucket))
            self.quotas.append(quota)
            t_dispatch = telemetry.clock()
            exchanged = mesh_exchange(sharded, keys, quota, plans)
            # wire bytes: the padded sharded input the copies move
            telemetry.note_transfer("ici", "dispatch",
                                    shuffle_id=self.telemetry_sid,
                                    t0=t_dispatch, queue_depth=n,
                                    wire_bytes=sharded.nbytes)
            del sharded, plans
            shard_rows = [sum(row[d] for row in counts) for d in range(n)]
            if self._keep_sharded and self._sharded_chunks:
                # a second chunk: kept chunks are not spillable, so the
                # out-of-core contract wins and the exchange splits
                self._keep_sharded = False
                kept, self._sharded_chunks = self._sharded_chunks, None
                kept_rows, self._sharded_chunk_rows = \
                    self._sharded_chunk_rows, None
                for t, r in zip(kept, kept_rows):
                    self._register_split(t, r, shards)
            if self._keep_sharded:
                self._sharded_chunks.append(exchanged)
                self._sharded_chunk_rows.append(shard_rows)
            else:
                self._register_split(exchanged, shard_rows, shards)
            chunk_total = sum(shard_rows)
            bpr = chunk_nbytes / max(1, chunk_total)
            for i, cnt in enumerate(shard_rows):
                self._skew_rows[i] += cnt
                self._skew_bytes[i] += int(round(cnt * bpr))
            return chunk_total
        finally:
            inflight.close()
            if self.sync_timing:
                for dev in set(self.mesh.devices):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            self.metrics[EXCHANGE_SECONDS] += time.perf_counter() - t0

    def _register_split(self, exchanged, shard_rows: List[int],
                        shards: List[list]) -> None:
        """Register each output shard with rows with the spill catalog."""
        from ..memory.catalog import SpillPriorities, get_catalog
        catalog = get_catalog()
        for i, (t, rows) in enumerate(zip(exchanged.shards, shard_rows)):
            if not rows:
                continue
            h = catalog.register(t, SpillPriorities.OUTPUT_FOR_SHUFFLE)
            self._own_spill_handle(h)
            shards[i].append((h, rows))
