"""The shuffle layer's device steps — the port of ``_fmix_device``,
``_string_key_hash``, ``_column_key_hash``, ``device_partition_ids`` and
``_partition_order`` from ``spark_rapids_tpu/shuffle/manager.py`` (and of
``stable_counting_order``, ``spark_rapids_tpu/columnar/device.py``), bit for
bit, with their two kernels (``csrc/shuffle.cu``), and the manager of the
in-process executor tier (``ShuffleManager``).

Torch has no unsigned 32-bit shifts or remainders, so a uint32 value rides
an int64 tensor in ``[0, 2**32)``: shifts are then logical, every product
is taken modulo ``2**32`` by ``mul32`` without overflowing int64, and the
remainder by the partition count is taken on that non-negative int64.

``partition_ids`` and ``counting_order`` are the kernel wrappers: for
tensors on the CPU they compute their plain versions
(``device_partition_ids`` and ``counting_order_reference``), for tensors on
a CUDA device they launch the kernel on that device's current stream and
count the launch in ``<wrapper>.launches``; there is no fallback from the
kernel to the plain version.

Float keys: the JAX package hashes a float's bits as they are, so -0.0 and
0.0 (or two NaN payloads) may land on two shards, and an aggregate or join
after its exchange then keeps them apart. The device exchange here
(shuffle/ici.py) and the executor tier's map side (``ShuffleManager``) hash
floats normalised (``normalize_floats``), as the grace join and the host
exchange do; ``device_partition_ids`` with its default stays bit-equal to
JAX.
"""
from __future__ import annotations

import ctypes
import itertools
import math
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar.device import DeviceColumn, DeviceTable, pack_string_key_words
from ..conf import STEP_BREADTH, not_ported
from ..native import launch

__all__ = ["MASK32", "fmix_device", "mul32", "string_key_hash",
           "column_key_hash", "device_partition_ids", "partition_ids",
           "counting_order_reference", "counting_order", "partition_order",
           "ShuffleManager", "HeartbeatManager", "shuffle_stats"]

MASK32 = 0xFFFFFFFF
_MURMUR_C1 = 0x85EBCA6B
_MURMUR_C2 = 0xC2B2AE35
_COMBINE_ADD = 0xE6546B64
#: the JAX package's uint64 limb-fold constant 0x9E3779B97F4A7C15, as the
#: int64 with the same bits (the product modulo 2**64 is the same)
_LIMB_FOLD = 0x9E3779B97F4A7C15 - 2**64


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a constant
    ``c`` in ``[0, 2**32)``: split ``c`` into 16-bit halves so that no
    partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 0x10000) & MASK32


def fmix_device(x: torch.Tensor) -> torch.Tensor:
    """Murmur3's 32-bit finaliser, bit for bit the JAX package's
    ``_fmix_device``. ``x`` is any integer tensor; its low 32 bits are the
    uint32 input (so int32 values with the top bit set work as they do
    after ``astype(uint32)``). Returns int64 in ``[0, 2**32)``."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, _MURMUR_C1)
    x = x ^ (x >> 13)
    x = mul32(x, _MURMUR_C2)
    return x ^ (x >> 16)


def _fold64(bits: torch.Tensor) -> torch.Tensor:
    """The uint64 bit pattern in int64 ``bits`` -> ``lo ^ hi`` of its
    32-bit halves (the arithmetic shift's sign bits are masked off)."""
    return (bits & MASK32) ^ ((bits >> 32) & MASK32)


def string_key_hash(col: DeviceColumn) -> torch.Tensor:
    """``_string_key_hash``: a width-independent hash of a string column.
    Each 8-byte word (big-endian, the matrix's zero padding included) folds
    to 32 bits, is mixed with its word number, and counts only where the
    row's length reaches into it; the length's own mix comes last. So the
    same value hashes alike in batches of any matrix width."""
    words = pack_string_key_words(col.data, col.lengths)[:-1]
    k = torch.zeros(col.capacity, dtype=torch.int64, device=col.data.device)
    for i, word in enumerate(words):
        start = 8 * i
        kw = fmix_device(_fold64(word) ^ (start + 1))
        k = k ^ torch.where(col.lengths > start, kw, 0)
    return k ^ fmix_device(col.lengths)


def column_key_hash(col: DeviceColumn,
                    normalize_floats: bool = False) -> torch.Tensor:
    """``_column_key_hash``: a per-row uint32 hash (in int64) of one key
    column, mixed once more by the finaliser (a string's too); a null row
    hashes to 0. A float hashes its float64 bits as they are: -0.0 and
    0.0, or two NaN payloads, hash apart, unless ``normalize_floats`` (then
    -0.0 hashes as 0.0 and every NaN as one NaN). A wide decimal (a 2-D
    plane without lengths) folds its limbs: ``hi ^ lo * 0x9E3779B97F4A7C15``
    modulo 2**64 (int64 products wrap to the same bits)."""
    v = col.data
    if col.lengths is not None:
        k = string_key_hash(col)
    elif v.dim() == 2 and v.shape[1] == 2 and v.dtype == torch.int64:
        k = _fold64(v[:, 0] ^ (v[:, 1] * _LIMB_FOLD))
    elif v.dim() != 1:
        raise NotImplementedError(
            f"a key column of {col.dtype!r} (a nested type) has no partition "
            f"id yet {not_ported(STEP_BREADTH)}")
    elif v.dtype.is_floating_point:
        v = v.to(torch.float64)
        if normalize_floats:
            v = torch.where(v == 0, torch.zeros_like(v), v)
            v = torch.where(torch.isnan(v), torch.full_like(v, math.nan), v)
        k = _fold64(v.view(torch.int64))
    else:  # integers, dates and bools widen to int64
        k = _fold64(v.to(torch.int64))
    return torch.where(col.validity, fmix_device(k), 0)


def device_partition_ids(table: DeviceTable, key_names: Sequence[str],
                         num_parts: int, seed: int = 42,
                         normalize_floats: bool = False) -> torch.Tensor:
    """Per-row partition ids in ``[0, num_parts)``, int32, bit-equal to the
    JAX package's ``device_partition_ids``: the keys' hashes combined in
    order by ``h = (h ^ k) * 5 + 0xE6546B64 mod 2**32`` from ``seed``. The
    plain version of the ``partition_ids`` kernel."""
    h = torch.full((table.capacity,), seed & MASK32, dtype=torch.int64,
                   device=table.device)
    for name in key_names:
        h = h ^ column_key_hash(table.column(name), normalize_floats)
        h = (mul32(h, 5) + _COMBINE_ADD) & MASK32
    # h is a non-negative int64 < 2**32, so torch's % is the uint32 one
    return (h % num_parts).to(torch.int32)


# ---------------------------------------------------------------------------
# The partition-id kernel (csrc/shuffle.cu partition_ids)
# ---------------------------------------------------------------------------
class _KeyDesc(ctypes.Structure):
    """``KeyDesc`` of csrc/shuffle.cu: one key column's kind and planes."""
    _fields_ = [("kind", ctypes.c_int32), ("width", ctypes.c_int32),
                ("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p)]


#: the kernel's key kinds by value-plane dtype (strings and wide decimals
#: are told apart by their planes)
_KIND = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
         torch.bool: 4, torch.float32: 5, torch.float64: 6}
_KIND_D128, _KIND_STRING = 7, 8
#: key columns the kernel folds in one launch (csrc/shuffle.cu kMaxKeys)
PARTITION_IDS_MAX_KEYS = 16


def _key_desc(col: DeviceColumn, keep: List[torch.Tensor]) -> _KeyDesc:
    """The kernel's descriptor of one key column; the contiguous planes it
    points at go into ``keep`` so they outlive the launch call."""
    v = col.data.contiguous()
    valid = col.validity.contiguous()
    keep += [v, valid]
    if col.lengths is not None:
        lengths = col.lengths.to(torch.int32).contiguous()
        keep.append(lengths)
        return _KeyDesc(_KIND_STRING, v.shape[1], v.data_ptr(),
                        valid.data_ptr(), lengths.data_ptr())
    if v.dim() == 2 and v.shape[1] == 2 and v.dtype == torch.int64:
        return _KeyDesc(_KIND_D128, 0, v.data_ptr(), valid.data_ptr(), None)
    if v.dim() != 1 or v.dtype not in _KIND:
        raise NotImplementedError(
            f"a key column of {col.dtype!r} (a nested type) has no partition "
            f"id yet {not_ported(STEP_BREADTH)}")
    return _KeyDesc(_KIND[v.dtype], 0, v.data_ptr(), valid.data_ptr(), None)


def partition_ids(table: DeviceTable, key_names: Sequence[str],
                  num_parts: int, seed: int = 42,
                  normalize_floats: bool = False,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row partition ids, int32: ``device_partition_ids`` (its plain
    version, for a table on the CPU) or the ``partition_ids`` kernel (on a
    CUDA device). With ``row_mask``, a row whose mask is False gets
    ``num_parts``, one past the last partition."""
    if num_parts < 1:
        raise ValueError(f"partition_ids: {num_parts} partitions")
    dev = table.device
    if dev.type == "cpu":
        pid = device_partition_ids(table, key_names, num_parts, seed,
                                   normalize_floats)
        return pid if row_mask is None \
            else torch.where(row_mask, pid, num_parts)
    if len(key_names) > PARTITION_IDS_MAX_KEYS:
        raise NotImplementedError(
            f"partition_ids: {len(key_names)} keys; the kernel folds at most "
            f"{PARTITION_IDS_MAX_KEYS}")
    keep: List[torch.Tensor] = []
    descs = (_KeyDesc * max(len(key_names), 1))(
        *[_key_desc(table.column(k), keep) for k in key_names])
    n = table.capacity
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    mask = None
    if row_mask is not None:
        mask = row_mask.to(device=dev, dtype=torch.bool).contiguous()
        keep.append(mask)
    launch(partition_ids, "srt_partition_ids", dev, descs, len(key_names), n,
           seed & MASK32, num_parts, int(normalize_floats),
           None if mask is None else mask.data_ptr(), out.data_ptr())
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
partition_ids.launches = 0


# ---------------------------------------------------------------------------
# The counting-order kernel (csrc/shuffle.cu counting_order)
# ---------------------------------------------------------------------------
#: the most distinct ids the kernel groups (csrc/shuffle.cu kMaxBins)
COUNTING_ORDER_MAX_VALUES = 8192
#: one-hot elements the plain version holds at a time
_ONE_HOT_ELEMS = 1 << 26


def counting_order_reference(keys: torch.Tensor, num_vals: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``stable_counting_order`` (one-hot matrix, cumsums,
    one scatter), taken over column blocks of the one-hot so that its size
    stays bounded -> (int32 stable permutation grouping ``keys`` ascending,
    int32 count of each value). ``keys`` lie in ``[0, num_vals)``."""
    n = keys.shape[0]
    dev = keys.device
    k = keys.to(torch.int64).clamp(0, num_vals - 1)
    step = max(1, min(num_vals, _ONE_HOT_ELEMS // max(n, 1)))
    blocks = [(v0, min(v0 + step, num_vals))
              for v0 in range(0, num_vals, step)]

    def one_hot(v0: int, v1: int) -> torch.Tensor:
        """The one-hot block transposed, (values, rows): its cumsums run
        along contiguous memory."""
        vals = torch.arange(v0, v1, dtype=torch.int64, device=dev)
        return (vals[:, None] == k[None, :]).to(torch.int32)

    counts = torch.cat([one_hot(v0, v1).sum(1, dtype=torch.int32)
                        for v0, v1 in blocks])
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    dest = offsets[k].to(torch.int64)
    for v0, v1 in blocks:
        oh = one_hot(v0, v1)
        within = torch.cumsum(oh, 1, dtype=torch.int32) - oh
        col = (k - v0).clamp(0, v1 - v0 - 1)
        mine = within.gather(0, col[None, :])[0]
        dest += torch.where((k >= v0) & (k < v1), mine, 0)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    order = torch.zeros(n, dtype=torch.int32, device=dev) \
        .scatter_(0, dest, iota)
    return order, counts


def counting_order(keys: torch.Tensor, num_vals: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation grouping int32 ``keys`` in ``[0, num_vals)``
    ascending, and each value's count (both int32): the plain version on
    the CPU, the ``counting_order`` kernel on a CUDA device (one memset and
    two launches up to 1024 values, four past that). The same permutation
    as ``torch.argsort(keys, stable=True)``."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(f"counting_order: keys must be 1-D int32, got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    if not 1 <= num_vals <= COUNTING_ORDER_MAX_VALUES:
        raise ValueError(f"counting_order: {num_vals} values outside "
                         f"1..{COUNTING_ORDER_MAX_VALUES}")
    n = keys.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"counting_order: {n} rows; int32 row numbers "
                         "hold fewer than 2^31")
    dev = keys.device
    if dev.type == "cpu":
        return counting_order_reference(keys, num_vals)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return order, torch.zeros(num_vals, dtype=torch.int32, device=dev)
    # the kernel writes every count
    counts = torch.empty(num_vals, dtype=torch.int32, device=dev)
    from ..native import load_kernels
    keys = keys.contiguous()
    scratch = torch.empty(
        load_kernels().srt_counting_order_scratch(n, num_vals),
        dtype=torch.int32, device=dev)
    launch(counting_order, "srt_counting_order", dev, keys.data_ptr(), n,
           num_vals, scratch.data_ptr(), order.data_ptr(), counts.data_ptr())
    return order, counts


#: kernel launches so far (a test or smoke run resets it to 0)
counting_order.launches = 0


def partition_order(pids: torch.Tensor, num_parts: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_partition_order``: the stable group-by-partition permutation of
    ids in ``[0, num_parts]`` (``num_parts`` parks masked rows), and the
    count of each id. The JAX package takes its one-hot counting order up
    to 31 partitions and a stable argsort past that; both give this one
    permutation, which the kernel computes at any count it takes."""
    return counting_order(pids, num_parts + 1)


# ---------------------------------------------------------------------------
# The shuffle manager of the in-process executor tier
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()
_STATS = {"blocks_published": 0, "bytes_published": 0,
          "blocks_fetched": 0, "bytes_fetched": 0,
          "writes_cached_tier": 0, "writes_transport_tier": 0,
          "reads_cached_tier": 0, "reads_transport_tier": 0}


def _bump(**kv) -> None:
    with _STATS_LOCK:
        for k, v in kv.items():
            _STATS[k] += v


def shuffle_stats() -> Dict[str, int]:
    """Blocks and bytes written and fetched, and which tier served them."""
    with _STATS_LOCK:
        return dict(_STATS)


def _sorted_by_partition(batch: DeviceTable, key_names: Sequence[str],
                         num_parts: int) -> Tuple[DeviceTable, List[int]]:
    """-> (the batch's rows grouped by partition id, stably, masked rows
    last; the start row of each partition and the end, on the host). The
    counts are the one host read: the ids stay on the device."""
    # floats normalised: -0.0 and 0.0, and every NaN, meet on one partition
    pid = partition_ids(batch, key_names, num_parts, normalize_floats=True,
                        row_mask=batch.row_mask)
    order, counts = partition_order(pid, num_parts)
    sorted_tbl = DeviceTable(tuple(c.gather(order) for c in batch.columns),
                             batch.row_mask.index_select(0, order.long()),
                             batch.num_rows, batch.names)
    counts = counts[:num_parts].tolist()
    return sorted_tbl, [0] + list(itertools.accumulate(counts))


def _gather_window(tbl: DeviceTable, lo: int, hi: int) -> DeviceTable:
    """Rows ``[lo, hi)`` of ``tbl`` as a table of the 256-row write
    quantum's bucket (the JAX package's cached-block shapes)."""
    from ..columnar.device import bucket_rows
    length = bucket_rows(max(hi - lo, 1), 256)
    dev = tbl.device
    idx = (lo + torch.arange(length, dtype=torch.int64, device=dev)) \
        .clamp(0, max(tbl.capacity - 1, 0))
    mask = torch.arange(length, device=dev) < (hi - lo)
    cols = tuple(g.with_validity(torch.logical_and(g.validity, mask),
                                 all_valid=g.all_valid)
                 for g in (c.gather(idx) for c in tbl.columns))
    return DeviceTable(cols, mask, torch.tensor(hi - lo, dtype=torch.int32,
                                                device=dev), tbl.names)


class HeartbeatManager:
    """Executor registration and heartbeats (reference: Plugin.scala:149-161
    + RapidsShuffleHeartbeatManager.scala)."""

    def __init__(self, timeout_s: float = 60.0):
        self._peers: Dict[int, float] = {}
        self._lock = threading.Lock()
        self.timeout_s = timeout_s

    def register(self, executor_id: int) -> None:
        self.heartbeat(executor_id)

    def heartbeat(self, executor_id: int) -> None:
        with self._lock:
            self._peers[executor_id] = time.monotonic()

    def live_peers(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return sorted(e for e, t in self._peers.items()
                          if now - t < self.timeout_s)


class ShuffleManager:
    """Write and read shuffle blocks (reference:
    RapidsShuffleInternalManagerBase.scala: RapidsCachingWriter at :92-155,
    RapidsShuffleIterator on the read side).

    Write, per map task: partition ids and their counting order (the two
    kernels), the row counts read once, then either each partition's rows
    kept on the device in the shuffle buffer catalog (the cached tier:
    ``shuffle.cacheWrites``, on for the in-process transport under
    ``auto``) or the batch downloaded once, sliced per partition, serialized
    with ``spark.rapids.shuffle.compression.codec`` and published to the
    transport. Every (map, reduce) block is written, empty ones too: a
    reader treats a missing block as a fetch failure.

    Read, per reduce partition: the cached blocks concatenated on the
    device, or the transport's payloads deserialized, concatenated on the
    host and uploaded, one batch per ``spark.rapids.shuffle
    .maxMetadataSize`` of fetched bytes. A missing block recomputes its map
    task once through ``recompute(map_id)`` when given, else raises."""

    def __init__(self, conf=None, transport=None, device=None,
                 buffer_catalog=None):
        from ..conf import (MAX_METADATA_SIZE, SHUFFLE_CACHE_WRITES,
                            SHUFFLE_COMPRESSION_CODEC, RapidsConf)
        from .buffer_catalog import ShuffleBufferCatalog
        from .transport import LocalShuffleTransport, load_transport
        self.conf = conf or RapidsConf()
        self.device = torch.device(device or "cpu")
        self.transport = transport or load_transport(self.conf)
        self.codec = self.conf.get(SHUFFLE_COMPRESSION_CODEC)
        self.max_inflight_bytes = self.conf.get(MAX_METADATA_SIZE)
        self._ids = itertools.count()
        self._skew_lock = threading.Lock()
        self._skew: Dict[int, Dict[str, List[int]]] = {}
        #: the device-resident blocks (executors of one process may share
        #: one, as readers of another executor's output)
        self.buffer_catalog = buffer_catalog or ShuffleBufferCatalog()
        self.heartbeats = HeartbeatManager()
        mode = self.conf.get(SHUFFLE_CACHE_WRITES)
        self.cache_writes = isinstance(self.transport, LocalShuffleTransport) \
            if mode == "auto" else mode == "on"

    def new_shuffle_id(self) -> int:
        return next(self._ids)

    def _bump_skew(self, shuffle_id: int, part_rows, part_bytes) -> None:
        with self._skew_lock:
            entry = self._skew.setdefault(
                shuffle_id, {"rows": [0] * len(part_rows),
                             "bytes": [0] * len(part_bytes)})
            for p, r in enumerate(part_rows):
                entry["rows"][p] += int(r)
            for p, b in enumerate(part_bytes):
                entry["bytes"][p] += int(b)

    def shuffle_skew_stats(self, shuffle_id: int) -> Optional[Dict]:
        """The write side's rows and bytes per reduce partition of one
        shuffle, or None for a shuffle never written."""
        with self._skew_lock:
            entry = self._skew.get(shuffle_id)
            return None if entry is None else {
                "rows": list(entry["rows"]), "bytes": list(entry["bytes"])}

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """Free a finished shuffle's blocks in both stores."""
        self.buffer_catalog.remove_shuffle(shuffle_id)
        with self._skew_lock:
            self._skew.pop(shuffle_id, None)
        self.transport.remove_shuffle(shuffle_id)

    def unregister_all(self) -> None:
        for sid in self.buffer_catalog.shuffle_ids():
            self.buffer_catalog.remove_shuffle(sid)

    # -- write side -----------------------------------------------------------
    def write_partition(self, shuffle_id: int, map_id: int,
                        batches: Iterator[DeviceTable],
                        key_names: List[str], num_parts: int) -> List[int]:
        """Partition and publish one map task's output -> bytes a block."""
        from ..utils import faults
        action = faults.fire("shuffle.publish")
        if action is not None and action != "delay":
            raise faults.FaultInjectedError("shuffle.publish", action)
        if self.cache_writes:
            return self._write_cached(shuffle_id, map_id, batches, key_names,
                                      num_parts)
        return self._write_transport(shuffle_id, map_id, batches, key_names,
                                     num_parts)

    def _write_transport(self, shuffle_id, map_id, batches, key_names,
                         num_parts) -> List[int]:
        from ..columnar.host import HostTable
        from ..parallel.pipeline import parallel_map
        from .serializer import serialize_table
        from .transport import BlockId
        merged: List[List[HostTable]] = [[] for _ in range(num_parts)]
        part_rows = [0] * num_parts
        schema_host = None
        for batch in batches:
            sorted_tbl, bounds = _sorted_by_partition(batch, key_names,
                                                      num_parts)
            host = sorted_tbl.to_host()  # one download, a dense prefix
            schema_host = host
            for p in range(num_parts):
                lo, hi = bounds[p], bounds[p + 1]
                part_rows[p] += hi - lo
                if hi > lo:
                    merged[p].append(host.slice(lo, hi - lo))

        def publish(p: int) -> int:
            if merged[p]:
                table = HostTable.concat(merged[p])
            elif schema_host is not None:
                table = schema_host.slice(0, 0)
            else:  # the map task saw no batch: a typed-empty marker
                table = HostTable([], [])
            payload = serialize_table(table, self.codec)
            self.transport.publish(BlockId(shuffle_id, map_id, p), payload)
            return len(payload)

        sizes = parallel_map(publish, range(num_parts),
                             stage="shuffle_serialize")
        _bump(blocks_published=num_parts, bytes_published=sum(sizes),
              writes_transport_tier=1)
        self._bump_skew(shuffle_id, part_rows, sizes)
        return sizes

    def _write_cached(self, shuffle_id, map_id, batches, key_names,
                      num_parts) -> List[int]:
        from ..columnar.device import concat_device_tables
        per_part: List[List[DeviceTable]] = [[] for _ in range(num_parts)]
        part_rows = [0] * num_parts
        schema_tbl = None
        for batch in batches:
            sorted_tbl, bounds = _sorted_by_partition(batch, key_names,
                                                      num_parts)
            schema_tbl = sorted_tbl
            for p in range(num_parts):
                lo, hi = bounds[p], bounds[p + 1]
                part_rows[p] += hi - lo
                if hi > lo:
                    per_part[p].append(_gather_window(sorted_tbl, lo, hi))
        sizes = [0] * num_parts
        for p in range(num_parts):
            if per_part[p]:
                table = concat_device_tables(per_part[p], 256)
            elif schema_tbl is not None:
                table = _gather_window(schema_tbl, 0, 0)
            else:  # the map task saw no batch
                table = DeviceTable((), torch.zeros(0, dtype=torch.bool,
                                                    device=self.device),
                                    torch.zeros((), dtype=torch.int32,
                                                device=self.device), ())
            self.buffer_catalog.put((shuffle_id, map_id, p), table)
            sizes[p] = table.nbytes()
        _bump(blocks_published=num_parts, bytes_published=sum(sizes),
              writes_cached_tier=1)
        self._bump_skew(shuffle_id, part_rows, sizes)
        return sizes

    # -- read side ------------------------------------------------------------
    def read_partition(self, shuffle_id: int, num_maps: int, reduce_id: int,
                       min_bucket: Optional[int] = None,
                       recompute=None) -> Iterator[DeviceTable]:
        """Fetch, concatenate and (transport tier) upload one reduce
        partition."""
        if self.cache_writes:
            yield from self._read_cached(shuffle_id, num_maps, reduce_id,
                                         min_bucket, recompute)
            return
        yield from self._read_transport(shuffle_id, num_maps, reduce_id,
                                        min_bucket, recompute)

    def _read_transport(self, shuffle_id, num_maps, reduce_id, min_bucket,
                        recompute) -> Iterator[DeviceTable]:
        from ..columnar.host import HostTable
        from ..utils import faults
        from .serializer import deserialize_table
        from .transport import BlockId, ShuffleFetchFailedException
        pending = [BlockId(shuffle_id, m, reduce_id) for m in range(num_maps)]
        retried = set()
        group: List[HostTable] = []
        group_bytes = fetched = fetched_bytes = 0
        uploaded = False
        schema_t = None

        def upload(tables):
            return DeviceTable.from_host(HostTable.concat(tables), min_bucket,
                                         self.device)

        while pending:
            try:
                if faults.fire("shuffle.fetch") not in (None, "delay"):
                    raise ShuffleFetchFailedException(
                        pending[0], "injected fault 'shuffle.fetch'")
                for bid, payload in self.transport.fetch(pending):
                    host = deserialize_table(payload)
                    fetched += 1
                    fetched_bytes += len(payload)
                    pending = pending[pending.index(bid) + 1:]
                    if host.num_columns and schema_t is None:
                        schema_t = host
                    if not (host.num_columns and host.num_rows):
                        continue
                    group.append(host)
                    group_bytes += len(payload)
                    if group_bytes >= self.max_inflight_bytes:
                        # the throttle: the fetched bytes held on the host
                        # stay under maxMetadataSize
                        yield upload(group)
                        uploaded = True
                        group, group_bytes = [], 0
                break
            except ShuffleFetchFailedException as e:
                map_id = e.block[1]
                if recompute is None or map_id in retried:
                    raise
                retried.add(map_id)
                faults.note_recovery("shuffle_recomputes")
                recompute(map_id)
                pending = pending[pending.index(e.block):]
        _bump(blocks_fetched=fetched, bytes_fetched=fetched_bytes,
              reads_transport_tier=1)
        if group:
            yield upload(group)
        elif schema_t is not None and not uploaded:
            # every block empty: a zero-row table of the schema
            yield DeviceTable.from_host(schema_t.slice(0, 0), min_bucket,
                                        self.device)

    def _read_cached(self, shuffle_id, num_maps, reduce_id, min_bucket,
                     recompute) -> Iterator[DeviceTable]:
        from ..columnar.device import concat_device_tables
        from ..memory.stores import SpillCorruptionError
        from ..utils import faults
        from .transport import BlockId, ShuffleFetchFailedException
        tables: List[DeviceTable] = []
        fetched_bytes = 0
        for m in range(num_maps):
            key = (shuffle_id, m, reduce_id)
            bid = BlockId(shuffle_id, m, reduce_id)
            handle = self.buffer_catalog.get(key)
            if handle is not None \
                    and faults.fire("shuffle.fetch") not in (None, "delay"):
                handle = None  # an injected miss takes a lost block's path
            if handle is None and recompute is not None:
                faults.note_recovery("shuffle_recomputes")
                recompute(m)
                handle = self.buffer_catalog.get(key)
            if handle is None:
                raise ShuffleFetchFailedException(
                    bid, "block not in the shuffle buffer catalog")
            try:
                t = handle.get()
            except SpillCorruptionError as e:
                if recompute is None:
                    raise ShuffleFetchFailedException(
                        bid, f"spilled block corrupt: {e}") from e
                faults.note_recovery("shuffle_recomputes")
                recompute(m)
                fresh = self.buffer_catalog.get(key)
                if fresh is None:
                    raise ShuffleFetchFailedException(
                        bid, "block missing after corruption recompute") \
                        from e
                t = fresh.get()
            fetched_bytes += t.nbytes()
            if t.num_columns:
                tables.append(t)
        _bump(blocks_fetched=num_maps, bytes_fetched=fetched_bytes,
              reads_cached_tier=1)
        # every block's row count in one copy
        counts = torch.stack([t.num_rows for t in tables]).tolist() \
            if tables else []
        parts = [t for t, c in zip(tables, counts) if c]
        if parts:
            yield concat_device_tables(parts, min_bucket)
        elif tables:
            # all blocks empty: a zero-row table of the schema, bucketed to
            # the reader's floor (as the transport tier's empty partition)
            yield DeviceTable.from_host(tables[0].to_host().slice(0, 0),
                                        min_bucket, self.device)
