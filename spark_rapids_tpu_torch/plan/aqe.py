"""Adaptive query execution (AQE) — the port of
``spark_rapids_tpu/plan/aqe.py`` (reference: GpuQueryStagePrepOverrides on
AdaptiveSparkPlanExec, GpuOverrides.scala:4010-4042).

The engine owns the whole scheduler, so AQE is a loop over materialization
frontiers:

1. find the exchanges whose subtree holds no other exchange (the frontier),
2. lower one of them to the device and materialize it as a stage (build
   sides of joins first), recording its rows and bytes,
3. re-plan the rest with those statistics: a shuffled hash join whose
   materialized build side is within
   ``spark.rapids.tpu.aqe.autoBroadcastJoinThreshold`` becomes a broadcast
   hash join, and the probe side's unmaterialized exchange goes; when only
   the left (probe) side is that small, an inner join swaps its sides to
   broadcast the left, and a projection restores the column order,
4. repeat until no exchange remains, then lower the final segment through
   ``apply_overrides``; each stage reads back as a ``TpuStageReaderExec``.

Every rewrite is recorded in ``AdaptiveExec.events``. Stage bytes are the
JAX package's: each batch's value planes scaled from its capacity to its
rows, string matrices at their bucketed widths (validity, lengths and row
masks not counted), so both engines demote the same joins. A mesh
exchange's stage takes its per-partition rows from the exchange's count
pass.

When a join demotes to broadcast (inner and left-semi), the build side's
distinct keys are pushed into the probe side's host scan as a runtime IN
filter, when the scan's source prunes by statistics (Parquet) and the path
from the join to it keeps the key column; a scan already lowered to the
device (``TpuParquetScanExec``) takes none, as in the JAX package.

Once no exchange is left, two rewrites read the partition statistics of
stages of more than one partition (a mesh exchange's, or the host tier's):

- skew split: a shuffled hash join (inner, left, semi, anti) whose probe
  partition is over ``skewedPartitionFactor`` x the median and
  ``skewedPartitionThresholdBytes`` reads that partition in row ranges
  (``SplitStageReader``), the build partition repeated for each
  (``MappedStageReader``) — OptimizeSkewedJoin,
- coalescing: adjacent small partitions merge toward
  ``advisoryPartitionSizeBytes`` (``CoalescedStageReader``), both inputs of
  a shuffled join with the same groups — CoalesceShufflePartitions.
"""
from __future__ import annotations

import copy
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import pyarrow.dataset as pads
import torch

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..conf import (AQE_ADVISORY_BYTES, AQE_BROADCAST_BYTES,
                    AQE_COALESCE_ENABLED, AQE_MIN_PARTITIONS,
                    AQE_RUNTIME_FILTER, AQE_RUNTIME_FILTER_MAX_KEYS,
                    AQE_SKEW_ENABLED, AQE_SKEW_FACTOR, AQE_SKEW_THRESHOLD,
                    RapidsConf)
from ..exec.base import TpuExec
from ..exec.exchange import TpuLocalExchangeExec, TpuShuffleExchangeExec
from ..exec.transitions import DeviceToHostExec
from ..expr.base import Alias, AttributeReference
from .meta import register_exec_rule, replace_children
from .overrides import _device_all, apply_overrides
from .physical import (CpuFilterExec, CpuProjectExec, CpuScanExec,
                       PhysicalPlan, ShuffleExchangeExec, SinglePartitioning)
from .physical_joins import CpuBroadcastHashJoinExec, CpuShuffledHashJoinExec

__all__ = ["AdaptiveExec", "ShuffleStageExec", "TpuStageReaderExec",
           "CoalescedStageReader", "SplitStageReader", "MappedStageReader",
           "PartitionStats", "materialize_stage", "walk_plan"]


class PartitionStats:
    """Per-partition rows/bytes of a materialized stage (the
    MapOutputStatistics analogue)."""

    def __init__(self, rows: List[int], nbytes: List[int]):
        self.rows = rows
        self.nbytes = nbytes

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes)

    @property
    def total_rows(self) -> int:
        return sum(self.rows)


class ShuffleStageExec(PhysicalPlan):
    """A materialized exchange re-entering the plan as a leaf
    (ShuffleQueryStageExec analogue). ``inner`` is the converted exchange,
    already materialized: a ``TpuLocalExchangeExec``, a
    ``TpuShuffleExchangeExec`` or, when the exchange could not run on the
    device, the host ``ShuffleExchangeExec``."""

    def __init__(self, inner: PhysicalPlan, partitioning,
                 stats: PartitionStats):
        self.inner = inner
        self.children = ()
        self.schema = inner.schema
        self.partitioning = partitioning
        self.stats = stats

    @property
    def device_resident(self) -> bool:
        return isinstance(self.inner, TpuExec)

    @property
    def num_partitions(self) -> int:
        return self.inner.num_partitions

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from self.inner.execute(pidx)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        yield from self.inner.execute_columnar(pidx)

    def node_desc(self) -> str:
        tier = ("local" if isinstance(self.inner, TpuLocalExchangeExec)
                else "ici" if self.device_resident else "host")
        return (f"{tier} n={self.num_partitions} rows={self.stats.total_rows} "
                f"bytes={self.stats.total_bytes}")

    def tree_string(self, indent: int = 0) -> str:
        # the materialized stage's subtree shows below it
        pad = "  " * indent
        return "\n".join([f"{pad}{self.node_name()} [{self.node_desc()}]",
                          self.inner.tree_string(indent + 1)])


class CoalescedStageReader(PhysicalPlan):
    """Reads merged groups of stage partitions (GpuCustomShuffleReaderExec
    with CoalescedPartitionSpec)."""

    def __init__(self, stage: ShuffleStageExec, groups: List[List[int]]):
        self.stage = stage
        self.children = ()
        self.schema = stage.schema
        self.groups = groups

    @property
    def num_partitions(self) -> int:
        return len(self.groups)

    @property
    def device_resident(self) -> bool:
        return self.stage.device_resident

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for p in self.groups[pidx]:
            yield from self.stage.execute(p)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        for p in self.groups[pidx]:
            yield from self.stage.execute_columnar(p)

    def node_desc(self) -> str:
        return f"{self.stage.num_partitions} -> {len(self.groups)}"

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        return "\n".join([f"{pad}{self.node_name()} [{self.node_desc()}]",
                          self.stage.tree_string(indent + 1)])


class SplitStageReader(PhysicalPlan):
    """Probe side of a skew-split join: each output partition is a row
    range ``(partition, lo, hi)`` of one stage partition (hi == -1: to the
    end; ``(p, 0, -1)`` passes the partition through). A split partition
    is concatenated once on the host and dropped when every one of its
    ranges has been read (PartialReducerPartitionSpec analogue)."""

    def __init__(self, stage: ShuffleStageExec, entries: List[tuple]):
        self.stage = stage
        self.children = ()
        self.schema = stage.schema
        self.entries = entries
        self._cache = {}
        self._chunk_ids: dict = {}
        for idx, (orig, lo, hi) in enumerate(entries):
            if not (lo == 0 and hi < 0):
                self._chunk_ids.setdefault(orig, set()).add(idx)
        self._consumed: dict = {}
        # the pipelined collect's drains read ranges of one partition at
        # once: one concatenates it, the others wait
        self._lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return len(self.entries)

    def _partition_table(self, p: int) -> Optional[HostTable]:
        if p not in self._cache:
            batches = list(self.stage.execute(p))
            self._cache[p] = HostTable.concat(batches) if batches else None
        return self._cache[p]

    def execute(self, pidx: int) -> Iterator[HostTable]:
        orig, lo, hi = self.entries[pidx]
        if lo == 0 and hi < 0:
            yield from self.stage.execute(orig)
            return
        with self._lock:
            t = self._partition_table(orig)
            seen = self._consumed.setdefault(orig, set())
            seen.add(pidx)
            if seen >= self._chunk_ids[orig]:  # a full pass: evict
                self._cache.pop(orig, None)
                seen.clear()
        if t is None:
            return
        hi = t.num_rows if hi < 0 else min(hi, t.num_rows)
        if hi > lo:
            yield t.slice(lo, hi - lo)

    def node_desc(self) -> str:
        return f"{self.stage.num_partitions} -> {len(self.entries)} splits"


class MappedStageReader(PhysicalPlan):
    """Build side of a skew-split join: output partition p re-reads stage
    partition ``mapping[p]`` (repeated for each probe range)."""

    def __init__(self, stage: ShuffleStageExec, mapping: List[int]):
        self.stage = stage
        self.children = ()
        self.schema = stage.schema
        self.mapping = mapping

    @property
    def num_partitions(self) -> int:
        return len(self.mapping)

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from self.stage.execute(self.mapping[pidx])

    def node_desc(self) -> str:
        return f"map={self.mapping}"


class TpuStageReaderExec(TpuExec):
    """A device-resident stage read back into the device plan, whole or in
    coalesced groups of its partitions."""

    def __init__(self, stage: ShuffleStageExec,
                 groups: Optional[List[List[int]]] = None):
        super().__init__()
        self.stage = stage
        self.children = ()
        self.schema = stage.schema
        self.groups = groups

    @property
    def num_partitions(self) -> int:
        return len(self.groups) if self.groups is not None \
            else self.stage.num_partitions

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        parts = self.groups[pidx] if self.groups is not None else [pidx]
        for p in parts:
            for b in self.stage.execute_columnar(p):
                self.account_batch()
                yield b

    def node_desc(self) -> str:
        return self.stage.node_desc()

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        return "\n".join([f"{pad}{self.node_name()} [{self.node_desc()}]",
                          self.stage.inner.tree_string(indent + 1)])


def _tag_stage(meta, conf):
    if not meta.plan.device_resident:
        meta.cannot_run("stage materialized on the host tier")


def _tag_reader(meta, conf):
    if not meta.plan.stage.device_resident:
        meta.cannot_run("stage materialized on the host tier")


# wide decimals read back as they were written (the JAX package's
# ``with_decimal128()`` reader signature)
register_exec_rule(ShuffleStageExec, _device_all.with_decimal128(),
                   lambda p, ch, conf, device: TpuStageReaderExec(p),
                   tag_fn=_tag_stage)
register_exec_rule(CoalescedStageReader, _device_all.with_decimal128(),
                   lambda p, ch, conf, device: TpuStageReaderExec(p.stage,
                                                                  p.groups),
                   tag_fn=_tag_reader)


# ---------------------------------------------------------------------------
# Stage materialization
# ---------------------------------------------------------------------------
def _scaled_device_bytes(t: DeviceTable, nrows: int) -> int:
    """A batch's value-plane bytes scaled from its capacity to its rows:
    buffers are capacity-padded, and scaling keeps a small build side from
    looking big (which would keep AQE from demoting its join)."""
    total = 0
    for c in t.columns:
        cap = max(int(c.data.shape[0]), 1)
        total += c.data.numel() * c.data.element_size() * nrows // cap
    return total


def materialize_stage(cpu_exchange: ShuffleExchangeExec, conf: RapidsConf,
                      events: List[str],
                      device: torch.device) -> ShuffleStageExec:
    converted = apply_overrides(cpu_exchange, conf, device)
    # apply_overrides caps a device root with DeviceToHost for the collect
    # boundary; a stage is consumed by the next segment, so unwrap it
    if isinstance(converted, DeviceToHostExec):
        converted = converted.child
    if isinstance(converted, TpuLocalExchangeExec):
        batches = converted.materialize()
        rows = torch.stack([b.num_rows for b in batches]).tolist() \
            if batches else []
        stats = PartitionStats(
            [sum(rows)], [sum(_scaled_device_bytes(b, n)
                              for b, n in zip(batches, rows))])
    elif hasattr(converted, "stage_stats"):
        # an exchange through the shuffle managers (parallel/runtime.py):
        # the writers counted rows and bytes
        stats = PartitionStats(*converted.stage_stats())
    elif isinstance(converted, TpuShuffleExchangeExec):
        # each partition's rows come from the exchange's count pass
        rows, nbytes = [], []
        for p in range(converted.num_partitions):
            handles = converted.partition_handles(p)
            rows.append(sum(n for _h, n in handles))
            nbytes.append(sum(_scaled_device_bytes(h.get(), n)
                              for h, n in handles))
        stats = PartitionStats(rows, nbytes)
    else:
        if not isinstance(converted, ShuffleExchangeExec):
            raise TypeError(f"stage root {type(converted).__name__}")
        parts = converted.materialize()
        stats = PartitionStats([sum(b.num_rows for b in bs) for bs in parts],
                               [sum(b.nbytes() for b in bs) for bs in parts])
    events.append(f"materialized stage n={len(stats.rows)} "
                  f"rows={stats.total_rows} bytes={stats.total_bytes}")
    return ShuffleStageExec(converted, cpu_exchange.partitioning, stats)


# ---------------------------------------------------------------------------
# Plan surgery helpers
# ---------------------------------------------------------------------------
def _replace_node(node: PhysicalPlan, target: PhysicalPlan,
                  repl: PhysicalPlan) -> PhysicalPlan:
    if node is target:
        return repl
    return replace_children(
        node, [_replace_node(c, target, repl) for c in node.children])


def walk_plan(node: PhysicalPlan):
    yield node
    for c in node.children:
        yield from walk_plan(c)


def _frontier_exchanges(plan: PhysicalPlan) -> List[ShuffleExchangeExec]:
    """Exchanges with no exchange below them."""
    return [n for n in walk_plan(plan) if isinstance(n, ShuffleExchangeExec)
            and not any(isinstance(d, ShuffleExchangeExec)
                        for c in n.children for d in walk_plan(c))]


def _merge_groups(nbytes: Sequence[int], target: int,
                  min_parts: int) -> List[List[int]]:
    """Greedy adjacent merge toward the advisory size; the floor of
    ``min_parts`` groups un-merges the largest groups."""
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i, b in enumerate(nbytes):
        if cur and acc + b > target:
            groups.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += b
    if cur:
        groups.append(cur)
    while len(groups) < min_parts:
        big = max(range(len(groups)), key=lambda g: len(groups[g]))
        if len(groups[big]) < 2:
            break
        g = groups.pop(big)
        mid = len(g) // 2
        groups[big:big] = [g[:mid], g[mid:]]
    return groups


# ---------------------------------------------------------------------------
# The adaptive loop
# ---------------------------------------------------------------------------
class AdaptiveExec(PhysicalPlan):
    """Root node that owns the adaptive loop (AdaptiveSparkPlanExec
    analogue). The final plan is built on first execution."""

    def __init__(self, cpu_plan: PhysicalPlan, conf: RapidsConf,
                 device: torch.device):
        self.cpu_plan = cpu_plan
        self.conf = conf
        self.device = device
        self.children = ()
        self.schema = cpu_plan.schema
        self.events: List[str] = []
        self._final: Optional[PhysicalPlan] = None
        # the pipelined collect's drains may race into the loop: the first
        # runs it, the others wait for the final plan
        self._final_lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return self.final_plan().num_partitions

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from self.final_plan().execute(pidx)

    def node_desc(self) -> str:
        return f"isFinal={self._final is not None}"

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        inner = self._final if self._final is not None else self.cpu_plan
        return "\n".join([f"{pad}AdaptiveExec [{self.node_desc()}]",
                          inner.tree_string(indent + 1)])

    def final_plan(self) -> PhysicalPlan:
        with self._final_lock:
            if self._final is None:
                # a stage never waits on the task semaphore holding this
                # shared lock
                from ..parallel.pipeline import exempt_admission
                with exempt_admission():
                    self._final = self._run()
                self.children = (self._final,)
            return self._final

    def _run(self) -> PhysicalPlan:
        plan = self.cpu_plan
        while True:
            plan = self._demote_joins(plan)
            frontier = _frontier_exchanges(plan)
            if not frontier:
                break
            ex = self._pick(frontier, plan)
            stage = materialize_stage(ex, self.conf, self.events,
                                      self.device)
            plan = _replace_node(plan, ex, stage)
        plan = self._demote_joins(plan)
        if self.conf.get(AQE_SKEW_ENABLED):
            plan = self._apply_skew(plan)
        if self.conf.get(AQE_COALESCE_ENABLED):
            plan = self._apply_coalescing(plan)
        return apply_overrides(plan, self.conf, self.device)

    def _pick(self, frontier: List[ShuffleExchangeExec],
              plan: PhysicalPlan) -> ShuffleExchangeExec:
        """Materialize join build sides first, so a small build can demote
        its join before the probe side's exchange costs a stage."""
        build_sides = {id(n.right) for n in walk_plan(plan)
                       if isinstance(n, CpuShuffledHashJoinExec)}
        for ex in frontier:
            if id(ex) in build_sides:
                return ex
        return frontier[0]

    def _demote_joins(self, plan: PhysicalPlan) -> PhysicalPlan:
        threshold = self.conf.get(AQE_BROADCAST_BYTES)
        if threshold < 0:
            return plan

        def rewrite(node: PhysicalPlan) -> PhysicalPlan:
            node = replace_children(node,
                                    [rewrite(c) for c in node.children])
            if type(node) is not CpuShuffledHashJoinExec:
                return node
            right_small = isinstance(node.right, ShuffleStageExec) \
                and node.right.stats.total_bytes <= threshold
            left_small = isinstance(node.left, ShuffleStageExec) \
                and node.left.stats.total_bytes <= threshold
            if right_small and node.how in ("inner", "left", "left_semi",
                                            "left_anti", "cross"):
                probe = node.left
                if isinstance(probe, ShuffleExchangeExec):
                    probe = probe.child  # extraneous shuffle removed
                    self.events.append("removed probe-side exchange (left)")
                self.events.append(
                    f"demoted {node.how} join to broadcast (build side "
                    f"{node.right.stats.total_bytes}B <= {threshold}B)")
                if node.how in ("inner", "left_semi") \
                        and self.conf.get(AQE_RUNTIME_FILTER):
                    # dynamic filter (the DPP analogue): probe rows whose
                    # key is absent from the build side never join; the
                    # reader prunes them by statistics
                    self._push_runtime_filter(probe, node.left_keys,
                                              node.right, node.right_keys)
                return CpuBroadcastHashJoinExec(
                    probe, node.right, node.left_keys, node.right_keys,
                    node.how, node.condition, node.merge_keys)
            if left_small and node.how in ("inner", "right"):
                out_names = list(node.schema.names)
                if len(set(out_names)) != len(out_names):
                    return node  # the order cannot be restored by name
                probe = node.right
                if isinstance(probe, ShuffleExchangeExec):
                    probe = probe.child
                    self.events.append("removed probe-side exchange (right)")
                self.events.append(
                    f"demoted {node.how} join to broadcast via side swap "
                    f"(build side {node.left.stats.total_bytes}B)")
                swapped = CpuBroadcastHashJoinExec(
                    probe, node.left, node.right_keys, node.left_keys,
                    "left" if node.how == "right" else "inner",
                    node.condition, node.merge_keys)
                exprs = [AttributeReference(n, swapped.schema.field(n).dtype,
                                            swapped.schema.field(n).nullable)
                         for n in out_names]
                return CpuProjectExec(swapped, exprs, out_names)
            return node

        return rewrite(plan)

    def _push_runtime_filter(self, probe: PhysicalPlan, lkeys, build_stage,
                             rkeys) -> None:
        """Push the build side's distinct keys into the probe side's host
        scans as an IN filter: only through nodes that keep the key column
        as it is (filters and identity projections), and only into a
        source that takes a filter (Parquet). A scan already lowered to the
        device is not a ``CpuScanExec`` and takes none."""
        max_keys = self.conf.get(AQE_RUNTIME_FILTER_MAX_KEYS)

        def scan_for(node, key):
            """The scan below ``node`` if every step keeps ``key``."""
            if isinstance(node, CpuScanExec):
                return node if hasattr(node.source, "push_filter") else None
            if isinstance(node, CpuFilterExec):
                return scan_for(node.child, key)
            if isinstance(node, CpuProjectExec):
                for e, n in zip(node.exprs, node.names):
                    if n == key:
                        inner = e.child if isinstance(e, Alias) else e
                        if isinstance(inner, AttributeReference) \
                                and inner.column_name == key:
                            return scan_for(node.child, key)
                        return None
            return None

        candidates = [(lk, rk, scan_for(probe, lk))
                      for lk, rk in zip(lkeys, rkeys)]
        candidates = [(lk, rk, s) for lk, rk, s in candidates if s is not None]
        if not candidates:
            return
        # one pass over the build stage collects every key column's values
        values = {lk: set() for lk, _, _ in candidates}
        live = {lk for lk, _, _ in candidates}
        for p in range(build_stage.num_partitions):
            if not live:
                break
            for ht in build_stage.execute(p):
                for lk, rk, _ in candidates:
                    if lk not in live:
                        continue
                    col = ht.column(rk)
                    values[lk].update(
                        np.unique(col.values[col.valid_mask()]).tolist())
                    if len(values[lk]) > max_keys:
                        live.discard(lk)  # this key only; others go on
        for lk, rk, scan in candidates:
            if lk not in live or not values[lk]:
                continue
            src = copy.copy(scan.source)
            src.push_filter(pads.field(lk).isin(sorted(values[lk])))
            scan.source = src
            self.events.append(f"pushed runtime IN-filter on {lk} "
                               f"({len(values[lk])} keys) into probe scan")

    # -- skew split -----------------------------------------------------------
    def _apply_skew(self, plan: PhysicalPlan) -> PhysicalPlan:
        factor = self.conf.get(AQE_SKEW_FACTOR)
        threshold = self.conf.get(AQE_SKEW_THRESHOLD)
        target = max(1, self.conf.get(AQE_ADVISORY_BYTES))

        def rewrite(node: PhysicalPlan) -> PhysicalPlan:
            node = replace_children(node,
                                    [rewrite(c) for c in node.children])
            if type(node) is not CpuShuffledHashJoinExec \
                    or node.how not in ("inner", "left", "left_semi",
                                        "left_anti"):
                return node
            lt, rt = node.left, node.right
            if not (isinstance(lt, ShuffleStageExec)
                    and isinstance(rt, ShuffleStageExec)
                    and lt.num_partitions == rt.num_partitions
                    and lt.num_partitions > 1):
                return node
            sizes = lt.stats.nbytes
            med = sorted(sizes)[len(sizes) // 2]
            skewed = {p for p, b in enumerate(sizes)
                      if b > max(factor * med, threshold)}
            if not skewed:
                return node
            entries: List[tuple] = []
            mapping: List[int] = []
            for p, b in enumerate(sizes):
                rows = lt.stats.rows[p]
                if p in skewed and rows > 1:
                    k = min(rows, max(2, -(-b // target)))
                    per = -(-rows // k)
                    for c in range(k):
                        lo, hi = c * per, min(rows, (c + 1) * per)
                        if hi > lo:
                            entries.append((p, lo, hi))
                            mapping.append(p)
                    self.events.append(
                        f"skew split partition {p} ({b}B) into {k} chunks")
                else:
                    entries.append((p, 0, -1))
                    mapping.append(p)
            return replace_children(node, [SplitStageReader(lt, entries),
                                           MappedStageReader(rt, mapping)])

        return rewrite(plan)

    # -- partition coalescing -------------------------------------------------
    def _apply_coalescing(self, plan: PhysicalPlan) -> PhysicalPlan:
        target = max(1, self.conf.get(AQE_ADVISORY_BYTES))
        min_parts = max(1, self.conf.get(AQE_MIN_PARTITIONS))

        def coalesce_one(stage: ShuffleStageExec, nbytes: Sequence[int]
                         ) -> Optional[List[List[int]]]:
            if stage.num_partitions <= min_parts \
                    or isinstance(stage.partitioning, SinglePartitioning):
                return None
            groups = _merge_groups(nbytes, target, min_parts)
            return groups if len(groups) < stage.num_partitions else None

        def rewrite(node: PhysicalPlan) -> PhysicalPlan:
            # a shuffled join reads both sides in the same groups
            if type(node) is CpuShuffledHashJoinExec \
                    and isinstance(node.left, ShuffleStageExec) \
                    and isinstance(node.right, ShuffleStageExec) \
                    and node.left.num_partitions \
                    == node.right.num_partitions:
                combined = [a + b for a, b in zip(node.left.stats.nbytes,
                                                  node.right.stats.nbytes)]
                groups = coalesce_one(node.left, combined)
                if groups is not None:
                    self.events.append(
                        f"coalesced join inputs {node.left.num_partitions} "
                        f"-> {len(groups)} partitions")
                    return replace_children(
                        node, [CoalescedStageReader(node.left, groups),
                               CoalescedStageReader(node.right, groups)])
                return node
            new_children = []
            for c in node.children:
                if isinstance(c, ShuffleStageExec):
                    groups = coalesce_one(c, c.stats.nbytes)
                    if groups is not None:
                        self.events.append(
                            f"coalesced stage {c.num_partitions} -> "
                            f"{len(groups)} partitions")
                        c = CoalescedStageReader(c, groups)
                    new_children.append(c)
                else:
                    new_children.append(rewrite(c))
            return replace_children(node, new_children)

        return rewrite(plan)
