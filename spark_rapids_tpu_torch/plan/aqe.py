"""Adaptive query execution (AQE) — the port of the single-device core of
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
masks not counted), so both engines demote the same joins.

When a join demotes to broadcast (inner and left-semi), the build side's
distinct keys are pushed into the probe side's host scan as a runtime IN
filter, when the scan's source prunes by statistics (Parquet) and the path
from the join to it keeps the key column; a scan already lowered to the
device (``TpuParquetScanExec``) takes none, as in the JAX package.

Not ported yet, until stages have more than one device partition (ROADMAP
Queue 1: multi-GPU): skew splitting and partition coalescing. On one
device every stage is one partition, where neither can fire; a stage of
more partitions (an exchange the host tier ran) is left as it is, and
``AdaptiveExec.events`` records that with either enabled.
"""
from __future__ import annotations

import copy
from typing import Iterator, List, Optional

import numpy as np
import pyarrow.dataset as pads
import torch

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..conf import (AQE_BROADCAST_BYTES, AQE_COALESCE_ENABLED,
                    AQE_RUNTIME_FILTER, AQE_RUNTIME_FILTER_MAX_KEYS,
                    AQE_SKEW_ENABLED, STEP_MULTI_GPU, RapidsConf, not_ported)
from ..exec.base import TpuExec
from ..exec.exchange import TpuLocalExchangeExec
from ..exec.transitions import DeviceToHostExec
from ..expr.base import Alias, AttributeReference
from .meta import register_exec_rule, replace_children
from .overrides import _device_all, apply_overrides
from .physical import (CpuFilterExec, CpuProjectExec, CpuScanExec,
                       PhysicalPlan, ShuffleExchangeExec)
from .physical_joins import CpuBroadcastHashJoinExec, CpuShuffledHashJoinExec

__all__ = ["AdaptiveExec", "ShuffleStageExec", "TpuStageReaderExec",
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
    already materialized: a ``TpuLocalExchangeExec`` or, when the exchange
    could not run on the device, the host ``ShuffleExchangeExec``."""

    def __init__(self, inner: PhysicalPlan, stats: PartitionStats):
        self.inner = inner
        self.children = ()
        self.schema = inner.schema
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
        tier = "local" if self.device_resident else "host"
        return (f"{tier} n={self.num_partitions} rows={self.stats.total_rows} "
                f"bytes={self.stats.total_bytes}")

    def tree_string(self, indent: int = 0) -> str:
        # the materialized stage's subtree shows below it
        pad = "  " * indent
        return "\n".join([f"{pad}{self.node_name()} [{self.node_desc()}]",
                          self.inner.tree_string(indent + 1)])


class TpuStageReaderExec(TpuExec):
    """The device-resident stage read back into the device plan."""

    def __init__(self, stage: ShuffleStageExec):
        super().__init__()
        self.stage = stage
        self.children = ()
        self.schema = stage.schema

    @property
    def num_partitions(self) -> int:
        return self.stage.num_partitions

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        for b in self.stage.execute_columnar(pidx):
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


# wide decimals read back as they were written (the JAX package's
# ``with_decimal128()`` reader signature)
register_exec_rule(ShuffleStageExec, _device_all.with_decimal128(),
                   lambda p, ch, conf, device: TpuStageReaderExec(p),
                   tag_fn=_tag_stage)


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
    else:
        if not isinstance(converted, ShuffleExchangeExec):
            raise TypeError(f"stage root {type(converted).__name__}")
        parts = converted.materialize()
        stats = PartitionStats([sum(b.num_rows for b in bs) for bs in parts],
                               [sum(b.nbytes() for b in bs) for bs in parts])
    events.append(f"materialized stage n={len(stats.rows)} "
                  f"rows={stats.total_rows} bytes={stats.total_bytes}")
    return ShuffleStageExec(converted, stats)


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
        if self._final is None:
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
        self._note_unrewritten_stages(plan)
        return apply_overrides(plan, self.conf, self.device)

    def _note_unrewritten_stages(self, plan: PhysicalPlan) -> None:
        """Skew splitting and coalescing rewrite only stages of more than
        one partition, which one device never makes. A stage the host tier
        partitioned is left as it is: the same rows, unrewritten."""
        if not (self.conf.get(AQE_SKEW_ENABLED)
                or self.conf.get(AQE_COALESCE_ENABLED)):
            return
        for n in walk_plan(plan):
            if isinstance(n, ShuffleStageExec) and n.num_partitions > 1:
                self.events.append(
                    f"left stage n={n.num_partitions} as it is: skew "
                    "splitting and partition coalescing are not ported yet "
                    + not_ported(STEP_MULTI_GPU))

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
