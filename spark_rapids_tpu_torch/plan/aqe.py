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

Not ported yet, until stages have more than one device partition (ROADMAP
Queue 1 step 10): skew splitting and partition coalescing. On one device
every stage is one partition, where neither can fire; a stage of more
partitions (an exchange the host tier ran) is left as it is, and
``AdaptiveExec.events`` records that with either enabled. The
runtime IN-filter pushed into a probe scan needs a source that prunes by
statistics (Parquet, step 7); the in-memory source has none, and the JAX
package pushes nothing into it either.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..conf import (AQE_BROADCAST_BYTES, AQE_COALESCE_ENABLED,
                    AQE_SKEW_ENABLED, RapidsConf)
from ..exec.base import TpuExec
from ..exec.exchange import TpuLocalExchangeExec
from ..exec.transitions import DeviceToHostExec
from ..expr.base import AttributeReference
from .meta import register_exec_rule, replace_children
from .overrides import _device_all, apply_overrides
from .physical import CpuProjectExec, PhysicalPlan, ShuffleExchangeExec
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


register_exec_rule(ShuffleStageExec, _device_all,
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
                    "(ROADMAP Queue 1 step 10)")

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
