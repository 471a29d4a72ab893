"""Mesh stages: the operators after a mesh exchange over every shard at
once — the port of ``spark_rapids_tpu/exec/mesh.py`` (``TpuMeshStageExec``,
``plan_mesh_stages``).

The per-partition consumer contract breaks a mesh exchange's output into
``n`` partitions that the operators above drain one after another. A mesh
stage takes the exchange's output still sharded (keep-sharded mode,
exec/exchange.py) and runs the chain above it, the fusible set of the
whole-stage pass plus a final aggregate, once on each shard: each shard on
its own device's current stream, every shard dispatched before any host
read (the JAX package runs one ``shard_map`` program). The output splits
per partition afterwards.

A final aggregate joins a chain only when the exchange streamed exactly
ONE chunk (the unshard boundary rule): only then does each shard hold its
whole partition. The exchange enforces it: a second streamed chunk reverts
it to per-shard registration, and ``sharded_chunks()`` is None. On that,
or on a classified terminal failure of the dispatch, the stage runs the
original per-partition topology, still linked below it (the exchange
splits its kept chunks late), and the failure feeds the quarantine store
(exec/fallback.py). A stage that may call a kernel never falls back: its
failure propagates.
"""
from __future__ import annotations

import threading
from typing import Iterator, List, Optional

import torch

from ..columnar.device import DeviceTable, shrink_to_fit
from ..conf import MESH_STAGE_ENABLED
from ..plan.meta import replace_children
from ..shuffle import telemetry
from ..utils import faults
from .aggregate import TpuHashAggregateExec
from .base import TpuExec
from .exchange import TpuShuffleExchangeExec
from .wholestage import TpuWholeStageExec, _fusible

__all__ = ["TpuMeshStageExec", "plan_mesh_stages", "MESH_DISPATCHES"]

#: metric: dispatches of the chain over one shard
MESH_DISPATCHES = "meshDispatches"


def _is_final_agg(node) -> bool:
    return isinstance(node, TpuHashAggregateExec) and node.mode == "final"


def _mesh_capable(node) -> bool:
    """Whether ``node`` can join a mesh-stage chain: the whole-stage
    fusible set, a fused whole stage, or a final hash aggregate."""
    if not isinstance(node, TpuExec) or len(node.children) != 1:
        return False
    return isinstance(node, TpuWholeStageExec) or _is_final_agg(node) \
        or _fusible(node)


class TpuMeshStageExec(TpuExec):
    """Runs ``chain`` ([bottom, ..., top], the bottom's child the
    keep-sharded exchange) over every shard. The original per-partition
    topology stays linked below (chain[0] -> exchange, chain[i] ->
    chain[i-1]) for the fallback."""

    def __init__(self, exchange: TpuShuffleExchangeExec,
                 chain: List[TpuExec]):
        super().__init__()
        if not chain:
            raise ValueError("empty mesh-stage chain")
        self.exchange = exchange
        self.chain = list(chain)
        self.child = exchange
        self.children = (exchange,)
        self.schema = self.chain[-1].schema
        self.mesh = exchange.mesh
        self.metrics[MESH_DISPATCHES] = 0
        #: per-partition output once materialized; None after a fallback
        self._results: Optional[List[List[DeviceTable]]] = None
        self._fell_back = False
        self._mat_lock = threading.Lock()
        exchange.request_keep_sharded()

    def absorb(self, node: TpuExec) -> "TpuMeshStageExec":
        """Grow the chain upward; the node's child goes back to the chain's
        top, so the fallback topology stays the original plan."""
        replace_children(node, [self.chain[-1]])
        self.chain.append(node)
        self.schema = node.schema
        return self

    @property
    def num_partitions(self) -> int:
        return self.exchange.num_partitions

    @property
    def fell_back(self) -> bool:
        return self._fell_back

    def node_name(self):
        inner = "+".join(type(n).__name__.replace("Tpu", "")
                         .replace("Exec", "") for n in self.chain)
        return f"TpuMeshStage[{inner}]"

    def node_desc(self) -> str:
        return f"mesh n={self.num_partitions} axis={self.mesh.axis}"

    def plan_signature(self) -> str:
        return "MESH|" + "||".join(n.plan_signature() for n in self.chain)

    def runs_kernel(self) -> bool:
        return any(n.runs_kernel() for n in self.chain)

    def _has_final_agg(self) -> bool:
        return any(_is_final_agg(n) for n in self.chain)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        self._materialize()
        if self._results is None:
            # the unshard boundary or a terminal failure: the original
            # per-partition topology serves the drain
            yield from self.chain[-1].execute_columnar(pidx)
            return
        yield from self._results[pidx]

    def _materialize(self) -> None:
        with self._mat_lock:
            if self._results is not None or self._fell_back:
                return
            from ..parallel.pipeline import exempt_admission
            with exempt_admission():
                self._materialize_locked()

    def _materialize_locked(self) -> None:
        from .fallback import classify_failure, quarantine_on_failure
        n = self.num_partitions
        chunks = self.exchange.sharded_chunks()
        if chunks is None:
            self._fell_back = True  # a per-partition consumer split it
            return
        if not chunks:
            self._results = [[] for _ in range(n)]
            return
        if self._has_final_agg() and len(chunks) > 1:
            self._fell_back = True  # the unshard boundary rule
            return
        try:
            with quarantine_on_failure(self):
                outs = [self._dispatch_chunk(c) for c, _ in chunks]
        except Exception as e:
            if classify_failure(e) is None or self.runs_kernel():
                raise
            self._fell_back = True
            return
        per_part: List[List[DeviceTable]] = [[] for _ in range(n)]
        if self._has_final_agg():
            # one compacted batch a partition, as the final aggregate's own
            # path yields; every shard's count crosses in one copy. A shard
            # with neither input nor output rows yields nothing (the keyed
            # aggregate skips an input-less partition)
            parts, (_, in_rows) = outs[0], chunks[0]
            floor = next(n.min_bucket for n in self.chain
                         if _is_final_agg(n))
            first = self.mesh.devices[0]
            counts = torch.stack([t.num_rows.to(first) for t in parts]) \
                .tolist()
            for i, (t, rows) in enumerate(zip(parts, counts)):
                if rows == 0 and in_rows[i] == 0:
                    continue
                per_part[i].append(shrink_to_fit(t, floor, num_rows=rows))
                self.account_batch(rows)
        else:
            # the split path registers only shards with rows, so a shard
            # the exchange sent nothing yields no batch
            for parts, (_, in_rows) in zip(outs, chunks):
                for i, t in enumerate(parts):
                    if in_rows[i]:
                        per_part[i].append(t)
                        self.account_batch()
        self._results = per_part

    def _dispatch_chunk(self, chunk) -> List[DeviceTable]:
        """The chain over each shard of one kept chunk: every shard is
        dispatched on its device before anything is read back."""
        action = faults.fire("mesh.dispatch")
        if action is not None and action != "delay":
            from ..memory.retry import DeviceOomError, InjectedDeviceFailure
            if action == "oom":
                raise DeviceOomError("injected device OOM at mesh.dispatch "
                                     "(faults action=oom)")
            # the failure class a real terminal dispatch failure takes, so
            # the stage degrades to the per-partition path as it would
            raise InjectedDeviceFailure("injected mesh-stage dispatch "
                                        "failure (mesh.dispatch)")
        fns = [node.batch_fn() for node in self.chain]
        t0 = telemetry.clock()
        out = []
        for shard in chunk.shards:
            with _device_guard(shard.device):
                t = shard
                for f in fns:
                    t = f(t)
            out.append(t)
            self.metrics[MESH_DISPATCHES] += 1
        telemetry.note_transfer(
            "ici", "mesh_stage", shuffle_id=self.exchange.telemetry_sid,
            t0=t0, queue_depth=len(chunk.shards), wire_bytes=chunk.nbytes)
        return out


def _device_guard(device: torch.device):
    """The device's guard for a CUDA shard (its ops then default to it)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    import contextlib
    return contextlib.nullcontext()


def plan_mesh_stages(plan, conf=None):
    """Bottom-up pass rewriting ``mesh exchange -> mesh-capable chain`` into
    a ``TpuMeshStageExec``. It runs after whole-stage fusion, so a fused
    stage on a mesh exchange is absorbed whole, and consecutive capable
    parents (a final aggregate, then the projection above it) extend the
    chain; at most one final aggregate a chain. Sorts, joins and the rest
    take the per-partition output as before."""
    if conf is not None and not conf.get(MESH_STAGE_ENABLED):
        return plan

    def rebuild(node):
        node = replace_children(node, [rebuild(c) for c in node.children])
        if _mesh_capable(node):
            ch = node.children[0]
            if isinstance(ch, TpuMeshStageExec):
                if not (_is_final_agg(node) and ch._has_final_agg()):
                    return ch.absorb(node)
            elif isinstance(ch, TpuShuffleExchangeExec) \
                    and ch.num_partitions > 1:
                return TpuMeshStageExec(ch, [node])
        return node

    return rebuild(plan)
