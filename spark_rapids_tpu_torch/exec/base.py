"""TpuExec — base class for device operators; the port of
``spark_rapids_tpu/exec/base.py`` (reference: GpuExec.scala:208).

A TpuExec produces ``DeviceTable`` batches via ``execute_columnar``; the
row-oriented ``execute`` inherited from PhysicalPlan is implemented once here
as a download.

Fusibility: operators whose per-batch work is a pure function
``DeviceTable -> DeviceTable`` return it from ``batch_fn()``; the
whole-stage pass (exec/wholestage.py) composes adjacent fusible operators
into one node that runs the composed function per batch. Such an operator
also names its host-engine twin (``host_batch_fn``), which the runtime
fallback (exec/fallback.py) runs a batch through when the device path fails
terminally, and a ``plan_signature`` that keys the quarantine store.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable, Dict, Iterator, Optional

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..plan.physical import PhysicalPlan

__all__ = ["TpuExec", "NUM_OUTPUT_ROWS", "NUM_OUTPUT_BATCHES",
           "any_runs_kernel"]

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"

_NODE_IDS = itertools.count(1)


def any_runs_kernel(exprs) -> bool:
    """Whether any of ``exprs`` (None entries skipped) calls a kernel."""
    return any(e is not None and e.tree_runs_kernel() for e in exprs)


def _in_node_scope(execute_columnar):
    """Wrap a node's batch generator so each resume runs in its node scope
    (utils/node_context.py): the catalog's registrations and spills, and so
    the memory profiler's holders, are attributed to the operator that
    drives them."""
    from ..utils.node_context import node_scope

    @functools.wraps(execute_columnar)
    def run(self, pidx: int) -> Iterator[DeviceTable]:
        node_id = self.__dict__.get("_node_id")
        if node_id is None:
            node_id = self._node_id = next(_NODE_IDS)
        name = type(self).__name__
        gen = execute_columnar(self, pidx)
        box = []  # no local keeps a yielded batch while the consumer runs
        try:
            while True:
                with node_scope(node_id, name):
                    try:
                        box.append(next(gen))
                    except StopIteration:
                        return
                yield box.pop()
        finally:
            gen.close()
    run._node_scoped = True
    return run


class TpuExec(PhysicalPlan):
    """Columnar-only device operator.

    ``metrics`` holds plain counters (reference: the ESSENTIAL GpuMetric
    tier, GpuExec.scala:44-60): batches produced, and rows where the count is
    already on the host (reading a device count would wait on the device).
    """

    def __init__(self):
        self.metrics: Dict[str, int] = {NUM_OUTPUT_ROWS: 0,
                                        NUM_OUTPUT_BATCHES: 0}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fn = cls.__dict__.get("execute_columnar")
        if fn is not None and not getattr(fn, "_node_scoped", False):
            cls.execute_columnar = _in_node_scope(fn)

    def account_batch(self, rows: Optional[int] = None) -> None:
        self.metrics[NUM_OUTPUT_BATCHES] += 1
        if rows is not None:
            self.metrics[NUM_OUTPUT_ROWS] += int(rows)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        raise NotImplementedError(type(self).__name__)

    def batch_fn(self) -> Optional[Callable[[DeviceTable], DeviceTable]]:
        """Pure per-batch device function, or None if not fusible."""
        return None

    def host_batch_fn(self) -> Optional[Callable[[HostTable], HostTable]]:
        """The host-engine equivalent of ``batch_fn``, or None when the
        operator has no batch-local host path (final aggregates, sorts,
        joins: they quarantine on a terminal failure but cannot fall back
        mid-stream)."""
        return None

    def runs_kernel(self) -> bool:
        """Whether a batch of this node may call a hand-written kernel's
        wrapper: the runtime fallback then neither reruns it on the host
        nor quarantines it (exec/fallback.py), so no kernel is hidden."""
        return False

    def plan_signature(self) -> str:
        """This node's computation, keying the quarantine store."""
        child_schema = repr(self.children[0].schema) \
            if self.children and hasattr(self.children[0], "schema") else ""
        return f"{type(self).__name__}|{self.node_desc()}|{child_schema}"

    @property
    def fusible(self) -> bool:
        """Whether per-batch application preserves semantics (operators that
        must see all batches — final aggregates — override to False)."""
        return self.batch_fn() is not None

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for batch in self.execute_columnar(pidx):
            yield batch.to_host()

    def child_device_batches(self, pidx: int) -> Iterator[DeviceTable]:
        child = self.children[0]
        if not hasattr(child, "execute_columnar"):
            raise TypeError(f"device exec {type(self).__name__} over host "
                            f"child {type(child).__name__} (missing "
                            "transition)")
        return child.execute_columnar(pidx)
