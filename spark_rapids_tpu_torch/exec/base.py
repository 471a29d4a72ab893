"""TpuExec — base class for device operators; the port of
``spark_rapids_tpu/exec/base.py`` (reference: GpuExec.scala:208).

A TpuExec produces ``DeviceTable`` batches via ``execute_columnar``; the
row-oriented ``execute`` inherited from PhysicalPlan is implemented once here
as a download.

Fusibility: operators whose per-batch work is a pure function
``DeviceTable -> DeviceTable`` return it from ``batch_fn()``; the
whole-stage pass (exec/wholestage.py) composes adjacent fusible operators
into one node that runs the composed function per batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..plan.physical import PhysicalPlan

__all__ = ["TpuExec", "NUM_OUTPUT_ROWS", "NUM_OUTPUT_BATCHES"]

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"


class TpuExec(PhysicalPlan):
    """Columnar-only device operator.

    ``metrics`` holds plain counters (reference: the ESSENTIAL GpuMetric
    tier, GpuExec.scala:44-60): batches produced, and rows where the count is
    already on the host (reading a device count would wait on the device).
    """

    def __init__(self):
        self.metrics: Dict[str, int] = {NUM_OUTPUT_ROWS: 0,
                                        NUM_OUTPUT_BATCHES: 0}

    def account_batch(self, rows: Optional[int] = None) -> None:
        self.metrics[NUM_OUTPUT_BATCHES] += 1
        if rows is not None:
            self.metrics[NUM_OUTPUT_ROWS] += int(rows)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        raise NotImplementedError(type(self).__name__)

    def batch_fn(self) -> Optional[Callable[[DeviceTable], DeviceTable]]:
        """Pure per-batch device function, or None if not fusible."""
        return None

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
