"""Host<->device transitions — the port of the transition nodes of
``spark_rapids_tpu/exec/transitions.py``.

- ``HostToDeviceExec``   ~ GpuRowToColumnarExec / HostColumnarToGpu
- ``DeviceToHostExec``   ~ GpuColumnarToRowExec / GpuBringBackToHost

The transition inserter (plan/transitions.py) places these where device
sections start and end, like GpuTransitionOverrides.scala:37.
"""
from __future__ import annotations

from typing import Iterator

import torch

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..plan.physical import PhysicalPlan
from .base import TpuExec

__all__ = ["HostToDeviceExec", "DeviceToHostExec"]

UPLOAD_BYTES = "uploadBytes"


class HostToDeviceExec(TpuExec):
    """Uploads each host batch into a bucketed device batch on ``device``."""

    def __init__(self, child: PhysicalPlan, min_bucket: int,
                 device: torch.device):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.schema = child.schema
        self.min_bucket = min_bucket
        self.device = device
        self.metrics[UPLOAD_BYTES] = 0

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        for batch in self.child.execute(pidx):
            dtb = DeviceTable.from_host(batch, self.min_bucket, self.device)
            self.metrics[UPLOAD_BYTES] += dtb.nbytes()
            self.account_batch(batch.num_rows)
            yield dtb


class DeviceToHostExec(PhysicalPlan):
    """Downloads each device batch, compacted to its active rows."""

    def __init__(self, child: TpuExec):
        self.child = child
        self.children = (child,)
        self.schema = child.schema

    @property
    def num_partitions(self) -> int:
        return self.child.num_partitions

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for batch in self.child.execute_columnar(pidx):
            yield batch.to_host()
