"""Single-device exchange — the port of ``TpuLocalExchangeExec`` from
``spark_rapids_tpu/exec/exchange.py``.

With one device there is no locality to exploit and no transport to ride:
the whole input coalesces into ONE output partition that never leaves the
device. Single, hash and range partitioning are all satisfied by one
partition (all rows of any key land together; the sort above orders its one
partition), so the exchange never computes partition ids. Each map batch
is compacted and shrunk to the bucket of its row count first, since
post-filter and partial-aggregate batches are mostly masked slack.
Exchanges across devices, which partition rows by ``device_partition_ids``
(shuffle/manager.py), wait for ROADMAP Queue 1: multi-GPU.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..columnar.device import DeviceTable, shrink_to_fit
from ..plan.physical import PhysicalPlan
from .base import TpuExec

__all__ = ["TpuLocalExchangeExec"]


class TpuLocalExchangeExec(TpuExec):
    def __init__(self, child: PhysicalPlan, partitioning, min_bucket: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.min_bucket = min_bucket
        self.schema = child.schema
        self._batches: Optional[List[DeviceTable]] = None

    @property
    def num_partitions(self) -> int:
        return 1

    def node_desc(self) -> str:
        return "local n=1"

    def materialize(self) -> List[DeviceTable]:
        """Drain the child once; the batches stay on the node."""
        if self._batches is None:
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
                    out.append(shrink_to_fit(b, self.min_bucket, num_rows=n))
                    self.account_batch(n)
        return out

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        yield from self.materialize()
