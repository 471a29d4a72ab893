"""Transition insertion — the port of ``spark_rapids_tpu/plan/transitions.py``
(reference: GpuTransitionOverrides.scala:37).

Walks the converted (mixed host/device) plan and inserts:
- ``HostToDeviceExec`` where a device operator consumes a host-producing child
- ``DeviceToHostExec`` where a host operator (or the collect boundary)
  consumes a device operator

Each upload goes through the upload cache within its byte budget
(``spark.rapids.tpu.scan.deviceCache.*``), and with
``spark.rapids.tpu.coalesce.afterUpload.enabled`` a
``TpuCoalesceBatchesExec`` stitches the uploaded batches to full size
(reference: childrenCoalesceGoal / GpuCoalesceBatches).
"""
from __future__ import annotations

import torch

from ..conf import (ASYNC_ENABLED, COALESCE_AFTER_UPLOAD,
                    COALESCE_TARGET_BYTES, SCAN_DEVICE_CACHE,
                    SCAN_DEVICE_CACHE_MAX_BYTES, RapidsConf)
from ..exec.base import TpuExec
from ..exec.transitions import (DeviceToHostExec, HostToDeviceExec,
                                TpuCoalesceBatchesExec)
from .meta import replace_children
from .physical import DEFAULT_BATCH_ROWS, PhysicalPlan

__all__ = ["insert_transitions"]


def insert_transitions(plan: PhysicalPlan, conf: RapidsConf,
                       device: torch.device) -> PhysicalPlan:
    cache_bytes = conf.get(SCAN_DEVICE_CACHE_MAX_BYTES) \
        if conf.get(SCAN_DEVICE_CACHE) else 0
    bulk = conf.get(ASYNC_ENABLED)

    def walk(node: PhysicalPlan) -> PhysicalPlan:
        new_children = []
        for c in node.children:
            c2 = walk(c)
            if isinstance(node, TpuExec) and not isinstance(c2, TpuExec):
                c2 = HostToDeviceExec(c2, conf.min_bucket_rows, device,
                                      cache_max_bytes=cache_bytes, conf=conf)
                if conf.get(COALESCE_AFTER_UPLOAD):
                    c2 = TpuCoalesceBatchesExec(
                        c2, target_rows=DEFAULT_BATCH_ROWS,
                        min_bucket=conf.min_bucket_rows,
                        target_bytes=conf.get(COALESCE_TARGET_BYTES))
            elif not isinstance(node, TpuExec) and isinstance(c2, TpuExec):
                c2 = DeviceToHostExec(c2, bulk, conf)
            new_children.append(c2)
        return replace_children(node, new_children)

    out = walk(plan)
    return DeviceToHostExec(out, bulk, conf) if isinstance(out, TpuExec) \
        else out
