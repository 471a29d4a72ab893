"""Transition insertion — the port of ``spark_rapids_tpu/plan/transitions.py``
(reference: GpuTransitionOverrides.scala:37).

Walks the converted (mixed host/device) plan and inserts:
- ``HostToDeviceExec`` where a device operator consumes a host-producing child
- ``DeviceToHostExec`` where a host operator (or the collect boundary)
  consumes a device operator
"""
from __future__ import annotations

import torch

from ..conf import RapidsConf
from ..exec.base import TpuExec
from ..exec.transitions import DeviceToHostExec, HostToDeviceExec
from .meta import replace_children
from .physical import PhysicalPlan

__all__ = ["insert_transitions"]


def insert_transitions(plan: PhysicalPlan, conf: RapidsConf,
                       device: torch.device) -> PhysicalPlan:
    def walk(node: PhysicalPlan) -> PhysicalPlan:
        new_children = []
        for c in node.children:
            c2 = walk(c)
            if isinstance(node, TpuExec) and not isinstance(c2, TpuExec):
                c2 = HostToDeviceExec(c2, conf.min_bucket_rows, device)
            elif not isinstance(node, TpuExec) and isinstance(c2, TpuExec):
                c2 = DeviceToHostExec(c2)
            new_children.append(c2)
        return replace_children(node, new_children)

    out = walk(plan)
    return DeviceToHostExec(out) if isinstance(out, TpuExec) else out
