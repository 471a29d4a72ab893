"""Basic device operators: Project and Filter — the port of those nodes of
``spark_rapids_tpu/exec/basic.py`` (reference:
basicPhysicalOperators.scala:115,313).

Both are pure per-batch functions — Filter only ANDs the selection mask (no
gather), so a filter+project chain fuses into one whole-stage node with no
intermediate compaction.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Sequence

import torch

from ..columnar.device import DeviceColumn, DeviceTable, torch_dtype
from ..expr.base import EvalContext, Expression
from ..plan.physical import PhysicalPlan
from ..plan.schema import Field, Schema
from .base import TpuExec

__all__ = ["TpuProjectExec", "TpuFilterExec", "eval_exprs_device"]


def eval_exprs_device(table: DeviceTable, exprs: Sequence[Expression],
                      names: Sequence[str]) -> DeviceTable:
    ctx = EvalContext.for_device(table)
    cols: List[DeviceColumn] = []
    for e in exprs:
        c = e.eval(ctx)
        # no validity plane out of evaluation: the column is null-free
        all_valid = c.validity is None
        validity = torch.ones(table.capacity, dtype=torch.bool,
                              device=table.device) if all_valid \
            else c.validity
        values = c.values.to(torch_dtype(c.dtype))
        cols.append(DeviceColumn(values, validity, c.dtype, all_valid,
                                 lengths=c.lengths))
    return DeviceTable(tuple(cols), table.row_mask, table.num_rows,
                       tuple(names))


class _PerBatchExec(TpuExec):
    """A device operator that applies its ``batch_fn`` to every batch."""

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        fn = self.batch_fn()
        for batch in self.child_device_batches(pidx):
            out = fn(batch)
            self.account_batch()
            yield out


class TpuProjectExec(_PerBatchExec):
    def __init__(self, child: PhysicalPlan, exprs: Sequence[Expression],
                 names: Sequence[str]):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.exprs = list(exprs)
        self.names = list(names)
        self.schema = Schema([Field(n, e.data_type, e.nullable)
                              for n, e in zip(names, exprs)])

    def batch_fn(self) -> Callable[[DeviceTable], DeviceTable]:
        exprs, names = self.exprs, self.names

        def fn(table: DeviceTable) -> DeviceTable:
            return eval_exprs_device(table, exprs, names)
        return fn

    def node_desc(self):
        return ", ".join(self.names)


class TpuFilterExec(_PerBatchExec):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.condition = condition
        self.schema = child.schema

    def batch_fn(self) -> Callable[[DeviceTable], DeviceTable]:
        cond = self.condition

        def fn(table: DeviceTable) -> DeviceTable:
            c = cond.eval(EvalContext.for_device(table))
            keep = c.values
            if c.validity is not None:
                keep = torch.logical_and(keep, c.validity)
            return table.filter_mask(keep)
        return fn

    def node_desc(self):
        return repr(self.condition)
