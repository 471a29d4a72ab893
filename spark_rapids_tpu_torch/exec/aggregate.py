"""Device aggregate without grouping keys — the port of the ungrouped path of
``spark_rapids_tpu/exec/aggregate.py`` (reference: aggregate.scala,
GpuHashAggregateExec at :1319).

The partial pass reduces each batch to one state row (a masked reduction per
state column) and fuses into the whole-stage node above the upload; the
final pass concatenates the state rows it receives and reduces them again
with the merge ops. Keyed aggregation (the hash strategy) is a later step of
the port (ROADMAP Queue 1 step 4).
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable,
                               concat_device_tables, shrink_to_fit,
                               torch_dtype)
from ..plan.physical import (AggSpec, PhysicalPlan, _check_mode_and_keys,
                             aggregate_columns_ops)
from ..plan.schema import Field, Schema
from .base import TpuExec

__all__ = ["TpuHashAggregateExec"]

#: capacity of the one-state-row output batch
_STATE_CAPACITY = 8
#: input capacity the final pass gathers before one reduction
_CHUNK_CAPACITY = 1 << 20


def _minmax_identity(dtype: torch.dtype, for_min: bool):
    if dtype == torch.bool:
        return for_min
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.max if for_min else info.min


def _reduce(op: str, vals: torch.Tensor, contrib: torch.Tensor,
            out_dt: dt.DataType) -> Tuple[torch.Tensor, torch.Tensor]:
    """One whole-batch reduction -> (value, has) as 0-d tensors; ``has`` is
    False when no row contributed (the value is then null).

    Spark rules: NaN is the largest double; sum propagates NaN; masked-off
    rows may hold stale data (even NaN), so they are replaced with the
    identity by ``where`` and never multiplied by the mask."""
    out_dtype = torch_dtype(out_dt)
    counts = contrib.sum(dtype=torch.int64)
    has = counts > 0
    if op == "count":
        return counts.to(out_dtype), torch.ones((), dtype=torch.bool,
                                                device=vals.device)
    if op == "sum":
        x = torch.where(contrib, vals.to(out_dtype), 0)
        return x.sum(), has
    if op not in ("min", "max"):
        raise ValueError(op)
    x = vals.to(torch.int32) if vals.dtype == torch.bool else vals
    ident = _minmax_identity(x.dtype, op == "min")
    isfloat = x.dtype.is_floating_point
    if isfloat:
        # Spark total order: NaN is the largest value
        nan = torch.isnan(x)
        x = torch.where(nan, float("inf") if op == "min" else float("-inf"),
                        x)
    x = torch.where(contrib, x, ident)
    out = x.amin() if op == "min" else x.amax()
    if isfloat:
        if op == "min":
            # NaN only when every contributing value is NaN
            nonnan = torch.logical_and(contrib, ~nan).sum()
            out = torch.where(torch.logical_and(has, nonnan == 0),
                              float("nan"), out)
        else:
            out = torch.where(torch.logical_and(contrib, nan).any(),
                              float("nan"), out)
    return out.to(out_dtype), has


class TpuHashAggregateExec(TpuExec):
    """Same pre-projected input contract as CpuHashAggregateExec."""

    def __init__(self, child: PhysicalPlan, key_names: List[str],
                 specs: List[AggSpec], mode: str, device: torch.device):
        super().__init__()
        _check_mode_and_keys(mode, key_names)
        self.child = child
        self.children = (child,)
        self.key_names = list(key_names)
        self.specs = specs
        self.mode = mode
        #: where the empty-input state row is built
        self.device = device
        self.schema = Schema([Field(n, d, nb) for s in specs
                              for (n, d, nb) in s.state_fields])

    @property
    def fusible(self) -> bool:
        # partial mode emits one state row per input batch (downstream merge
        # reduces them); final mode must merge across batches itself
        return self.mode == "partial"

    def batch_fn(self, mode: str = None) -> Callable[[DeviceTable], DeviceTable]:
        """One batch -> its state row. ``mode`` defaults to this node's; the
        final pass also merges its own outputs with ``"final"``."""
        cols_ops = aggregate_columns_ops(self.specs, mode or self.mode)
        out_names = tuple(self.schema.names)

        def ungrouped(table: DeviceTable) -> DeviceTable:
            out_cols = []
            for in_col, op, _, out_dt in cols_ops:
                col = table.column(in_col)
                contrib = table.row_mask if col.all_valid \
                    else torch.logical_and(col.validity, table.row_mask)
                val, has = _reduce(op, col.data, contrib, out_dt)
                # state row 0 of a fixed small capacity, built on the device
                # (no host read of the reduced values)
                vals = torch.zeros(_STATE_CAPACITY, dtype=val.dtype,
                                   device=val.device)
                vals[0] = val
                validity = torch.zeros(_STATE_CAPACITY, dtype=torch.bool,
                                       device=val.device)
                validity[0] = has
                out_cols.append(DeviceColumn(vals, validity, out_dt))
            row_mask = torch.arange(_STATE_CAPACITY,
                                    device=table.device) < 1
            return DeviceTable(tuple(out_cols), row_mask,
                               torch.ones((), dtype=torch.int32,
                                          device=table.device), out_names)

        return ungrouped

    def _chunks(self, pidx: int) -> Iterator[DeviceTable]:
        """Child batches concatenated up to ~1M rows of capacity, so one
        reduction covers many small state batches."""
        staged: List[DeviceTable] = []
        cap = 0
        for b in self.child_device_batches(pidx):
            staged.append(b)
            cap += b.capacity
            if cap >= _CHUNK_CAPACITY:
                yield concat_device_tables(staged)
                staged, cap = [], 0
        if staged:
            yield concat_device_tables(staged)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        fn = self.batch_fn()
        merge_fn = self.batch_fn("final")
        pending = None  # the running merged state row
        for chunk in self._chunks(pidx):
            out = shrink_to_fit(fn(chunk))
            if pending is not None:
                out = shrink_to_fit(merge_fn(concat_device_tables([pending,
                                                                   out])))
            pending = out
        if pending is None:
            # no input batch at all: the grand aggregate of nothing
            pending = fn(_empty_device_table(self.child.schema,
                                             _STATE_CAPACITY, self.device))
        self.account_batch(1)
        yield pending

    def node_desc(self):
        return f"mode={self.mode} keys={self.key_names}"


def _empty_device_table(schema: Schema, cap: int,
                        device: torch.device) -> DeviceTable:
    cols = [DeviceColumn(torch.zeros(cap, dtype=torch_dtype(f.dtype),
                                     device=device),
                         torch.zeros(cap, dtype=torch.bool, device=device),
                         f.dtype) for f in schema]
    return DeviceTable(tuple(cols), torch.zeros(cap, dtype=torch.bool,
                                                device=device),
                       torch.zeros((), dtype=torch.int32, device=device),
                       tuple(schema.names))
