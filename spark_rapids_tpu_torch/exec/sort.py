"""Device sort — the port of ``spark_rapids_tpu/exec/sort.py``
(reference: GpuSortExec.scala, FullSortSingleBatch mode at :39).

One stable multi-key sort over transformed key planes, then a gather of
every column. ``jnp.lexsort`` has no torch counterpart, so the sort is a
chain of stable argsorts from the least significant key up: a stable
lexsort gives exactly the permutation of that chain.

Spark ordering semantics: nulls first/last per order, NaN greater than all
numbers, -0.0 == 0.0.

``TpuTakeOrderedExec`` is top-n: each batch is sorted and cut to its
first n rows, and a running state of at most n rows is merged with each
batch's top by the same sort.

The out-of-core merge for inputs larger than the batch budget waits for
the spill catalog (ROADMAP Queue 1: the grace join and the spill
catalog).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               concat_device_tables, pack_string_key_words)
from ..conf import STEP_GRACE_JOIN, not_ported
from ..expr.base import EvalContext
from ..expr.functions import SortOrder
from ..plan.physical import PhysicalPlan, describe_orders
from .base import TpuExec

__all__ = ["TpuSortExec", "TpuTakeOrderedExec", "device_sort_table"]

_SIGN = -2**63


def _order_keys(table: DeviceTable, orders: Sequence[SortOrder]
                ) -> List[torch.Tensor]:
    """Sort key planes, least significant first, implementing Spark
    ordering: every plane sorts ascending in torch's signed order."""
    ctx = EvalContext.for_device(table)
    keys: List[torch.Tensor] = []
    for o in reversed(list(orders)):
        c = o.expr.eval(ctx)
        v = c.values
        if v.dtype.is_floating_point:
            nan = torch.isnan(v)
            v = torch.where(v == 0, torch.zeros_like(v), v)    # -0.0 -> 0.0
            v = torch.where(nan, float("inf"), v)              # NaN sorts high
            nan_key = nan  # among +inf ties, NaN after true inf
            if not o.ascending:
                # negate, and fold the -0.0 the negation makes back into 0.0
                v = torch.where(v == 0, torch.zeros_like(v), -v)
                nan_key = torch.logical_not(nan)
            keys.append(nan_key.to(torch.uint8))
            keys.append(v)
        elif v.dim() == 2:  # string: packed words, most significant first
            # the sign flip turns the words' unsigned order into torch's
            # signed order; bit inversion then reverses it
            words = [w ^ _SIGN for w in pack_string_key_words(v, c.lengths)]
            if not o.ascending:
                words = [~w for w in words]
            keys.extend(reversed(words))   # least significant word first
        elif v.dtype == torch.bool:
            # Spark orders false < true
            keys.append((v if o.ascending else ~v).to(torch.uint8))
        else:
            # ~v = -v - 1 reverses the order without the overflow of -v
            # at the type's minimum
            keys.append(v if o.ascending else ~v)
        valid = c.validity
        if valid is None:
            valid = torch.ones(table.capacity, dtype=torch.bool,
                               device=table.device)
        # nulls_first: a null sorts as 0 (before valid=1); else after
        null_key = valid if o.nulls_first else torch.logical_not(valid)
        keys.append(null_key.to(torch.uint8))
    # primary: active rows first
    keys.append(torch.logical_not(table.row_mask).to(torch.uint8))
    return keys


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: the permutation that sorts by ``keys[-1]``, then
    ``keys[-2]``, ..., stably — one stable argsort per key from the least
    significant up."""
    order = torch.arange(keys[0].shape[0], dtype=torch.int64,
                         device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def device_sort_table(table: DeviceTable, orders: Sequence[SortOrder]
                      ) -> DeviceTable:
    order = lexsort(_order_keys(table, orders))
    # the permutation parks masked-off rows past num_rows; the dense prefix
    # mask below exposes only real rows (all_valid survives)
    cols = tuple(c.gather(order) for c in table.columns)
    iota = torch.arange(table.capacity, dtype=torch.int32,
                        device=table.device)
    return DeviceTable(cols, iota < table.num_rows, table.num_rows,
                       table.names)


def device_top_n(table: DeviceTable, orders: Sequence[SortOrder], n: int,
                 cap: int) -> DeviceTable:
    """The first ``n`` rows of ``table`` in sort order, in at most ``cap``
    rows of capacity (the bucket of ``n``)."""
    s = device_sort_table(table, orders)
    keep = torch.clamp(s.num_rows, max=n)
    rows = min(cap, s.capacity)
    mask = torch.arange(rows, dtype=torch.int32, device=s.device) < keep
    cols = tuple(DeviceColumn(
        c.data[:rows], torch.logical_and(c.validity[:rows], mask), c.dtype,
        c.all_valid, None if c.lengths is None else c.lengths[:rows])
        for c in s.columns)
    return DeviceTable(cols, mask, keep, s.names)


class TpuTakeOrderedExec(TpuExec):
    """Device top-n (reference: GpuTakeOrderedAndProjectExec, limit.scala):
    a running top-n folded over the batches, the state at the bucketed
    n-row capacity."""

    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder],
                 n: int, min_bucket: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.orders = list(orders)
        self.n = n
        self.schema = child.schema
        self.min_bucket = min_bucket

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        cap = bucket_rows(max(self.n, 1), self.min_bucket)
        state = None
        for batch in self.child_device_batches(pidx):
            top = device_top_n(batch, self.orders, self.n, cap)
            if state is not None:
                top = device_top_n(concat_device_tables([state, top]),
                                   self.orders, self.n, cap)
            state = top
        if state is not None:
            self.account_batch()
            yield state

    def node_desc(self):
        return f"n={self.n}"


class TpuSortExec(TpuExec):
    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder],
                 min_bucket: int, batch_bytes: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.orders = list(orders)
        self.schema = child.schema
        self.min_bucket = min_bucket
        self.batch_bytes = batch_bytes

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        batches = list(self.child_device_batches(pidx))
        if not batches:
            return
        if len(batches) > 1 \
                and sum(b.nbytes() for b in batches) > self.batch_bytes:
            raise NotImplementedError(
                f"sort input of {len(batches)} batches exceeds "
                f"spark.rapids.sql.batchSizeBytes={self.batch_bytes}: the "
                "out-of-core sort is not ported yet "
                + not_ported(STEP_GRACE_JOIN))
        # FullSortSingleBatch mode
        table = concat_device_tables(batches, self.min_bucket)
        self.account_batch()
        yield device_sort_table(table, self.orders)

    def node_desc(self):
        return describe_orders(self.orders)
