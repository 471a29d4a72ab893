"""Basic device operators: Project, Filter, Sample, Expand, Range, Union
and the local limit — the port of those nodes of
``spark_rapids_tpu/exec/basic.py`` (reference:
basicPhysicalOperators.scala:115,313; GpuExpandExec.scala; limit.scala).

Project, Filter and Expand are pure per-batch functions — Filter only ANDs
the selection mask (no gather), so a filter+project chain fuses into one
whole-stage node with no intermediate compaction.

Each batch goes through the retry ladder's dispatch chokepoint
(``wrap_dispatch``). Project and Filter are row-wise, so they split a batch
that does not fit and fall back to their host-engine twins on a terminal
failure; Expand (its projections interleave) and Sample (it hashes absolute
row positions) only spill and retry.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               concat_device_tables, torch_dtype)
from ..expr.base import EvalContext, Expression
from ..expr.hashing import SampleMask
from ..plan.physical import (PhysicalPlan, host_eval_exprs,
                             range_partition_bounds)
from ..plan.schema import Field, Schema
from .base import TpuExec, any_runs_kernel

__all__ = ["TpuProjectExec", "TpuFilterExec", "TpuLocalLimitExec",
           "TpuSampleExec", "TpuExpandExec", "TpuRangeExec", "TpuUnionExec",
           "eval_exprs_device"]


def eval_exprs_device(table: DeviceTable, exprs: Sequence[Expression],
                      names: Sequence[str], partition_id: int = 0,
                      batch_row_offset=0) -> DeviceTable:
    ctx = EvalContext.for_device(table, partition_id, batch_row_offset)
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
    """A device operator that applies its ``batch_fn`` to every batch,
    under the retry ladder: a ``ROW_WISE`` operator (f(a ++ b) == f(a) ++
    f(b)) splits and falls back to its host twin, any other spills and
    retries only."""

    #: the retry ladder's scope name
    SCOPE = "batch"
    ROW_WISE = True

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from ..memory.retry import (split_device_rows, with_retry,
                                    with_retry_split, wrap_dispatch)
        from .fallback import with_host_fallback
        fn = wrap_dispatch(self.batch_fn(), context=self.node_desc())
        if self.ROW_WISE:
            run = with_host_fallback(
                self,
                lambda b: with_retry_split(fn, b, splitter=split_device_rows,
                                           scope=self.SCOPE,
                                           context=self.node_desc()),
                self.host_batch_fn())
        else:
            def run(b):
                return with_retry(fn, b, scope=self.SCOPE,
                                  context=self.node_desc())
        for batch in self.child_device_batches(pidx):
            out = run(batch)
            self.account_batch()
            yield out


class TpuProjectExec(_PerBatchExec):
    SCOPE = "project"

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

    @property
    def fusible(self) -> bool:
        # a context-dependent expression (the partition id, the increasing
        # id) reads its partition and row offset, which a fused stage does
        # not carry
        return not any(e.tree_context_dependent() for e in self.exprs)

    def host_batch_fn(self):
        # the host engine's projection of one downloaded batch; a
        # context-dependent projection has no batch-alone twin
        if not self.fusible:
            return None
        exprs, names = self.exprs, self.names
        return lambda table: host_eval_exprs(table, exprs, names)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        if self.fusible:
            yield from super().execute_columnar(pidx)
            return
        from ..memory.retry import with_retry, wrap_dispatch
        exprs, names = self.exprs, self.names

        def project(batch: DeviceTable, offset) -> DeviceTable:
            return eval_exprs_device(batch, exprs, names, pidx, offset)
        fn = wrap_dispatch(project, context=self.node_desc())
        offset = None
        for batch in self.child_device_batches(pidx):
            # compacted, so a row's position is the offset plus its index
            batch = batch.compact()
            if offset is None:
                offset = torch.zeros((), dtype=torch.int64,
                                     device=batch.device)
            out = with_retry(fn, batch, offset, scope="project",
                             context=self.node_desc())
            offset = offset + batch.num_rows.to(torch.int64)
            self.account_batch()
            yield out

    def runs_kernel(self) -> bool:
        return any_runs_kernel(self.exprs)

    def plan_signature(self) -> str:
        return (f"Project|{[repr(e) for e in self.exprs]}|{self.names}|"
                f"{self.children[0].schema!r}")

    def node_desc(self):
        return ", ".join(self.names)


class TpuFilterExec(_PerBatchExec):
    SCOPE = "filter"

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

    def host_batch_fn(self):
        # the host engine's filter of one downloaded batch
        cond = self.condition

        def fn(table):
            c = cond.eval(EvalContext.for_host(table))
            keep = np.asarray(c.values, dtype=np.bool_)
            if c.validity is not None:
                keep = keep & c.validity
            return table.take(np.nonzero(keep)[0])
        return fn

    def runs_kernel(self) -> bool:
        return any_runs_kernel([self.condition])

    def plan_signature(self) -> str:
        return f"Filter|{self.condition!r}|{self.children[0].schema!r}"

    def node_desc(self):
        return repr(self.condition)


class TpuLocalLimitExec(TpuExec):
    """Per-partition limit: each batch compacts and exposes its first rows
    up to what is left of ``n``; one host read of the rows kept a batch
    decides when to stop."""

    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.n = n
        self.schema = child.schema

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        remaining = self.n
        for batch in self.child_device_batches(pidx):
            if remaining <= 0:
                return
            t = batch.compact()
            kept = torch.clamp(t.num_rows, max=remaining)
            mask = torch.arange(t.capacity, dtype=torch.int32,
                                device=t.device) < kept
            emitted = int(kept)
            remaining -= emitted
            self.account_batch(emitted)
            yield DeviceTable(t.columns, mask, kept, t.names)


class TpuSampleExec(TpuExec):
    """Device Bernoulli sample (reference: GpuPartitionwiseSampledRDD and
    GpuPoissonSampler). Each batch is compacted, so a row's position is its
    batch's offset plus its index; the offset is a device tensor that
    accumulates the batches' row counts, so sampling never waits on the
    device between batches. The decisions equal the host engine's row for
    row."""

    def __init__(self, child: PhysicalPlan, fraction: float, seed: int):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.fraction = fraction
        self.seed = seed
        self.mask_expr = SampleMask(fraction, seed)
        self.schema = child.schema

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from ..memory.retry import with_retry, wrap_dispatch
        mask_expr = self.mask_expr

        def sample(batch: DeviceTable, offset) -> DeviceTable:
            ctx = EvalContext.for_device(batch, pidx, offset)
            return batch.filter_mask(mask_expr.eval(ctx).values)
        fn = wrap_dispatch(sample, context=self.node_desc())
        offset = None
        for batch in self.child_device_batches(pidx):
            batch = batch.compact()
            if offset is None:
                offset = torch.zeros((), dtype=torch.int64,
                                     device=batch.device)
            # spill-only: the mask hashes absolute row positions, which
            # halves would renumber
            out = with_retry(fn, batch, offset, scope="sample",
                             context=self.node_desc())
            offset = offset + batch.num_rows.to(torch.int64)
            self.account_batch()
            yield out

    def node_desc(self):
        return f"fraction={self.fraction} seed={self.seed}"


class TpuExpandExec(_PerBatchExec):
    """Device Expand: the P projections of a batch stack into one batch of
    the bucket of P times its capacity (reference: GpuExpandExec.scala emits
    a batch a projection; the JAX package stacks them, and the port keeps
    its batch shapes)."""

    # spill-only: the P projections interleave, so halves would reorder
    # rows across the projection boundary
    SCOPE = "expand"
    ROW_WISE = False

    def __init__(self, child: PhysicalPlan, projections, names, schema):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.projections = projections
        self.names = list(names)
        self.schema = schema

    def batch_fn(self) -> Callable[[DeviceTable], DeviceTable]:
        projections, names = self.projections, self.names

        def fn(table: DeviceTable) -> DeviceTable:
            parts = [eval_exprs_device(table, proj, names)
                     for proj in projections]
            return concat_device_tables(parts)
        return fn

    def runs_kernel(self) -> bool:
        return any(any_runs_kernel(p) for p in self.projections)

    def node_desc(self):
        return f"{len(self.projections)} projections"


class TpuRangeExec(TpuExec):
    """``range`` made on the device, in batches of at most
    ``MAX_BATCH_ROWS`` rows."""

    MAX_BATCH_ROWS = 1 << 22

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 min_bucket: int, device: torch.device):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self._parts = num_partitions
        self.min_bucket = min_bucket
        self.device = device
        self.children = ()
        self.schema = Schema([Field("id", dt.LONG, False)])

    @property
    def num_partitions(self) -> int:
        return self._parts

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        pos, hi = range_partition_bounds(self.start, self.end, self.step,
                                         self._parts, pidx)
        while pos < hi:
            n = min(self.MAX_BATCH_ROWS, hi - pos)
            cap = bucket_rows(max(n, 1), self.min_bucket)
            iota = torch.arange(cap, dtype=torch.int64, device=self.device)
            values = self.start + self.step * (iota + pos)
            mask = iota < n
            col = DeviceColumn(values, mask, dt.LONG, True)
            self.account_batch(n)
            yield DeviceTable((col,), mask,
                              torch.tensor(n, dtype=torch.int32,
                                           device=self.device), ("id",))
            pos += n


class TpuUnionExec(TpuExec):
    """UNION ALL on the device: the children's partitions one after
    another, each batch renamed to the union's columns."""

    def __init__(self, children: Sequence[PhysicalPlan]):
        super().__init__()
        self.children = tuple(children)
        self.schema = children[0].schema

    @property
    def num_partitions(self) -> int:
        return sum(c.num_partitions for c in self.children)

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        for c in self.children:
            if pidx < c.num_partitions:
                for b in c.execute_columnar(pidx):
                    self.account_batch()
                    yield DeviceTable(b.columns, b.row_mask, b.num_rows,
                                      tuple(self.schema.names))
                return
            pidx -= c.num_partitions
        raise IndexError(pidx)
