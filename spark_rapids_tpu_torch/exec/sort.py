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

``TpuSortExec`` sorts its input as one batch while the input's batches
together stay within ``spark.rapids.sql.batchSizeBytes``. A larger input
takes the out-of-core sort (reference: GpuSortExec's OutOfCoreSort,
GpuSortExec.scala:69): each batch is sorted into a run registered with the
spill catalog, and the runs merge in rounds. A round concatenates the carry
of the last round, the next chunk of each run, and each unfinished run's
next unseen row as a sentinel, sorts them, and emits every row before the
first sentinel: no row still unseen can sort before it. The rest is
carried.

Every sort runs under the retry ladder: a batch that does not fit is split,
its halves sorted and their concat sorted again; a merge round spills and
retries; a terminal failure feeds the quarantine store.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable, append_column,
                               bucket_rows, concat_device_tables, drop_column,
                               pack_string_key_words, shrink_to_fit,
                               slice_rows)
from ..conf import RapidsConf
from ..expr.base import EvalContext
from ..expr.decimal128 import d128_key_words
from ..expr.functions import SortOrder
from ..memory.catalog import SpillPriorities, SpillableDeviceTable, get_catalog
from ..memory.retry import (split_device_rows, with_retry, with_retry_split,
                            wrap_dispatch)
from ..plan.physical import PhysicalPlan, describe_orders
from .base import TpuExec, any_runs_kernel

__all__ = ["TpuSortExec", "TpuTakeOrderedExec", "device_sort_table"]

_SIGN = -2**63
#: the out-of-core merge's sentinel column (the JAX package's name)
_SENT = "__ooc_sentinel"


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
        elif c.lengths is not None or dt.is_d128(c.dtype):
            # a string's packed words or a wide decimal's key words, most
            # significant first: the sign flip turns their unsigned order
            # into torch's signed order; bit inversion then reverses it
            words = pack_string_key_words(v, c.lengths) \
                if c.lengths is not None else d128_key_words(v)
            words = [w ^ _SIGN for w in words]
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

    def runs_kernel(self) -> bool:
        return any_runs_kernel([o.expr for o in self.orders])

    def plan_signature(self) -> str:
        return (f"TakeOrdered|{self.n}|"
                f"{[(repr(o.expr), o.ascending, o.nulls_first) for o in self.orders]}|"
                f"{self.schema!r}")

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from .fallback import quarantine_on_failure
        cap = bucket_rows(max(self.n, 1), self.min_bucket)
        topn = wrap_dispatch(
            lambda t: device_top_n(t, self.orders, self.n, cap),
            context=self.node_desc())

        def topn_combine(outs):
            """Half top-n's are each sorted and cut; the top-n of their
            concat restores the order and the bound."""
            return topn(concat_device_tables(outs))

        state = None
        for batch in self.child_device_batches(pidx):
            # note-only boundary: the state spans batches
            with quarantine_on_failure(self):
                top = with_retry_split(topn, batch,
                                       splitter=split_device_rows,
                                       combiner=topn_combine, scope="topn",
                                       context=self.node_desc())
                if state is not None:
                    # spill-only: the state is bounded at n rows already
                    top = with_retry(topn, concat_device_tables([state, top]),
                                     scope="topn-merge",
                                     context=self.node_desc())
            state = top
        if state is not None:
            self.account_batch()
            yield state

    def node_desc(self):
        return f"n={self.n}"


class TpuSortExec(TpuExec):
    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder],
                 min_bucket: int, batch_bytes: int,
                 conf: Optional[RapidsConf] = None):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.orders = list(orders)
        self.schema = child.schema
        self.min_bucket = min_bucket
        self.batch_bytes = batch_bytes
        self.conf = conf

    def runs_kernel(self) -> bool:
        return any_runs_kernel([o.expr for o in self.orders])

    def plan_signature(self) -> str:
        return (f"{type(self).__name__}|{self.node_desc()}|"
                f"{self.children[0].schema!r}")

    def _sort_fn(self):
        return wrap_dispatch(lambda t: device_sort_table(t, self.orders),
                             context=self.node_desc())

    def _sort_combine(self, outs):
        """The split rung's combiner: half sorts are only ordered within
        themselves, so their concat is sorted again (by then the ladder has
        spilled what it could)."""
        return self._sort_fn()(concat_device_tables(outs, self.min_bucket))

    def _sort_retrying(self, table: DeviceTable) -> DeviceTable:
        return with_retry_split(self._sort_fn(), table,
                                splitter=split_device_rows,
                                combiner=self._sort_combine, scope="sort",
                                context=self.node_desc())

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from .fallback import quarantine_on_failure
        batches = list(self.child_device_batches(pidx))
        if not batches:
            return
        if len(batches) > 1 \
                and sum(b.nbytes() for b in batches) > self.batch_bytes:
            yield from self._out_of_core(batches)
            return
        # FullSortSingleBatch mode
        with quarantine_on_failure(self):
            table = with_retry(concat_device_tables, batches,
                               self.min_bucket, scope="sort-concat",
                               context=self.node_desc()) \
                if len(batches) > 1 \
                else concat_device_tables(batches, self.min_bucket)
            del batches
            out = self._sort_retrying(table)
        del table
        self.account_batch()
        yield out

    # -- OutOfCoreSort mode ---------------------------------------------------
    def _out_of_core(self, batches: List[DeviceTable]
                     ) -> Iterator[DeviceTable]:
        """Sort each batch into a run held by the spill catalog, then merge
        the runs (``_out_of_core``)."""
        from .fallback import quarantine_on_failure
        catalog = get_catalog(self.conf, batches[0].device)
        runs: List[Tuple[SpillableDeviceTable, int]] = []
        try:
            with quarantine_on_failure(self):
                sorted_bs = [self._sort_retrying(b) for b in batches]
            # every run's count in one host copy
            counts = torch.stack([b.num_rows for b in sorted_bs]).tolist()
            for b, n in zip(sorted_bs, counts):
                if n:
                    runs.append((catalog.register(b, SpillPriorities.INPUT),
                                 n))
            del sorted_bs  # the catalog holds the runs: it may spill them
            yield from self._merge_runs(runs)
        finally:
            for run, _ in runs:
                run.close()

    def _merge_runs(self, runs: List[Tuple[SpillableDeviceTable, int]]
                    ) -> Iterator[DeviceTable]:
        """``_merge_runs``: rounds of carry + one chunk of each run + a
        sentinel row of each unfinished run, sorted; the rows before the
        first sentinel are emitted, the rest (sentinels dropped) carried.
        One host copy a round reads the emit and carry counts."""
        if not runs:
            return
        k = len(runs)
        target_rows = max(n for _, n in runs)
        chunk = bucket_rows(max(self.min_bucket, target_rows // k),
                            self.min_bucket)
        cursors = [0] * k
        carry: Optional[DeviceTable] = None
        while carry is not None or any(c < n for c, (_, n) in
                                       zip(cursors, runs)):
            inputs: List[DeviceTable] = []
            flags: List[bool] = []
            if carry is not None:
                inputs.append(carry)
                flags.append(False)
            for i, (run, nrows) in enumerate(runs):
                if cursors[i] >= nrows:
                    continue
                with run as t:
                    inputs.append(slice_rows(t, cursors[i], chunk))
                    flags.append(False)
                    cursors[i] = min(cursors[i] + chunk, nrows)
                    if cursors[i] < nrows:  # the next unseen row
                        inputs.append(slice_rows(t, cursors[i], 1))
                        flags.append(True)
            tagged = [append_column(t, _SENT, DeviceColumn(
                torch.full((t.capacity,), f, dtype=torch.bool,
                           device=t.device),
                torch.ones(t.capacity, dtype=torch.bool, device=t.device),
                dt.BOOLEAN, True)) for t, f in zip(inputs, flags)]
            merged = concat_device_tables(tagged, self.min_bucket)
            # spill-only: the merge's inputs are chunks the out-of-core
            # policy bounds already
            sorted_m = with_retry(self._sort_fn(), merged,
                                  scope="sort-merge",
                                  context=self.node_desc())
            sent = torch.logical_and(sorted_m.column(_SENT).data,
                                     sorted_m.row_mask)
            iota = torch.arange(sorted_m.capacity, dtype=torch.int32,
                                device=sorted_m.device)
            # the first sentinel's row; every row while there is none
            emit_dev = torch.minimum(
                torch.where(sent, iota, sorted_m.capacity).amin(),
                sorted_m.num_rows)
            rest_mask = torch.logical_and(
                iota >= emit_dev,
                torch.logical_not(sorted_m.column(_SENT).data))
            rest = drop_column(sorted_m.filter_mask(rest_mask), _SENT)
            emit_n, rest_n = torch.stack([emit_dev.to(torch.int32),
                                          rest.num_rows]).tolist()
            if emit_n > 0:
                out = drop_column(sorted_m.filter_mask(iota < emit_n), _SENT)
                self.account_batch(rows=emit_n)
                yield shrink_to_fit(out, self.min_bucket, num_rows=emit_n)
            carry = shrink_to_fit(rest, self.min_bucket, num_rows=rest_n) \
                if rest_n else None

    def node_desc(self):
        return describe_orders(self.orders)
