"""Physical plan nodes — the host engine and the common plan infrastructure;
the port of ``spark_rapids_tpu/plan/physical.py`` for the nodes this engine
plans: scan, project, filter, sort, limits, top-n, hash aggregate and the
exchange with single, hash and range partitioning (the joins are in
``plan/physical_joins.py``).

The host engine (numpy) serves two purposes:

1. it runs whatever the overrides pass tags as not runnable on the device,
2. it is the differential-testing baseline (``collect(device=False)``).

Execution model: a plan node exposes ``num_partitions`` and
``execute(pidx) -> Iterator[HostTable]``. Device nodes (exec/) additionally
expose ``execute_columnar(pidx) -> Iterator[DeviceTable]``.
"""
from __future__ import annotations

import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable
from ..expr.aggregates import AggregateFunction
from ..expr.base import EvalContext, Expression
from ..expr.functions import SortOrder
from .host_groupby import group_codes, host_group_reduce
from .schema import Field, Schema

__all__ = [
    "PhysicalPlan", "CpuScanExec", "CpuProjectExec", "CpuFilterExec",
    "CpuSortExec", "CpuHashAggregateExec", "ShuffleExchangeExec",
    "CpuLocalLimitExec", "CpuGlobalLimitExec", "CpuCollectLimitExec",
    "CpuTakeOrderedExec",
    "Partitioning", "SinglePartitioning", "HashPartitioning",
    "RangePartitioning", "AggSpec", "host_eval_exprs", "empty_result_table",
    "murmur_hash_columns", "PLAN_EXPR_ATTRS",
]

#: the row goal of the coalesce after an upload (plan/transitions.py)
DEFAULT_BATCH_ROWS = 1 << 20

#: every attribute a physical node may hold expressions in (bare, in lists,
#: in ``SortOrder``s) — what the session's subquery pass walks
PLAN_EXPR_ATTRS = ("exprs", "condition", "orders")

class PhysicalPlan:
    children: Tuple["PhysicalPlan", ...] = ()
    schema: Schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def _own_spill_handle(self, handle) -> None:
        """Track a spill-catalog handle this node registered for its output
        (a broadcast build, its grace parts). ``release_spill_handles``
        closes it when the query's collect ends; a finalizer closes it when
        the node is collected, for a plan never released. A finalizer runs
        at most once, so the two cannot close a handle twice."""
        self.__dict__.setdefault("_spill_finalizers", []).append(
            weakref.finalize(self, handle.close))

    def release_spill_handles(self) -> int:
        """Close every spill handle that this finished plan tree owns,
        walking ``children`` and the edges AQE's nodes keep outside them
        (``inner``, ``stage``, ``_final``, ``child``). Safe to call more
        than once. -> the number of handles closed."""
        closed = 0
        seen = set()
        stack: List[PhysicalPlan] = [self]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            for fin in node.__dict__.get("_spill_finalizers", ()):
                if fin.alive:
                    fin()
                    closed += 1
            stack.extend(getattr(node, "children", ()))
            for attr in ("inner", "stage", "_final", "child"):
                v = getattr(node, attr, None)
                if isinstance(v, PhysicalPlan):
                    stack.append(v)
        return closed

    def execute(self, pidx: int) -> Iterator[HostTable]:
        raise NotImplementedError(type(self).__name__)

    def node_name(self) -> str:
        return type(self).__name__

    def node_desc(self) -> str:
        return ""

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        desc = self.node_desc()
        line = f"{pad}{self.node_name()}" + (f" [{desc}]" if desc else "")
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children])

    def collect(self) -> HostTable:
        batches: List[HostTable] = []
        for p in range(self.num_partitions):
            batches.extend(self.execute(p))
        if not batches:
            return empty_result_table(self.schema)
        return HostTable.concat(batches)


def _empty_values(d: dt.DataType) -> np.ndarray:
    if isinstance(d, (dt.StringType, dt.BinaryType)):
        return np.empty(0, dtype=object)
    return np.empty(0, dtype=d.np_dtype())


def empty_result_table(schema: Schema) -> HostTable:
    """Typed zero-row result."""
    return HostTable(schema.names, [HostColumn(f.dtype, _empty_values(f.dtype))
                                    for f in schema])


def host_eval_exprs(table: HostTable, exprs: Sequence[Expression],
                    names: Sequence[str]) -> HostTable:
    ctx = EvalContext.for_host(table)
    cols = []
    for e in exprs:
        c = e.eval(ctx)
        values = np.asarray(c.values)
        if isinstance(c.dtype, dt.BooleanType) and values.dtype != np.bool_:
            values = values.astype(np.bool_)
        elif values.dtype != object and values.dtype != c.dtype.np_dtype():
            values = values.astype(c.dtype.np_dtype())
        cols.append(HostColumn(c.dtype, values, c.validity))
    return HostTable(list(names), cols)


# ---------------------------------------------------------------------------
# Leaf / basic operators
# ---------------------------------------------------------------------------
class CpuScanExec(PhysicalPlan):
    def __init__(self, source, columns: Optional[List[str]] = None):
        self.source = source
        self.columns = columns
        self.children = ()
        full = source.schema()
        self.schema = full.select(columns) if columns else full

    @property
    def num_partitions(self) -> int:
        return self.source.partitions()

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from self.source.read_partition(pidx, self.columns)

    def node_desc(self):
        return f"{self.source.name()} cols={self.columns or '*'}"


class CpuProjectExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, exprs: Sequence[Expression],
                 names: Sequence[str]):
        self.child = child
        self.children = (child,)
        self.exprs = list(exprs)
        self.names = list(names)
        self.schema = Schema([Field(n, e.data_type, e.nullable)
                              for n, e in zip(names, exprs)])

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for batch in self.child.execute(pidx):
            yield host_eval_exprs(batch, self.exprs, self.names)

    def node_desc(self):
        return ", ".join(self.names)


class CpuFilterExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        self.child = child
        self.children = (child,)
        self.condition = condition
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for batch in self.child.execute(pidx):
            c = self.condition.eval(EvalContext.for_host(batch))
            keep = np.asarray(c.values, dtype=np.bool_)
            if c.validity is not None:
                keep = keep & c.validity
            yield batch.take(np.nonzero(keep)[0])

    def node_desc(self):
        return repr(self.condition)


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------
def _sort_indices(table: HostTable, orders: Sequence[SortOrder]) -> np.ndarray:
    """Stable multi-key sort with Spark null ordering. Each order gives an
    int64 value key in the order's direction and, above it, a null flag
    key, so no value can collide with a null sentinel."""
    keys = []
    ctx = EvalContext.for_host(table)
    for o in reversed(list(orders)):  # lexsort: last key is primary
        c = o.expr.eval(ctx)
        vals = np.asarray(c.values)
        valid = c.validity if c.validity is not None \
            else np.ones(len(vals), dtype=bool)
        if vals.dtype == object:
            # dense codes in value order
            codes = np.unique(np.where(valid, vals, ""),
                              return_inverse=True)[1].reshape(-1) \
                .astype(np.int64)
        elif vals.dtype.kind == "f":
            # DENSE codes: equal values MUST share a code, or a tied float
            # key never defers to the later sort keys. NaN sorts last, just
            # above +inf (Spark); -0.0 == 0.0.
            v = vals.copy()
            v[v == 0] = 0.0
            nan = np.isnan(v)
            _, inv = np.unique(np.where(nan, np.inf, v),
                               return_inverse=True)
            codes = inv.reshape(-1).astype(np.int64) * 2 + nan
        else:
            codes = vals.astype(np.int64)   # false < true
        if not o.ascending:
            codes = ~codes   # -codes - 1: no overflow at the int64 minimum
        keys.append(np.where(valid, codes, 0))
        keys.append(valid if o.nulls_first else ~valid)
    return np.lexsort(keys) if keys else np.arange(table.num_rows)


def describe_orders(orders: Sequence[SortOrder]) -> str:
    return ", ".join(f"{o.expr!r} {'ASC' if o.ascending else 'DESC'}"
                     for o in orders)


class CpuSortExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder]):
        self.child = child
        self.children = (child,)
        self.orders = list(orders)
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        batches = list(self.child.execute(pidx))
        if not batches:
            return
        table = HostTable.concat(batches)
        yield table.take(_sort_indices(table, self.orders))

    def node_desc(self):
        return describe_orders(self.orders)


# ---------------------------------------------------------------------------
# Limits and top-n
# ---------------------------------------------------------------------------
class CpuLocalLimitExec(PhysicalPlan):
    """The first ``n`` rows of each partition."""

    def __init__(self, child: PhysicalPlan, n: int):
        self.child = child
        self.children = (child,)
        self.n = n
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        remaining = self.n
        for batch in self.child.execute(pidx):
            if remaining <= 0:
                return
            if batch.num_rows > remaining:
                yield batch.slice(0, remaining)
                return
            remaining -= batch.num_rows
            yield batch


class CpuGlobalLimitExec(PhysicalPlan):
    """The first ``n`` rows of a single-partition child."""

    def __init__(self, child: PhysicalPlan, n: int):
        self.child = child
        self.children = (child,)
        self.n = n
        self.schema = child.schema

    @property
    def num_partitions(self) -> int:
        return 1

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from CpuLocalLimitExec(self.child, self.n).execute(0)


class CpuCollectLimitExec(CpuGlobalLimitExec):
    """Limit-for-collect: a local limit per partition feeds a
    single-partition exchange feeding this (reference: CollectLimitExec,
    limit.scala)."""


class CpuTakeOrderedExec(PhysicalPlan):
    """Top-n: sort the partition's batches and keep the first n rows
    (reference: GpuTakeOrderedAndProjectExec in limit.scala; the planner
    stacks two of these around a single-partition exchange)."""

    def __init__(self, child: PhysicalPlan, orders, n: int):
        self.child = child
        self.children = (child,)
        self.orders = list(orders)
        self.n = n
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        batches = list(self.child.execute(pidx))
        if not batches:
            return
        t = HostTable.concat(batches)
        yield t.take(_sort_indices(t, self.orders)[:self.n])

    def node_desc(self):
        return f"n={self.n} orders={len(self.orders)}"


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------
class AggSpec:
    """Physical aggregate: prefix + function, aligned input/state col names."""

    def __init__(self, prefix: str, fn: AggregateFunction):
        self.prefix = prefix
        self.fn = fn
        self.input_cols = [f"{prefix}_in{k}"
                           for k in range(len(fn.update_ops()))]
        self.state_fields = fn.state_fields(prefix)
        self.update_ops = fn.update_ops()
        self.merge_ops = fn.merge_ops()


def aggregate_columns_ops(specs: Sequence[AggSpec], mode: str
                          ) -> List[Tuple[str, str, str, dt.DataType]]:
    """(input_col, op, out_col, out_dtype) per state column of an
    aggregate in ``mode`` (partial reads inputs, final reads states)."""
    out = []
    for s in specs:
        ops = s.update_ops if mode == "partial" else s.merge_ops
        in_cols = s.input_cols if mode == "partial" \
            else [n for (n, _, _) in s.state_fields]
        for in_col, op, (out_col, out_dt, _) in zip(in_cols, ops,
                                                     s.state_fields):
            out.append((in_col, op, out_col, out_dt))
    return out


def aggregate_schema(child: PhysicalPlan, key_names: Sequence[str],
                     specs: Sequence[AggSpec]) -> Schema:
    """Key columns, then every spec's state columns."""
    return Schema([child.schema.field(k) for k in key_names]
                  + [Field(n, d, nb) for s in specs
                     for (n, d, nb) in s.state_fields])


def check_mode(mode: str) -> None:
    if mode not in ("partial", "final"):
        raise ValueError(f"aggregate mode {mode!r}")


class CpuHashAggregateExec(PhysicalPlan):
    """Group-by aggregate over pre-projected input (mode partial|final).

    Partial input: key cols + per-spec ``{prefix}_in{k}`` columns.
    Partial output / final input: key cols + per-spec state columns.
    Final output: key cols + state columns merged (the post-projection is a
    separate CpuProjectExec the planner inserts).
    """

    def __init__(self, child: PhysicalPlan, key_names: List[str],
                 specs: List[AggSpec], mode: str):
        check_mode(mode)
        self.child = child
        self.children = (child,)
        self.key_names = list(key_names)
        self.specs = specs
        self.mode = mode
        self.schema = aggregate_schema(child, key_names, specs)

    def execute(self, pidx: int) -> Iterator[HostTable]:
        batches = list(self.child.execute(pidx))
        table = HostTable.concat(batches) if batches else None
        cols_ops = aggregate_columns_ops(self.specs, self.mode)
        if table is None or table.num_rows == 0:
            if self.key_names:
                yield empty_result_table(self.schema)
                return
            # grand aggregate over empty input: one null/zero row
            table = HostTable(
                [c for c, _, _, _ in cols_ops],
                [HostColumn(self.child.schema.field(c).dtype,
                            _empty_values(self.child.schema.field(c).dtype))
                 for c, _, _, _ in cols_ops])
        gid, ngroups, rep = group_codes(table, self.key_names)
        out_cols = [table.column(k).take(rep) for k in self.key_names]
        for in_col, op, _, out_dt in cols_ops:
            vals, validity = host_group_reduce(op, table.column(in_col), gid,
                                               ngroups, out_dt)
            if vals.dtype != object and vals.dtype != out_dt.np_dtype():
                with np.errstate(invalid="ignore"):
                    vals = vals.astype(out_dt.np_dtype())
            if validity is not None and validity.all():
                validity = None
            out_cols.append(HostColumn(out_dt, vals, validity))
        yield HostTable(self.schema.names, out_cols)

    def node_desc(self):
        return f"mode={self.mode} keys={self.key_names}"


# ---------------------------------------------------------------------------
# Exchange / partitioning
# ---------------------------------------------------------------------------
def murmur_hash_columns(table: HostTable, key_names: Sequence[str],
                        seed: int = 42) -> np.ndarray:
    """32-bit Murmur3-style hash of key columns (reference:
    HashFunctions.scala / GpuHashPartitioningBase)."""
    h = np.full(table.num_rows, seed, dtype=np.uint32)
    for name in key_names:
        col = table.column(name)
        if col.values.dtype == object:
            k = np.asarray([_murmur_bytes(str(v).encode())
                            for v in col.values], dtype=np.uint32)
        else:
            k = _murmur_fmix(col.values)
        k = np.where(col.valid_mask(), k, np.uint32(0))
        h = _murmur_combine(h, k)
    return h


def _murmur_fmix(vals: np.ndarray) -> np.ndarray:
    if vals.dtype == np.bool_:
        x = vals.astype(np.uint32)
    elif vals.dtype.kind == "f":
        # Spark's key equality holds -0.0 == 0.0 and NaN == NaN, so they
        # hash alike (the JAX host engine hashes the raw bits)
        v = vals.astype(np.float64)
        v = np.where(np.isnan(v), np.nan, np.where(v == 0, 0.0, v))
        x = v.view(np.uint64)
        x = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            ^ (x >> np.uint64(32)).astype(np.uint32)
    else:
        x64 = vals.astype(np.int64).view(np.uint64)
        x = (x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            ^ (x64 >> np.uint64(32)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


def _murmur_bytes(b: bytes) -> int:
    h = 0
    for byte in b:
        h = (h * 31 + byte) & 0xFFFFFFFF
    return h


def _murmur_combine(h: np.ndarray, k: np.ndarray) -> np.ndarray:
    h = h ^ k
    h = (h * np.uint32(5) + np.uint32(0xE6546B64)) & np.uint32(0xFFFFFFFF)
    return h


class Partitioning:
    num_parts: int = 1

    def partition_indices(self, table: HostTable) -> np.ndarray:
        raise NotImplementedError


class SinglePartitioning(Partitioning):
    """Every row to one output partition (the ungrouped aggregate's)."""
    num_parts = 1

    def partition_indices(self, table: HostTable) -> np.ndarray:
        return np.zeros(table.num_rows, dtype=np.int32)


class HashPartitioning(Partitioning):
    def __init__(self, key_names: Sequence[str], num_parts: int):
        self.key_names = list(key_names)
        self.num_parts = num_parts

    def partition_indices(self, table: HostTable) -> np.ndarray:
        h = murmur_hash_columns(table, self.key_names)
        return (h % np.uint32(self.num_parts)).astype(np.int32)


class RangePartitioning(Partitioning):
    """Sampled-bounds range partitioning (reference: GpuRangePartitioner)."""

    def __init__(self, orders: Sequence[SortOrder], num_parts: int):
        self.orders = list(orders)
        self.num_parts = num_parts
        self._bounds: Optional[HostTable] = None

    def set_bounds_from_sample(self, sample: HostTable):
        idx = _sort_indices(sample, self.orders)
        n = len(idx)
        if n == 0 or self.num_parts <= 1:
            self._bounds = None
            return
        picks = [idx[int(n * (i + 1) / self.num_parts) - 1]
                 for i in range(self.num_parts - 1)]
        self._bounds = sample.take(np.asarray(picks, dtype=np.int64))

    def partition_indices(self, table: HostTable) -> np.ndarray:
        if self._bounds is None or table.num_rows == 0:
            return np.zeros(table.num_rows, dtype=np.int32)
        merged = HostTable.concat([table, self._bounds])
        order = _sort_indices(merged, self.orders)
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        bound_ranks = np.sort(rank[table.num_rows:])
        row_ranks = rank[:table.num_rows]
        return np.searchsorted(bound_ranks, row_ranks,
                               side="left").astype(np.int32)


class ShuffleExchangeExec(PhysicalPlan):
    """Materializing host exchange (the reference's default-Spark-shuffle
    mode): every map batch is split by ``partitioning`` into the output
    partitions. A range exchange first samples its whole input for the
    bounds. The map side runs partition after partition."""

    def __init__(self, child: PhysicalPlan, partitioning: Partitioning):
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.schema = child.schema
        self._materialized: Optional[List[List[HostTable]]] = None

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_parts

    def materialize(self) -> List[List[HostTable]]:
        """Run the map side once -> each output partition's batches."""
        if self._materialized is None:
            self._materialized = self._partition()
        return self._materialized

    def _partition(self) -> List[List[HostTable]]:
        inputs = [b for p in range(self.child.num_partitions)
                  for b in self.child.execute(p)]
        if isinstance(self.partitioning, RangePartitioning) \
                and self.partitioning._bounds is None and inputs:
            self.partitioning.set_bounds_from_sample(HostTable.concat(inputs))
        out: List[List[HostTable]] = [[] for _ in range(self.num_partitions)]
        for batch in inputs:
            pids = self.partitioning.partition_indices(batch)
            for p in range(self.num_partitions):
                sel = np.nonzero(pids == p)[0]
                if len(sel):
                    out[p].append(batch.take(sel))
        return out

    def execute(self, pidx: int) -> Iterator[HostTable]:
        yield from self.materialize()[pidx]

    def node_desc(self):
        return f"{type(self.partitioning).__name__}({self.num_partitions})"
