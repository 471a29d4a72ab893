"""Physical plan nodes — the host engine and the common plan infrastructure;
the port of ``spark_rapids_tpu/plan/physical.py`` for the nodes this engine
plans: scan, project, filter, sample, range, union, expand, sort, limits,
top-n, hash aggregate and the exchange with single, hash and range
partitioning (the joins are in ``plan/physical_joins.py``, the window in
``plan/physical_window.py``, the cache in ``exec/cache.py``).

The host engine (numpy) serves two purposes:

1. it runs whatever the overrides pass tags as not runnable on the device,
2. it is the differential-testing baseline (``collect(device=False)``).

Execution model: a plan node exposes ``num_partitions`` and
``execute(pidx) -> Iterator[HostTable]``. Device nodes (exec/) additionally
expose ``execute_columnar(pidx) -> Iterator[DeviceTable]``.
"""
from __future__ import annotations

import math
import threading
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable
from ..expr.aggregates import AggregateFunction
from ..expr.base import EvalContext, Expression
from ..expr.functions import SortOrder
from .host_groupby import group_codes, host_group_reduce
from .schema import Field, Schema

__all__ = [
    "PhysicalPlan", "CpuScanExec", "CpuProjectExec", "CpuFilterExec",
    "CpuSampleExec", "CpuRangeExec", "CpuUnionExec", "CpuExpandExec",
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
#: in ``SortOrder``s, in (name, expression) pairs) — what the session's
#: subquery pass walks
PLAN_EXPR_ATTRS = ("exprs", "condition", "projections", "orders",
                   "window_cols")

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
    if isinstance(d, (dt.StringType, dt.BinaryType, dt.ArrayType)) \
            or dt.is_d128(d):
        return np.empty(0, dtype=object)
    return np.empty(0, dtype=d.np_dtype())


def empty_result_table(schema: Schema) -> HostTable:
    """Typed zero-row result."""
    return HostTable(schema.names, [HostColumn(f.dtype, _empty_values(f.dtype))
                                    for f in schema])


def host_eval_exprs(table: HostTable, exprs: Sequence[Expression],
                    names: Sequence[str], partition_id: int = 0,
                    batch_row_offset: int = 0) -> HostTable:
    ctx = EvalContext.for_host(table, partition_id, batch_row_offset)
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
        offset = 0
        for batch in self.child.execute(pidx):
            yield host_eval_exprs(batch, self.exprs, self.names, pidx, offset)
            offset += batch.num_rows

    def node_desc(self):
        return ", ".join(self.names)


class CpuFilterExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, condition: Expression):
        self.child = child
        self.children = (child,)
        self.condition = condition
        self.schema = child.schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        offset = 0
        for batch in self.child.execute(pidx):
            ctx = EvalContext.for_host(batch, pidx, offset)
            offset += batch.num_rows
            c = self.condition.eval(ctx)
            keep = np.asarray(c.values, dtype=np.bool_)
            if c.validity is not None:
                keep = keep & c.validity
            yield batch.take(np.nonzero(keep)[0])

    def node_desc(self):
        return repr(self.condition)


class CpuSampleExec(CpuFilterExec):
    """Deterministic Bernoulli sample (reference: SampleExec and
    GpuPoissonSampler): a filter on a seeded hash of the row's partition and
    position, so the device and the host keep the same rows."""

    def __init__(self, child: PhysicalPlan, fraction: float, seed: int):
        from ..expr.hashing import SampleMask
        super().__init__(child, SampleMask(fraction, seed))
        self.fraction = fraction
        self.seed = seed

    def node_desc(self):
        return f"fraction={self.fraction} seed={self.seed}"


def range_partition_bounds(start: int, end: int, step: int, parts: int,
                           pidx: int) -> Tuple[int, int]:
    """The positions ``[lo, hi)`` of ``range(start, end, step)`` that
    partition ``pidx`` of ``parts`` holds."""
    total = max(0, math.ceil((end - start) / step))
    per = math.ceil(total / parts) if total else 0
    return min(total, pidx * per), min(total, (pidx + 1) * per)


class CpuRangeExec(PhysicalPlan):
    def __init__(self, start: int, end: int, step: int,
                 num_partitions: int = 1):
        self.start, self.end, self.step = start, end, step
        self._parts = num_partitions
        self.children = ()
        self.schema = Schema([Field("id", dt.LONG, False)])

    @property
    def num_partitions(self) -> int:
        return self._parts

    def execute(self, pidx: int) -> Iterator[HostTable]:
        lo, hi = range_partition_bounds(self.start, self.end, self.step,
                                        self._parts, pidx)
        vals = self.start + self.step * np.arange(lo, hi, dtype=np.int64)
        yield HostTable(["id"], [HostColumn(dt.LONG, vals)])


class CpuUnionExec(PhysicalPlan):
    """UNION ALL: the children's partitions one after another."""

    def __init__(self, children: Sequence[PhysicalPlan]):
        self.children = tuple(children)
        self.schema = children[0].schema

    @property
    def num_partitions(self) -> int:
        return sum(c.num_partitions for c in self.children)

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for c in self.children:
            if pidx < c.num_partitions:
                for b in c.execute(pidx):
                    # the union's column names over the child's columns
                    yield HostTable(self.schema.names, b.columns)
                return
            pidx -= c.num_partitions
        raise IndexError(pidx)


class CpuExpandExec(PhysicalPlan):
    """Each input row -> one output row a projection (the grouping sets'
    substrate; reference: GpuExpandExec.scala)."""

    def __init__(self, child: PhysicalPlan, projections, names, schema):
        self.child = child
        self.children = (child,)
        self.projections = projections
        self.names = list(names)
        self.schema = schema

    def execute(self, pidx: int) -> Iterator[HostTable]:
        offset = 0
        for batch in self.child.execute(pidx):
            for proj in self.projections:
                yield host_eval_exprs(batch, proj, self.names, pidx, offset)
            offset += batch.num_rows

    def node_desc(self):
        return f"{len(self.projections)} projections"


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
            # dense codes in value order (strings, or a wide decimal's ints)
            fill = 0 if isinstance(c.dtype, dt.DecimalType) else ""
            codes = _dense_object_codes(
                np.where(valid, vals, fill),
                isinstance(c.dtype, dt.StringType))
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


def _dense_object_codes(vals: np.ndarray, strings: bool) -> np.ndarray:
    """Codes 0..k-1 of an object array without None in its values' order
    (Python's comparison, for strings their UTF-8 bytes' order): the
    distinct values of ``_object_factorize``, ranked."""
    codes, uniq = _object_factorize(vals, strings)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(np.array(uniq, dtype=object), kind="stable")] = \
        np.arange(len(uniq), dtype=np.int64)
    return rank[codes]


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
        # an op may name sibling state columns ("{0}": the first state
        # column's name), which a merge of moments reads
        names = [n for (n, _, _) in self.state_fields]
        self.update_ops = [op.format(*names) for op in fn.update_ops()]
        self.merge_ops = [op.format(*names) for op in fn.merge_ops()]


def op_refs(op: str) -> List[str]:
    """The sibling state columns an aggregate op reads besides its own
    input: a moment merge's ``moment_*_merge:<n>[:<mean>]`` names them
    (``tdigest:<accuracy>`` carries a parameter, not a column)."""
    return op.split(":")[1:] if op.startswith("moment") else []


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


def host_aggregate(table: Optional[HostTable], key_names: List[str],
                   specs: List[AggSpec], mode: str, child_schema: Schema,
                   schema: Schema) -> HostTable:
    """One host table (None: no input) aggregated: the body of
    CpuHashAggregateExec, and the host fallback of the device partial
    aggregate. A keyed aggregate of no rows is empty; a grand aggregate of
    no rows is one null/zero row."""
    cols_ops = aggregate_columns_ops(specs, mode)
    if table is None or table.num_rows == 0:
        if key_names:
            return empty_result_table(schema)
        table = HostTable(
            [c for c, _, _, _ in cols_ops],
            [HostColumn(child_schema.field(c).dtype,
                        _empty_values(child_schema.field(c).dtype))
             for c, _, _, _ in cols_ops])
    gid, ngroups, rep = group_codes(table, key_names)
    out_cols = [table.column(k).take(rep) for k in key_names]
    for in_col, op, _, out_dt in cols_ops:
        refs = [table.column(r).values for r in op_refs(op)]
        vals, validity = host_group_reduce(op, table.column(in_col), gid,
                                           ngroups, out_dt, mode == "final",
                                           refs)
        if vals.dtype != object and vals.dtype != out_dt.np_dtype():
            with np.errstate(invalid="ignore"):
                vals = vals.astype(out_dt.np_dtype())
        if validity is not None and validity.all():
            validity = None
        out_cols.append(HostColumn(out_dt, vals, validity))
    return HostTable(schema.names, out_cols)


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
        yield host_aggregate(table, self.key_names, self.specs, self.mode,
                             self.child.schema, self.schema)

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
            # each distinct value hashed once (a key column repeats few);
            # a null's hash is 0 below, whatever stands in its place
            strings = isinstance(col.dtype, dt.StringType)
            codes, uniq = _object_factorize(
                np.where(col.valid_mask(), col.values, "") if strings
                else col.values, strings)
            k = np.asarray([_murmur_bytes(str(v).encode()) for v in uniq],
                           dtype=np.uint32)[codes]
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


def _object_factorize(values: np.ndarray, strings: bool):
    """-> (codes, distinct values) of an object array: ``values[i] ==
    uniq[codes[i]]``. ``strings`` (a StringType column, no None in it):
    through Arrow's dictionary encoding; else compared as Python
    objects."""
    if strings:
        enc = pa.array(values, type=pa.string()).dictionary_encode()
        return enc.indices.to_numpy(), enc.dictionary.to_pylist()
    index: dict = {}
    codes = np.fromiter((index.setdefault(v, len(index)) for v in values),
                        dtype=np.int64, count=len(values))
    return codes, list(index)


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
        # the pipelined collect's drains race to materialize; one wins
        self._mat_lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_parts

    def materialize(self) -> List[List[HostTable]]:
        """Run the map side once -> each output partition's batches."""
        with self._mat_lock:
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
