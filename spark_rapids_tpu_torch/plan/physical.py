"""Physical plan nodes — the host engine and the common plan infrastructure;
the port of ``spark_rapids_tpu/plan/physical.py`` for the nodes this engine
plans: scan, project, filter, ungrouped aggregate and the single-partition
exchange.

The host engine (numpy) serves two purposes:

1. it runs whatever the overrides pass tags as not runnable on the device,
2. it is the differential-testing baseline (``collect(device=False)``).

Execution model: a plan node exposes ``num_partitions`` and
``execute(pidx) -> Iterator[HostTable]``. Device nodes (exec/) additionally
expose ``execute_columnar(pidx) -> Iterator[DeviceTable]``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable
from ..expr.aggregates import AggregateFunction
from ..expr.base import EvalContext, Expression
from .schema import Field, Schema

__all__ = [
    "PhysicalPlan", "CpuScanExec", "CpuProjectExec", "CpuFilterExec",
    "CpuHashAggregateExec", "ShuffleExchangeExec", "SinglePartitioning",
    "AggSpec", "host_eval_exprs", "empty_result_table",
]

class PhysicalPlan:
    children: Tuple["PhysicalPlan", ...] = ()
    schema: Schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

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


def _check_mode_and_keys(mode: str, key_names: Sequence[str]) -> None:
    if mode not in ("partial", "final"):
        raise ValueError(f"aggregate mode {mode!r}")
    if key_names:
        raise NotImplementedError(
            "keyed aggregates are not ported yet (ROADMAP Queue 1 step 4)")


class CpuHashAggregateExec(PhysicalPlan):
    """Ungrouped aggregate over pre-projected input (mode partial|final).

    Partial input: per-spec ``{prefix}_in{k}`` columns. Partial output /
    final input: per-spec state columns. Final output: state columns merged
    (the post-projection is a separate CpuProjectExec the planner inserts).
    """

    def __init__(self, child: PhysicalPlan, key_names: List[str],
                 specs: List[AggSpec], mode: str):
        _check_mode_and_keys(mode, key_names)
        self.child = child
        self.children = (child,)
        self.key_names = list(key_names)
        self.specs = specs
        self.mode = mode
        self.schema = Schema([Field(n, d, nb) for s in specs
                              for (n, d, nb) in s.state_fields])

    def execute(self, pidx: int) -> Iterator[HostTable]:
        batches = list(self.child.execute(pidx))
        cols_ops = aggregate_columns_ops(self.specs, self.mode)
        if batches:
            table = HostTable.concat(batches)
        else:
            # grand aggregate over empty input: one null/zero row
            table = HostTable(
                [c for c, _, _, _ in cols_ops],
                [HostColumn(self.child.schema.field(c).dtype,
                            _empty_values(self.child.schema.field(c).dtype))
                 for c, _, _, _ in cols_ops])
        out_cols = []
        for in_col, op, _, out_dt in cols_ops:
            vals, validity = host_reduce(op, table.column(in_col), out_dt)
            out_cols.append(HostColumn(out_dt, vals, validity))
        yield HostTable(self.schema.names, out_cols)

    def node_desc(self):
        return f"mode={self.mode} keys={self.key_names}"


def host_reduce(op: str, col: HostColumn, out_dtype: dt.DataType
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Whole-column reduction with Spark semantics -> (values[1],
    validity[1] or None): sum propagates NaN and is null over no values;
    count counts non-null values; min ignores NaN unless every value is NaN;
    max returns NaN if any value is NaN (NaN is the largest double)."""
    valid = col.valid_mask()
    vals = col.values[valid]
    has = np.array([len(vals) > 0])
    np_out = out_dtype.np_dtype()
    if op == "count":
        return np.array([len(vals)], dtype=np.int64), None
    if op == "sum":
        acc = np.zeros(1, dtype=np_out)
        with np.errstate(over="ignore", invalid="ignore"):
            # row-order accumulation, as the JAX package's host engine does
            np.add.at(acc, np.zeros(len(vals), dtype=np.int64),
                      vals.astype(np_out))
        return acc, None if has[0] else has
    if op not in ("min", "max"):
        raise ValueError(op)
    if vals.dtype == object:
        raise NotImplementedError("string min/max is not ported yet")
    if not has[0]:
        return np.zeros(1, dtype=np_out), has
    red = np.min if op == "min" else np.max
    if vals.dtype.kind == "f":
        nan = np.isnan(vals)
        if op == "max" and nan.any() or op == "min" and nan.all():
            return np.full(1, np.nan, dtype=np_out), None
        vals = vals[~nan]
    return np.asarray([red(vals)], dtype=np_out), None


# ---------------------------------------------------------------------------
# Exchange
# ---------------------------------------------------------------------------
class SinglePartitioning:
    """Every row to one output partition (the ungrouped aggregate's
    exchange; hash and range partitioning are not ported yet)."""
    num_parts = 1


class ShuffleExchangeExec(PhysicalPlan):
    """Host-side exchange into a single partition."""

    def __init__(self, child: PhysicalPlan, partitioning: SinglePartitioning):
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.schema = child.schema

    @property
    def num_partitions(self) -> int:
        return 1

    def execute(self, pidx: int) -> Iterator[HostTable]:
        for p in range(self.child.num_partitions):
            yield from self.child.execute(p)

    def node_desc(self):
        return f"{type(self.partitioning).__name__}({self.num_partitions})"
