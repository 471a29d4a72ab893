"""Logical plan nodes — the port's copy of ``spark_rapids_tpu/plan/logical.py``
for scan, filter, project, aggregate, sort, limit, join, union, window,
cache, range, sample and expand. Generate (``explode``) waits for array
columns (ROADMAP Queue 1: breadth), the pandas nodes for the UDFs.

The logical layer's only jobs are (a) the DataFrame builder API, (b)
expression resolution, and (c) feeding the physical planner
(plan/planner.py). Tagging, lowering and transitions happen at the physical
level.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from ..expr.aggregates import AggregateFunction
from ..expr.base import (Alias, AttributeReference, Expression,
                         resolve_expression)
from ..expr.functions import SortOrder
from .schema import Field, Schema

__all__ = ["LogicalPlan", "LogicalScan", "LogicalProject", "LogicalFilter",
           "LogicalAggregate", "LogicalSort", "LogicalLimit", "LogicalJoin",
           "LogicalUnion", "LogicalWindow", "LogicalCache", "LogicalRange",
           "LogicalSample", "LogicalExpand", "DataSource"]


class DataSource:
    """Abstract scan source; io/memory.py holds the in-memory one."""

    def schema(self) -> Schema:
        raise NotImplementedError

    def partitions(self) -> int:
        raise NotImplementedError

    def read_partition(self, pidx: int, columns: Optional[List[str]] = None):
        """Yield HostTable batches for one partition (column-pruned)."""
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__


class LogicalScan(LogicalPlan):
    def __init__(self, source: DataSource):
        self.source = source
        self.children = ()

    @property
    def schema(self) -> Schema:
        return self.source.schema()


class LogicalProject(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        self.child = child
        self.children = (child,)
        cs = child.schema
        self.exprs = [_named(resolve_expression(e, cs.to_dict(),
                                                cs.nullable_dict()), i)
                      for i, e in enumerate(exprs)]

    @property
    def schema(self) -> Schema:
        return Schema([Field(e.name, e.data_type, e.nullable)
                       for e in self.exprs])


class LogicalFilter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        self.child = child
        self.children = (child,)
        cs = child.schema
        self.condition = resolve_expression(condition, cs.to_dict(),
                                            cs.nullable_dict())
        if not isinstance(self.condition.data_type, dt.BooleanType):
            raise TypeError("filter condition must be boolean, got "
                            f"{self.condition.data_type!r}")

    @property
    def schema(self) -> Schema:
        return self.child.schema


class LogicalAggregate(LogicalPlan):
    """groupBy(groupings).agg(aggregates).

    ``aggregates`` entries are either AggregateFunction or
    Alias(AggregateFunction).
    """

    def __init__(self, child: LogicalPlan, groupings: Sequence[Expression],
                 aggregates: Sequence[Expression]):
        self.child = child
        self.children = (child,)
        cs = child.schema
        self.groupings = [_named(resolve_expression(g, cs.to_dict(),
                                                    cs.nullable_dict()), i,
                                 prefix="group")
                          for i, g in enumerate(groupings)]
        resolved = []
        for a in aggregates:
            r = resolve_expression(a, cs.to_dict(), cs.nullable_dict())
            fn = r.child if isinstance(r, Alias) else r
            if not isinstance(fn, AggregateFunction):
                raise TypeError(f"agg expression must be an aggregate, got {r!r}")
            name = r.name if isinstance(r, Alias) else _default_agg_name(fn)
            resolved.append((name, fn))
        self.aggregates: List[Tuple[str, AggregateFunction]] = resolved
        _check_dup([e.name for e in self.groupings] + [n for n, _ in resolved])

    @property
    def schema(self) -> Schema:
        fields = [Field(g.name, g.data_type, g.nullable) for g in self.groupings]
        fields += [Field(n, f.data_type, f.nullable) for n, f in self.aggregates]
        return Schema(fields)


class LogicalSort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: Sequence[SortOrder],
                 global_sort: bool = True):
        self.child = child
        self.children = (child,)
        cs = child.schema
        self.orders = [SortOrder(resolve_expression(o.expr, cs.to_dict(),
                                                    cs.nullable_dict()),
                                 o.ascending, o.nulls_first)
                       for o in orders]
        self.global_sort = global_sort

    @property
    def schema(self) -> Schema:
        return self.child.schema


class LogicalLimit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.child = child
        self.children = (child,)
        self.n = n

    @property
    def schema(self) -> Schema:
        return self.child.schema


class LogicalJoin(LogicalPlan):
    VALID_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
                   "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 on: Optional[Sequence[str]] = None,
                 condition: Optional[Expression] = None,
                 how: str = "inner"):
        how = how.lower().replace("outer", "").strip("_")
        aliases = {"leftsemi": "left_semi", "leftanti": "left_anti",
                   "semi": "left_semi", "anti": "left_anti"}
        how = aliases.get(how, how)
        if how not in self.VALID_TYPES:
            raise ValueError(f"bad join type {how!r}")
        if on and how not in ("left_semi", "left_anti"):
            # Spark USING-join semantics: mismatched key types coerce BOTH
            # sides to the common type and the output key column carries it
            # (semi/anti keep the left side's types and coerce with hidden
            # keys at plan time)
            left, right = _coerce_using_keys(left, right, on)
        self.left, self.right = left, right
        self.children = (left, right)
        self.how = how
        self.on = list(on) if on else None
        self.condition = None
        if condition is not None:
            # semi/anti output only the left side, but the condition still
            # sees both sides' columns: resolve it against the inner schema
            cond_how = "inner" if how in ("left_semi", "left_anti") else how
            merged = _join_schema(left.schema, right.schema, self.on,
                                  cond_how)
            self.condition = resolve_expression(
                condition, merged.to_dict(), merged.nullable_dict())

    @property
    def schema(self) -> Schema:
        return _join_schema(self.left.schema, self.right.schema, self.on,
                            self.how)


class LogicalUnion(LogicalPlan):
    """UNION ALL of children with equal column names and types."""

    def __init__(self, children: Sequence[LogicalPlan]):
        assert len(children) >= 2
        self.children = tuple(children)
        first = children[0].schema
        for c in children[1:]:
            s = c.schema
            if s.names != first.names \
                    or [f.dtype for f in s] != [f.dtype for f in first]:
                raise TypeError(f"union schema mismatch: {first!r} vs {s!r}")

    @property
    def schema(self) -> Schema:
        first = self.children[0].schema
        nullable = [any(c.schema.fields[i].nullable for c in self.children)
                    for i in range(len(first))]
        return Schema([Field(f.name, f.dtype, nb)
                       for f, nb in zip(first.fields, nullable)])


class LogicalWindow(LogicalPlan):
    """Window node: the child's columns and appended window columns
    (reference: GpuWindowExec). Every entry shares one WindowSpec
    (partition and order); the DataFrame layer stacks a node a spec."""

    def __init__(self, child: LogicalPlan, window_cols):
        from ..expr.window import WindowExpression
        self.child = child
        self.children = (child,)
        cs = child.schema
        resolved = []
        for name, w in window_cols:
            r = resolve_expression(w, cs.to_dict(), cs.nullable_dict())
            assert isinstance(r, WindowExpression), r
            resolved.append((name, r))
        self.window_cols = resolved
        _check_dup(list(cs.names) + [n for n, _ in resolved])

    @property
    def schema(self) -> Schema:
        fields = list(self.child.schema.fields)
        fields += [Field(n, w.data_type, w.nullable)
                   for n, w in self.window_cols]
        return Schema(fields)


class LogicalCache(LogicalPlan):
    """``df.cache()``: the child materialized once (on the device when
    lowered) and served from its storage afterwards."""

    def __init__(self, child: LogicalPlan):
        from ..exec.cache import CacheStorage
        self.child = child
        self.children = (child,)
        self.storage = CacheStorage()

    @property
    def schema(self) -> Schema:
        return self.child.schema


class LogicalRange(LogicalPlan):
    """``range(start, end, step)``: one LONG column ``id`` (reference:
    GpuRangeExec)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        assert step != 0
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self.children = ()

    @property
    def schema(self) -> Schema:
        return Schema([Field("id", dt.LONG, False)])


class LogicalSample(LogicalPlan):
    """``df.sample(fraction, seed)``: a deterministic Bernoulli row
    sample."""

    def __init__(self, child: LogicalPlan, fraction: float, seed: int):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction must be in [0, 1], "
                             f"got {fraction}")
        self.child = child
        self.children = (child,)
        self.fraction = float(fraction)
        self.seed = int(seed)

    @property
    def schema(self) -> Schema:
        return self.child.schema


class LogicalExpand(LogicalPlan):
    """Expand: each input row becomes one output row a projection — the
    substrate of rollup, cube and grouping sets (reference:
    GpuExpandExec.scala). ``projections`` are expression lists of one
    length; output column ``i`` is ``names[i]``, of the projections' common
    type at slot ``i``, nullable if any projection can be null there."""

    def __init__(self, child: LogicalPlan, projections, names):
        self.child = child
        self.children = (child,)
        cs = child.schema
        assert projections and all(len(p) == len(names) for p in projections)
        self.projections = [
            [resolve_expression(e, cs.to_dict(), cs.nullable_dict())
             for e in proj]
            for proj in projections]
        self.names = list(names)
        _check_dup(self.names)
        fields = []
        for i, n in enumerate(self.names):
            dts = {repr(p[i].data_type) for p in self.projections}
            if len(dts) != 1:
                raise TypeError(
                    f"expand slot {n}: projections disagree on dtype {dts}")
            nullable = any(p[i].nullable for p in self.projections)
            fields.append(Field(n, self.projections[0][i].data_type,
                                nullable))
        self._schema = Schema(fields)

    @property
    def schema(self) -> Schema:
        return self._schema


def _coerce_using_keys(left: LogicalPlan, right: LogicalPlan, on):
    """Cast mismatched numeric ``on=`` key columns on both sides to their
    common type (Spark's implicit cast insertion for USING joins)."""
    from ..expr.arithmetic import numeric_promote
    from ..expr.cast import Cast

    casts_l, casts_r = {}, {}
    for k in on:
        lt = left.schema.field(k).dtype
        rt = right.schema.field(k).dtype
        if lt == rt or not (lt.is_numeric and rt.is_numeric) \
                or isinstance(lt, dt.DecimalType) \
                or isinstance(rt, dt.DecimalType):
            # decimal keys are joined as they are, as the JAX package does
            continue
        common = numeric_promote(lt, rt)
        if lt != common:
            casts_l[k] = common
        if rt != common:
            casts_r[k] = common

    def apply(plan: LogicalPlan, casts):
        if not casts:
            return plan
        exprs = []
        for f in plan.schema:
            ref = AttributeReference(f.name, f.dtype, f.nullable)
            exprs.append(Alias(Cast(ref, casts[f.name]), f.name)
                         if f.name in casts else ref)
        return LogicalProject(plan, exprs)

    return apply(left, casts_l), apply(right, casts_r)


def _join_schema(ls: Schema, rs: Schema, on, how: str) -> Schema:
    """A join's output: the ``on`` keys once, then the left columns, then the
    right; a side that outer rows pad with nulls becomes nullable."""
    if how in ("left_semi", "left_anti"):
        return ls
    lnull = how in ("right", "full")
    rnull = how in ("left", "full")
    fields: List[Field] = []
    keys = list(on) if on else []
    for k in keys:
        lf = ls.field(k)
        fields.append(Field(k, lf.dtype, lf.nullable or lnull))
    fields += [Field(f.name, f.dtype, f.nullable or lnull)
               for f in ls.fields if f.name not in keys]
    fields += [Field(f.name, f.dtype, f.nullable or rnull)
               for f in rs.fields if f.name not in keys]
    return Schema(fields)


def _named(e: Expression, i: int, prefix: str = "col") -> Expression:
    """Ensure a projected expression has a stable output name."""
    if isinstance(e, (Alias, AttributeReference, AggregateFunction)):
        return e
    return Alias(e, f"{prefix}_{i}")


def _default_agg_name(fn: AggregateFunction) -> str:
    base = type(fn).__name__.lower()
    if fn.children:
        c = fn.children[0]
        inner = c.name if isinstance(c, (AttributeReference, Alias)) else "expr"
        return f"{base}({inner})"
    return f"{base}(*)"


def _check_dup(names: Sequence[str]):
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if list(names).count(n) > 1})
        raise ValueError(f"duplicate output columns: {dupes}")
