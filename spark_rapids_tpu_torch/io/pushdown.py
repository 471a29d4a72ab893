"""Scan predicate pushdown — the port of ``spark_rapids_tpu/io/pushdown.py``.

Reference: the plugin forwards Spark's pushed filters into its readers
(parquet row-group pruning via statistics, GpuParquetScanBase). Here the
planner translates the supported conjuncts of a Filter over a Scan into a
``pyarrow.dataset`` expression attached to the source, and the Parquet
reader prunes row groups by their statistics. The full filter stays in the
plan: pushdown only lets the reader skip data.
"""
from __future__ import annotations

import datetime as _dt

from ..columnar import dtypes as dt
from ..expr.base import AttributeReference, Expression, Literal

__all__ = ["to_arrow_filter", "push_filter_into_scan"]

_INT_RANK = {dt.BYTE: 1, dt.SHORT: 2, dt.INT: 3, dt.LONG: 4}
_INT_BITS = {dt.BYTE: 8, dt.SHORT: 16, dt.INT: 32, dt.LONG: 64}
_FP_RANK = {dt.FLOAT: 1, dt.DOUBLE: 2}
_FP_MANTISSA = {dt.FLOAT: 24, dt.DOUBLE: 53}


def _is_widening(src, dst) -> bool:
    """Value-preserving numeric widening only: every ``src`` value maps to
    the same value in ``dst``, so stripping the cast cannot change a
    comparison. A narrowing cast (double -> int truncation and the like)
    changes the compared value and stays."""
    if src == dst:
        return True
    if src in _INT_RANK and dst in _INT_RANK:
        return _INT_RANK[src] <= _INT_RANK[dst]
    if src in _FP_RANK and dst in _FP_RANK:
        return _FP_RANK[src] <= _FP_RANK[dst]
    if src in _INT_RANK and dst in _FP_RANK:
        # int -> float is exact only within the mantissa
        return _INT_BITS[src] <= _FP_MANTISSA[dst]
    return False


def to_arrow_filter(e: Expression, strict: bool = False):
    """Translate a supported predicate subtree into a pyarrow.dataset
    expression; None when any needed part does not translate. Outside
    ``strict`` mode the result may be a PARTIAL conjunction (sound for a
    positive pushdown: it only keeps more rows); under Not the child must
    translate in ``strict`` mode, since negating a partial conjunction
    would drop rows."""
    import pyarrow.dataset as pads

    from ..expr.cast import Cast
    from ..expr.predicates import (And, EqualTo, GreaterThan,
                                   GreaterThanOrEqual, In, IsNotNull, IsNull,
                                   LessThan, LessThanOrEqual, Not, Or)

    def unwrap(x):
        # type coercion wraps operands in value-preserving widening casts
        # (an int literal against a long column); only those may be stripped
        while isinstance(x, Cast):
            try:
                src = x.child.data_type
            except Exception:
                break
            if not _is_widening(src, x.to):
                break
            x = x.child
        return x

    def field_lit(a, b):
        a, b = unwrap(a), unwrap(b)
        if isinstance(a, AttributeReference) and isinstance(b, Literal):
            return pads.field(a.column_name), b.value
        return None, None

    if isinstance(e, And):
        l = to_arrow_filter(e.left, strict)
        r = to_arrow_filter(e.right, strict)
        if l is not None and r is not None:
            return l & r
        if strict:
            return None  # a negation context needs the whole conjunction
        return l if r is None else r
    if isinstance(e, Or):
        l = to_arrow_filter(e.left, strict)
        r = to_arrow_filter(e.right, strict)
        # a partial disjunction would drop rows: both sides or nothing
        return (l | r) if l is not None and r is not None else None
    if isinstance(e, Not):
        inner = to_arrow_filter(e.children[0], strict=True)
        return ~inner if inner is not None else None
    if isinstance(e, (IsNull, IsNotNull)):
        c = e.children[0]
        if not isinstance(c, AttributeReference):
            return None
        test = pads.field(c.column_name).is_null()
        return test if isinstance(e, IsNull) else ~test
    if isinstance(e, In):
        c = e.children[0]
        opts = e.children[1:]
        if isinstance(c, AttributeReference) \
                and all(isinstance(o, Literal) for o in opts):
            vals = [o.value for o in opts]
            if any(v is None for v in vals):
                return None
            return pads.field(c.column_name).isin(vals)
        return None
    ops = {EqualTo: "==", LessThan: "<", LessThanOrEqual: "<=",
           GreaterThan: ">", GreaterThanOrEqual: ">="}
    flipped = {"==": "==", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
    op = ops.get(type(e))
    if op is None:
        return None
    f, v = field_lit(e.left, e.right)
    if f is None:
        f, v = field_lit(e.right, e.left)
        op = flipped[op]
    if f is None or v is None:
        return None
    if not isinstance(v, (_dt.date, _dt.datetime, int, float, str, bool,
                          bytes)):
        return None
    return {"==": f.__eq__, "<": f.__lt__, "<=": f.__le__,
            ">": f.__gt__, ">=": f.__ge__}[op](v)


def push_filter_into_scan(scan_source, condition: Expression) -> bool:
    """Attach the translatable part of ``condition`` to a source that takes
    one (``ParquetSource.push_filter``); True if anything was pushed."""
    push = getattr(scan_source, "push_filter", None)
    if push is None:
        return False
    arrow_expr = to_arrow_filter(condition)
    if arrow_expr is None:
        return False
    push(arrow_expr)
    return True
