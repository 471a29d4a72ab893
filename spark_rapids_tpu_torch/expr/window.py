"""Window specifications and functions — the port of
``spark_rapids_tpu/expr/window.py`` (reference: GpuWindowExec.scala and
GpuWindowExpression.scala: frames map to scans and per-row frame
reductions, with the running window, UNBOUNDED PRECEDING -> CURRENT ROW,
as a scan).

The API mirrors pyspark:

    w = Window.partition_by("k").order_by(col("v"))
    df.with_column("rn", row_number().over(w))
    df.with_column("s", F.sum(col("x")).over(w.rows_between(None, 0)))
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..columnar import dtypes as dt
from .aggregates import AggregateFunction
from .base import Expression
from .functions import Column, SortOrder, _to_expr

__all__ = ["Window", "WindowSpec", "WindowFrame", "WindowFunction",
           "RowNumber", "Rank", "DenseRank", "NTile", "Lag", "Lead",
           "WindowExpression", "row_number", "rank", "dense_rank", "lag",
           "lead", "ntile"]

UNBOUNDED = None
CURRENT_ROW = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """kind: 'rows' or 'range'; start/end: None = unbounded, int = offset
    (negative = preceding, 0 = current row, positive = following)."""
    kind: str = "range"
    start: Optional[int] = UNBOUNDED
    end: Optional[int] = CURRENT_ROW

    @property
    def is_unbounded_entire(self) -> bool:
        return self.start is None and self.end is None

    @property
    def is_running(self) -> bool:
        return self.start is None and self.end == 0

    def describe(self) -> str:
        def b(v, side):
            if v is None:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
        return f"{self.kind.upper()} BETWEEN {b(self.start, 'PRECEDING')} " \
               f"AND {b(self.end, 'FOLLOWING')}"


class WindowSpec:
    def __init__(self, partition_exprs: Tuple[Expression, ...] = (),
                 orders: Tuple[SortOrder, ...] = (),
                 frame: Optional[WindowFrame] = None):
        self.partition_exprs = tuple(partition_exprs)
        self.orders = tuple(orders)
        self._explicit_frame = frame

    @property
    def frame(self) -> WindowFrame:
        if self._explicit_frame is not None:
            return self._explicit_frame
        # Spark default: with ORDER BY -> RANGE UNBOUNDED PRECEDING..CURRENT;
        # without -> entire partition
        if self.orders:
            return WindowFrame("range", UNBOUNDED, CURRENT_ROW)
        return WindowFrame("rows", UNBOUNDED, UNBOUNDED)

    def partition_by(self, *cols) -> "WindowSpec":
        exprs = tuple(_to_expr(c if not isinstance(c, str) else _col(c))
                      for c in cols)
        return WindowSpec(self.partition_exprs + exprs, self.orders,
                          self._explicit_frame)

    def order_by(self, *orders) -> "WindowSpec":
        sos = []
        for o in orders:
            if isinstance(o, SortOrder):
                sos.append(o)
            elif isinstance(o, str):
                sos.append(SortOrder(_to_expr(_col(o)), True))
            else:
                sos.append(SortOrder(_to_expr(o), True))
        return WindowSpec(self.partition_exprs, self.orders + tuple(sos),
                          self._explicit_frame)

    def rows_between(self, start: Optional[int], end: Optional[int]
                     ) -> "WindowSpec":
        return WindowSpec(self.partition_exprs, self.orders,
                          WindowFrame("rows", start, end))

    def range_between(self, start: Optional[int], end: Optional[int]
                      ) -> "WindowSpec":
        return WindowSpec(self.partition_exprs, self.orders,
                          WindowFrame("range", start, end))


class Window:
    unbounded_preceding = UNBOUNDED
    unbounded_following = UNBOUNDED
    current_row = CURRENT_ROW

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    @staticmethod
    def order_by(*orders) -> WindowSpec:
        return WindowSpec().order_by(*orders)


def _col(name: str):
    from .functions import col
    return col(name)


class WindowFunction(Expression):
    """Base for ranking/offset window functions (not standalone-evaluable)."""

    needs_order = True

    def over(self, spec: WindowSpec) -> Column:
        return Column(WindowExpression(self, spec))


class RowNumber(WindowFunction):
    def __init__(self):
        self.children = ()

    @property
    def data_type(self):
        return dt.INT

    @property
    def nullable(self):
        return False


class Rank(WindowFunction):
    def __init__(self):
        self.children = ()

    @property
    def data_type(self):
        return dt.INT

    @property
    def nullable(self):
        return False


class DenseRank(Rank):
    pass


class NTile(WindowFunction):
    def __init__(self, n: int = 4):
        self.n = n
        self.children = ()

    def with_children(self, children):
        return NTile(self.n)

    @property
    def data_type(self):
        return dt.INT

    @property
    def nullable(self):
        return False

    def __repr__(self):
        return f"NTile({self.n})"


class Lag(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.child = child
        self.offset = offset
        self.default = default
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0], self.offset, self.default)

    @property
    def data_type(self):
        return self.child.data_type

    def __repr__(self):
        return (f"{type(self).__name__}({self.child!r}, {self.offset}, "
                f"{self.default!r})")


class Lead(Lag):
    pass


class WindowExpression(Expression):
    """fn OVER spec — placed in a projection list; the planner pulls these out
    into a Window exec node (reference: GpuWindowExec meta pre/post
    projection splitting, GpuWindowExec.scala:187)."""

    def __init__(self, fn: Expression, spec: WindowSpec):
        self.fn = fn
        self.spec = spec
        self.children = (fn,) + spec.partition_exprs \
            + tuple(o.expr for o in spec.orders)

    def with_children(self, children):
        fn = children[0]
        np_ = len(self.spec.partition_exprs)
        parts = tuple(children[1:1 + np_])
        order_exprs = children[1 + np_:]
        orders = tuple(SortOrder(e, o.ascending, o.nulls_first)
                       for e, o in zip(order_exprs, self.spec.orders))
        return WindowExpression(fn, WindowSpec(parts, orders,
                                               self.spec._explicit_frame))

    @property
    def data_type(self):
        if isinstance(self.fn, AggregateFunction):
            return self.fn.data_type
        return self.fn.data_type

    @property
    def nullable(self):
        return self.fn.nullable

    def __repr__(self):
        # the full spec: plans and explain show it
        parts = ", ".join(repr(e) for e in self.spec.partition_exprs)
        orders = ", ".join(
            f"{o.expr!r} {'ASC' if o.ascending else 'DESC'} "
            f"{'NF' if o.nulls_first else 'NL'}"
            for o in self.spec.orders)
        return (f"{self.fn!r} OVER (PARTITION BY [{parts}] "
                f"ORDER BY [{orders}] {self.spec.frame.describe()})")


def row_number() -> WindowFunction:
    return RowNumber()


def rank() -> WindowFunction:
    return Rank()


def dense_rank() -> WindowFunction:
    return DenseRank()


def ntile(n: int) -> WindowFunction:
    return NTile(n)


def lag(c, offset: int = 1, default=None) -> WindowFunction:
    return Lag(_to_expr(c), offset, default)


def lead(c, offset: int = 1, default=None) -> WindowFunction:
    return Lead(_to_expr(c), offset, default)


# aggregate Columns gain .over()
def _agg_over(self: Column, spec: WindowSpec) -> Column:
    if not isinstance(self.expr, (AggregateFunction, WindowFunction)):
        raise TypeError(f"{self.expr!r} is not a window-capable function")
    return Column(WindowExpression(self.expr, spec))


Column.over = _agg_over  # type: ignore[attr-defined]
