"""Cast expression — the port of ``spark_rapids_tpu/expr/cast.py``, cut to
the numeric, boolean and date/timestamp directions. String and decimal casts
are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from .base import EvalCol, EvalContext, Expression

__all__ = ["Cast", "cast_supported"]


def cast_supported(src: dt.DataType, to: dt.DataType) -> bool:
    """Whether this port evaluates the cast ``src -> to`` (either engine)."""
    if src == to or isinstance(src, dt.NullType):
        return True
    if isinstance(to, dt.BooleanType):
        return src.is_numeric
    if isinstance(src, dt.BooleanType):
        return to.is_numeric
    if src.is_numeric and to.is_numeric:
        return True
    if isinstance(src, dt.DateType):
        return to.is_numeric or isinstance(to, dt.TimestampType)
    if isinstance(src, dt.TimestampType):
        return to in (dt.LONG, dt.INT) or isinstance(to, dt.DateType)
    return False


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DataType, ansi: bool = False):
        self.child = child
        self.to = to
        self.ansi = ansi
        self.children = (child,)

    @property
    def data_type(self) -> dt.DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def with_children(self, children):
        return Cast(children[0], self.to, self.ansi)

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        src, to = c.dtype, self.to
        if src == to:
            return c
        if not cast_supported(src, to):
            raise TypeError(f"cast {src!r} -> {to!r} is not ported yet")
        xp = ctx.xp
        if isinstance(src, dt.NullType):
            n = c.shape0()
            return EvalCol(xp.zeros(n, dtype=to.np_dtype()),
                           xp.zeros(n, dtype=bool), to)
        if isinstance(to, dt.BooleanType):
            return EvalCol(c.values != 0, c.validity, to)
        if src in (dt.FLOAT, dt.DOUBLE) and to.is_integral:
            return EvalCol(_float_to_integral(xp, c.values, to), c.validity,
                           to)
        if isinstance(src, dt.DateType) and isinstance(to, dt.TimestampType):
            return EvalCol(xp.astype(c.values, xp.int64) * 86_400_000_000,
                           c.validity, to)
        if isinstance(src, dt.TimestampType) and isinstance(to, dt.DateType):
            days = xp.floor_divide(c.values, 86_400_000_000)
            return EvalCol(xp.astype(days, xp.int32), c.validity, to)
        if isinstance(src, dt.TimestampType):
            secs = xp.floor_divide(c.values, 1_000_000)
            return EvalCol(xp.astype(secs, to.np_dtype()), c.validity, to)
        # numeric <-> numeric, boolean -> numeric, date -> days as a number
        return EvalCol(xp.astype(c.values, to.np_dtype()), c.validity, to)


def _float_to_integral(xp, values, to: dt.DataType):
    """Spark (Scala Double.toInt/toLong) semantics: truncate toward zero,
    SATURATE at the target range, NaN -> 0. Saturation happens in integer
    space: float(INT64_MAX) rounds UP to 2^63, so a float clip alone still
    overflows. SHORT/BYTE go through toInt then bit-truncate (Scala
    Double.toShort == toInt.toShort)."""
    np_to = to.np_dtype()
    sat_np = np_to if to in (dt.INT, dt.LONG) else np.dtype(np.int32)
    info = np.iinfo(sat_np)
    v = xp.trunc(xp.astype(values, xp.float64))
    nan = xp.isnan(v)
    big = v >= float(info.max)
    small = v <= float(info.min)
    safe = xp.where(nan | big | small, xp.zeros_like(v), v)
    out = xp.astype(safe, sat_np)
    out = xp.where(big, xp.full(out.shape, int(info.max), sat_np), out)
    out = xp.where(small, xp.full(out.shape, int(info.min), sat_np), out)
    return xp.astype(out, np_to)
