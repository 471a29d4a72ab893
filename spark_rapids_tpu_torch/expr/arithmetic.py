"""Arithmetic expressions — the port of ``spark_rapids_tpu/expr/arithmetic.py``
without the decimal and bitwise operators (not ported yet).

Numeric promotion follows Spark's binary arithmetic coercion; nulls
propagate; integer division by zero yields null (non-ANSI mode), float
division follows IEEE.
"""
from __future__ import annotations

from ..columnar import dtypes as dt
from .base import EvalCol, EvalContext, Expression
from .cast import Cast

__all__ = ["BinaryArithmetic", "Add", "Subtract", "Multiply", "Divide",
           "IntegralDivide", "Remainder", "UnaryMinus", "Abs", "Pmod",
           "numeric_promote"]

_NUMERIC_ORDER = [dt.BYTE, dt.SHORT, dt.INT, dt.LONG, dt.FLOAT, dt.DOUBLE]


def numeric_promote(a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """Least common numeric type (Spark's binary arithmetic coercion)."""
    if a == b:
        return a
    ia = _NUMERIC_ORDER.index(a) if a in _NUMERIC_ORDER else None
    ib = _NUMERIC_ORDER.index(b) if b in _NUMERIC_ORDER else None
    if ia is None or ib is None:
        raise TypeError(f"cannot promote {a!r} and {b!r}")
    return _NUMERIC_ORDER[max(ia, ib)]


def _combine_validity(ctx: EvalContext, *cols: EvalCol):
    validity = None
    for c in cols:
        if c.validity is not None:
            validity = c.validity if validity is None \
                else ctx.xp.logical_and(validity, c.validity)
    return validity


class BinaryArithmetic(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)

    def coerce(self) -> "Expression":
        lt, rt = self.left.data_type, self.right.data_type
        out = self.result_type(lt, rt)
        left, right = self.left, self.right
        if lt != self.operand_type(out):
            left = Cast(left, self.operand_type(out))
        if rt != self.operand_type(out):
            right = Cast(right, self.operand_type(out))
        node = type(self)(left, right)
        node._out_type = out
        return node

    def result_type(self, lt, rt) -> dt.DataType:
        return numeric_promote(lt, rt)

    def operand_type(self, out: dt.DataType) -> dt.DataType:
        return out

    @property
    def data_type(self) -> dt.DataType:
        t = getattr(self, "_out_type", None)
        if t is None:
            t = self.result_type(self.left.data_type, self.right.data_type)
        return t

    def eval(self, ctx: EvalContext) -> EvalCol:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        validity = _combine_validity(ctx, l, r)
        values, extra_invalid = self._compute(ctx, l.values, r.values)
        if extra_invalid is not None:
            base = validity if validity is not None \
                else ctx.xp.ones(values.shape[0], dtype=bool)
            validity = ctx.xp.logical_and(base,
                                          ctx.xp.logical_not(extra_invalid))
        return EvalCol(values, validity, self.data_type)

    def _compute(self, ctx, lv, rv):
        """Return (values, extra_invalid_mask_or_None)."""
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def _compute(self, ctx, lv, rv):
        return lv + rv, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _compute(self, ctx, lv, rv):
        return lv - rv, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _compute(self, ctx, lv, rv):
        return lv * rv, None


class Divide(BinaryArithmetic):
    """Spark's / always yields double (fractional division); /0 -> null."""
    symbol = "/"

    def result_type(self, lt, rt):
        return dt.DOUBLE

    def _compute(self, ctx, lv, rv):
        xp = ctx.xp
        lv = xp.astype(lv, xp.float64)
        rv = xp.astype(rv, xp.float64)
        zero = rv == 0
        safe = xp.where(zero, xp.ones_like(rv), rv)
        return lv / safe, zero


def _java_quotient(xp, lv, safe):
    """Integer quotient truncated toward zero (Java), from floor division."""
    q = lv // safe
    return xp.where((lv % safe != 0) & ((lv < 0) != (safe < 0)), q + 1, q)


class IntegralDivide(BinaryArithmetic):
    symbol = "div"

    def result_type(self, lt, rt):
        return dt.LONG

    def operand_type(self, out):
        return dt.LONG

    def _compute(self, ctx, lv, rv):
        xp = ctx.xp
        zero = rv == 0
        safe = xp.where(zero, xp.ones_like(rv), rv)
        return _java_quotient(xp, lv, safe), zero


class Remainder(BinaryArithmetic):
    symbol = "%"

    def _compute(self, ctx, lv, rv):
        xp = ctx.xp
        zero = rv == 0
        safe = xp.where(zero, xp.ones_like(rv), rv)
        # Java-style remainder takes the sign of the dividend
        if self.data_type in (dt.FLOAT, dt.DOUBLE):
            return lv - xp.astype(xp.trunc(lv / safe), lv.dtype) * safe, zero
        return lv - _java_quotient(xp, lv, safe) * safe, zero


class Pmod(BinaryArithmetic):
    symbol = "pmod"

    def _compute(self, ctx, lv, rv):
        xp = ctx.xp
        zero = rv == 0
        safe = xp.where(zero, xp.ones_like(rv), rv)
        return lv % safe, zero


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return self.child.data_type

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(-c.values, c.validity, self.data_type)


class Abs(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return self.child.data_type

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(ctx.xp.abs(c.values), c.validity, self.data_type)
