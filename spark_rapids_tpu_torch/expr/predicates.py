"""Predicates and comparisons — the port of
``spark_rapids_tpu/expr/predicates.py`` (string comparisons on the device
are not ported yet; the host engine compares object arrays).

And/Or implement Kleene three-valued logic; comparisons propagate nulls;
EqualNullSafe treats null==null as true.
"""
from __future__ import annotations

from ..columnar import dtypes as dt
from .arithmetic import _combine_validity, numeric_promote
from .base import EvalCol, EvalContext, Expression
from .cast import Cast

__all__ = ["BinaryComparison", "EqualTo", "EqualNullSafe", "LessThan",
           "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual",
           "And", "Or", "Not", "IsNull", "IsNotNull", "IsNaN", "In"]


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)

    def coerce(self) -> "Expression":
        lt, rt = self.left.data_type, self.right.data_type
        if lt == rt or isinstance(lt, (dt.StringType, dt.BinaryType)):
            return self
        if isinstance(lt, dt.NullType) or isinstance(rt, dt.NullType):
            return self
        if lt.is_numeric and rt.is_numeric:
            common = numeric_promote(lt, rt)
            left = self.left if lt == common else Cast(self.left, common)
            right = self.right if rt == common else Cast(self.right, common)
            return type(self)(left, right)
        if {type(lt), type(rt)} == {dt.DateType, dt.TimestampType}:
            left = self.left if isinstance(lt, dt.TimestampType) \
                else Cast(self.left, dt.TIMESTAMP)
            right = self.right if isinstance(rt, dt.TimestampType) \
                else Cast(self.right, dt.TIMESTAMP)
            return type(self)(left, right)
        raise TypeError(f"cannot compare {lt!r} with {rt!r}")

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        validity = _combine_validity(ctx, l, r)
        return EvalCol(self._compute(ctx, l.values, r.values), validity,
                       dt.BOOLEAN)

    def _compute(self, ctx, lv, rv):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def _compute(self, ctx, lv, rv):
        return lv == rv


class LessThan(BinaryComparison):
    symbol = "<"

    def _compute(self, ctx, lv, rv):
        return lv < rv


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _compute(self, ctx, lv, rv):
        return lv <= rv


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _compute(self, ctx, lv, rv):
        return lv > rv


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _compute(self, ctx, lv, rv):
        return lv >= rv


class EqualNullSafe(BinaryComparison):
    symbol = "<=>"

    def eval(self, ctx: EvalContext) -> EvalCol:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        xp = ctx.xp
        lvalid = l.valid_mask(ctx)
        rvalid = r.valid_mask(ctx)
        eq = l.values == r.values
        both_valid = xp.logical_and(lvalid, rvalid)
        both_null = xp.logical_and(xp.logical_not(lvalid),
                                   xp.logical_not(rvalid))
        values = xp.logical_or(xp.logical_and(both_valid, eq), both_null)
        return EvalCol(values, None, dt.BOOLEAN)


class And(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        lv, rv = l.values, r.values
        lvalid, rvalid = l.valid_mask(ctx), r.valid_mask(ctx)
        # Kleene: false if either side is definitively false
        false_l = xp.logical_and(lvalid, xp.logical_not(lv))
        false_r = xp.logical_and(rvalid, xp.logical_not(rv))
        any_false = xp.logical_or(false_l, false_r)
        validity = xp.logical_or(any_false, xp.logical_and(lvalid, rvalid))
        values = xp.logical_and(xp.logical_not(any_false),
                                xp.logical_and(lv, rv))
        if l.validity is None and r.validity is None:
            validity = None
        return EvalCol(values, validity, dt.BOOLEAN)

    def __repr__(self):
        return f"({self.left!r} AND {self.right!r})"


class Or(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        lvalid, rvalid = l.valid_mask(ctx), r.valid_mask(ctx)
        true_l = xp.logical_and(lvalid, l.values)
        true_r = xp.logical_and(rvalid, r.values)
        any_true = xp.logical_or(true_l, true_r)
        validity = xp.logical_or(any_true, xp.logical_and(lvalid, rvalid))
        if l.validity is None and r.validity is None:
            validity = None
        return EvalCol(any_true, validity, dt.BOOLEAN)

    def __repr__(self):
        return f"({self.left!r} OR {self.right!r})"


class Not(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(ctx.xp.logical_not(c.values), c.validity, dt.BOOLEAN)


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.BOOLEAN

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(ctx.xp.logical_not(c.valid_mask(ctx)), None,
                       dt.BOOLEAN)


class IsNotNull(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.BOOLEAN

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(c.valid_mask(ctx), None, dt.BOOLEAN)


class IsNaN(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(ctx.xp.isnan(c.values), c.validity, dt.BOOLEAN)


class In(Expression):
    """value IN (literal list) — an OR-reduction of equalities."""

    def __init__(self, child: Expression, *values: Expression):
        self.child = child
        self.values = tuple(values)
        self.children = (child,) + self.values

    def with_children(self, children):
        return In(children[0], *children[1:])

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        c = self.child.eval(ctx)
        acc = None
        for v in self.values:
            eq = EqualTo(self.child, v).eval(ctx)
            acc = eq.values if acc is None else xp.logical_or(acc, eq.values)
        return EvalCol(acc, c.validity, dt.BOOLEAN)
