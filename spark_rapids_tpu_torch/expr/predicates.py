"""Predicates and comparisons — the port of
``spark_rapids_tpu/expr/predicates.py``.

And/Or implement Kleene three-valued logic; comparisons propagate nulls;
EqualNullSafe treats null==null as true.

String comparisons: the host engine compares object arrays; the device
compares the byte matrices lexicographically and then the lengths, so a
string sorts after its own prefix (and "ab" differs from "ab\\x00", which
the JAX package's zero-padded compare treats as equal). Wide decimals
compare their limbs on the device (expr/decimal128.py ``d128_eq`` and
``d128_lt``), and Python ints on the host.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from .arithmetic import _combine_validity, numeric_promote
from .base import EvalCol, EvalContext, Expression
from .cast import Cast

__all__ = ["BinaryComparison", "EqualTo", "EqualNullSafe", "LessThan",
           "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual",
           "And", "Or", "Not", "IsNull", "IsNotNull", "IsNaN", "In"]


def _device_string_cmp(lv: torch.Tensor, llen: torch.Tensor,
                       rv: torch.Tensor, rlen: torch.Tensor):
    """Byte-wise lexicographic compare of two (n, w) uint8 matrices with
    their lengths -> (eq, lt) bool planes: the first differing byte decides,
    and with none the shorter string is the smaller."""
    w = max(lv.shape[1], rv.shape[1])
    if lv.shape[1] < w:
        lv = torch.nn.functional.pad(lv, (0, w - lv.shape[1]))
    if rv.shape[1] < w:
        rv = torch.nn.functional.pad(rv, (0, w - rv.shape[1]))
    diff = lv.to(torch.int16) - rv.to(torch.int16)
    neq = diff != 0
    any_neq = neq.any(dim=1)
    first = torch.argmax(neq.to(torch.uint8), dim=1, keepdim=True)
    first_diff = torch.gather(diff, 1, first)[:, 0]
    same_bytes = torch.logical_not(any_neq)
    eq = torch.logical_and(same_bytes, llen == rlen)
    lt = torch.where(any_neq, first_diff < 0, llen < rlen)
    return eq, lt


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
        if ctx.is_device and isinstance(l.dtype, dt.StringType):
            eq, lt = _device_string_cmp(l.values, l.lengths, r.values,
                                        r.lengths)
            return EvalCol(self._from_eq_lt(eq, lt), validity, dt.BOOLEAN)
        if ctx.is_device and dt.is_d128(l.dtype):
            # limb planes (coerce gave both sides one decimal type)
            from .decimal128 import d128_eq, d128_lt
            return EvalCol(self._from_eq_lt(d128_eq(l.values, r.values),
                                            d128_lt(l.values, r.values)),
                           validity, dt.BOOLEAN)
        return EvalCol(self._compute(ctx, l.values, r.values), validity,
                       dt.BOOLEAN)

    def _compute(self, ctx, lv, rv):
        raise NotImplementedError

    def _from_eq_lt(self, eq, lt):
        """The comparison from the device string compare's planes."""
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def _compute(self, ctx, lv, rv):
        return lv == rv

    def _from_eq_lt(self, eq, lt):
        return eq


class LessThan(BinaryComparison):
    symbol = "<"

    def _compute(self, ctx, lv, rv):
        return lv < rv

    def _from_eq_lt(self, eq, lt):
        return lt


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _compute(self, ctx, lv, rv):
        return lv <= rv

    def _from_eq_lt(self, eq, lt):
        return torch.logical_or(eq, lt)


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _compute(self, ctx, lv, rv):
        return lv > rv

    def _from_eq_lt(self, eq, lt):
        return torch.logical_not(torch.logical_or(eq, lt))


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _compute(self, ctx, lv, rv):
        return lv >= rv

    def _from_eq_lt(self, eq, lt):
        return torch.logical_not(lt)


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
