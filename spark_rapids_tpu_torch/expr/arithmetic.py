"""Arithmetic expressions — the port of ``spark_rapids_tpu/expr/arithmetic.py``
with ``bitwise_not`` and the shifts (the binary bitwise operators are not
ported yet: ROADMAP Queue 1, breadth).

Numeric promotion follows Spark's binary arithmetic coercion, decimals
included (DecimalPrecision: the add and multiply rules, capped at 38
digits); nulls propagate; integer division by zero yields null (non-ANSI
mode), float division follows IEEE. Decimal results past their precision
are null (CheckOverflow). On the device a wide decimal (p > 18) is a limb
plane (expr/decimal128.py): add and subtract are torch ops on its digits, a
product goes through the ``d128_mul_rescaled`` kernel unless both operands
are decimal64 and it fits int64. The host engine computes wide decimals
exactly on Python ints.
"""
from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from .base import EvalCol, EvalContext, Expression
from .cast import Cast, obj_array, rescale_py_half_up

__all__ = ["BinaryArithmetic", "Add", "Subtract", "Multiply", "Divide",
           "IntegralDivide", "Remainder", "UnaryMinus", "Abs", "Pmod",
           "BitwiseNot", "ShiftLeft", "ShiftRight", "ShiftRightUnsigned",
           "numeric_promote", "adjust_decimal"]

_NUMERIC_ORDER = [dt.BYTE, dt.SHORT, dt.INT, dt.LONG, dt.FLOAT, dt.DOUBLE]


def adjust_decimal(precision: int, scale: int) -> dt.DecimalType:
    """Spark's DecimalPrecision.adjustPrecisionScale: cap at 38 digits,
    sacrificing scale down to min(scale, 6) to keep integral digits."""
    if precision <= dt.DecimalType.MAX_PRECISION_128:
        return dt.DecimalType(precision, scale)
    int_digits = precision - scale
    min_scale = min(scale, 6)
    adj_scale = max(dt.DecimalType.MAX_PRECISION_128 - int_digits, min_scale)
    return dt.DecimalType(dt.DecimalType.MAX_PRECISION_128, adj_scale)


def numeric_promote(a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """Least common numeric type (Spark's binary arithmetic coercion)."""
    if a == b:
        return a
    if isinstance(a, dt.DecimalType) or isinstance(b, dt.DecimalType):
        if isinstance(a, dt.DecimalType) and isinstance(b, dt.DecimalType):
            # Spark's add/sub rule: s = max(s1, s2),
            # p = max(p1 - s1, p2 - s2) + s + 1, adjusted to the 38 cap
            scale = max(a.scale, b.scale)
            prec = max(a.precision - a.scale, b.precision - b.scale) \
                + scale + 1
            return adjust_decimal(prec, scale)
        other = b if isinstance(a, dt.DecimalType) else a
        if other in (dt.FLOAT, dt.DOUBLE):
            return dt.DOUBLE
        return a if isinstance(a, dt.DecimalType) else b
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


def _d128_addsub(ctx, lv, rv, out: dt.DecimalType, sub: bool):
    """Two-limb add/sub with overflow -> null (coerce casts both operands
    to ``out``; |a|, |b| < 10^38 keeps the 128-bit sum from wrapping)."""
    if ctx.is_device:
        from .decimal128 import d128_add, d128_overflows, d128_sub
        s = d128_sub(lv, rv) if sub else d128_add(lv, rv)
        return s, d128_overflows(s, out.precision)
    py = [int(a) - int(b) if sub else int(a) + int(b)
          for a, b in zip(lv, rv)]
    over = np.array([abs(v) >= 10 ** out.precision for v in py], dtype=bool)
    return obj_array(py), over


class Add(BinaryArithmetic):
    symbol = "+"

    def _compute(self, ctx, lv, rv):
        if dt.is_d128(self.data_type):
            return _d128_addsub(ctx, lv, rv, self.data_type, sub=False)
        return lv + rv, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _compute(self, ctx, lv, rv):
        if dt.is_d128(self.data_type):
            return _d128_addsub(ctx, lv, rv, self.data_type, sub=True)
        return lv - rv, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    def result_type(self, lt, rt):
        if isinstance(lt, dt.DecimalType) and isinstance(rt, dt.DecimalType):
            # Spark's multiply rule: p = p1 + p2 + 1, s = s1 + s2, adjusted
            return adjust_decimal(lt.precision + rt.precision + 1,
                                  lt.scale + rt.scale)
        return numeric_promote(lt, rt)

    def coerce(self) -> "Expression":
        lt, rt = self.left.data_type, self.right.data_type
        if isinstance(lt, dt.DecimalType) and isinstance(rt, dt.DecimalType):
            # the operands keep their own scales (the product's scale is
            # s1 + s2); the generic coerce would cast them to the output's
            node = type(self)(self.left, self.right)
            node._out_type = self.result_type(lt, rt)
            return node
        return super().coerce()

    def _int64_product(self) -> bool:
        """Whether a decimal product is exact in int64 (< 10^18)."""
        out = self.data_type
        lt, rt = self.left.data_type, self.right.data_type
        return not (dt.is_d128(out) or dt.is_d128(lt) or dt.is_d128(rt)) \
            and lt.precision + rt.precision <= 18

    def runs_kernel(self) -> bool:
        return all(isinstance(t, dt.DecimalType) for t in (
            self.data_type, self.left.data_type, self.right.data_type)) \
            and not self._int64_product()

    def _compute(self, ctx, lv, rv):
        out = self.data_type
        lt, rt = self.left.data_type, self.right.data_type
        if not (isinstance(out, dt.DecimalType)
                and isinstance(lt, dt.DecimalType)
                and isinstance(rt, dt.DecimalType)):
            return lv * rv, None
        drop = max(lt.scale + rt.scale - out.scale, 0)
        if ctx.is_device:
            if self._int64_product():
                return lv * rv, None    # the product < 10^18: exact int64
            from .decimal128 import d128_mul_rescaled, d128_to_i64
            # a decimal64 operand goes to the kernel as scaled int64
            limbs, over = d128_mul_rescaled(lv.contiguous(), rv.contiguous(),
                                            drop, out.precision)
            if dt.is_d128(out):
                return limbs, over
            v64, over2 = d128_to_i64(limbs)
            return v64, ctx.xp.logical_or(over, over2)
        py = [rescale_py_half_up(int(a) * int(b), drop, 0)
              for a, b in zip(lv, rv)]
        over = np.array([abs(v) >= 10 ** out.precision for v in py],
                        dtype=bool)
        if dt.is_d128(out):
            return obj_array(py), over
        return np.array([0 if o else v for v, o in zip(py, over)],
                        dtype=np.int64), over


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
        if dt.is_d128(self.data_type):
            if ctx.is_device:
                from .decimal128 import d128_neg
                return EvalCol(d128_neg(c.values), c.validity,
                               self.data_type)
            return EvalCol(obj_array([-int(v) for v in c.values]),
                           c.validity, self.data_type)
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
        if dt.is_d128(self.data_type):
            if ctx.is_device:
                from .decimal128 import d128_abs
                return EvalCol(d128_abs(c.values), c.validity,
                               self.data_type)
            return EvalCol(obj_array([abs(int(v)) for v in c.values]),
                           c.validity, self.data_type)
        return EvalCol(ctx.xp.abs(c.values), c.validity, self.data_type)


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self) -> dt.DataType:
        t = self.child.data_type
        if not t.is_integral:
            raise TypeError(
                f"bitwise_not needs an integral operand, got {t!r}")
        return t

    def with_children(self, children):
        return BitwiseNot(children[0])

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(~c.values, c.validity, self.data_type)

    def __repr__(self):
        return f"~{self.child!r}"


class _ShiftBase(Expression):
    """The shift amount masks to the value's width, as in Java and Spark
    (x << 65 on a long shifts by 1)."""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def data_type(self) -> dt.DataType:
        t = self.left.data_type
        if t not in (dt.INT, dt.LONG):
            raise TypeError(f"shift needs int/bigint value, got {t!r}")
        return t

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        lc = self.left.eval(ctx)
        rc = self.right.eval(ctx)
        bits = 64 if self.data_type == dt.LONG else 32
        v = xp.astype(lc.values, self.data_type.np_dtype())
        sh = xp.astype(rc.values & (bits - 1), self.data_type.np_dtype())
        return EvalCol(self._shift(xp, v, sh, bits),
                       _combine_validity(ctx, lc, rc), self.data_type)

    def __repr__(self):
        return f"{type(self).__name__}({self.left!r}, {self.right!r})"


class ShiftLeft(_ShiftBase):
    def _shift(self, xp, v, sh, bits):
        return v << sh


class ShiftRight(_ShiftBase):
    def _shift(self, xp, v, sh, bits):
        return v >> sh  # arithmetic (sign-propagating) on signed ints


class ShiftRightUnsigned(_ShiftBase):
    def _shift(self, xp, v, sh, bits):
        from .xp_torch import TorchNamespace
        if not isinstance(xp, TorchNamespace):
            u = np.uint64 if bits == 64 else np.uint32
            return (v.astype(u) >> sh.astype(u)).astype(v.dtype)
        if bits == 32:   # the uint32 bits in int64, shifted, cut back
            wide = (xp.astype(v, xp.int64) & 0xFFFFFFFF) \
                >> xp.astype(sh, xp.int64)
            return xp.astype(wide, xp.int32)
        # torch shifts no unsigned type: an arithmetic shift, then the
        # sign-extended bits masked off (none for a shift of 0)
        mask = (2**63 - 1) >> (sh - 1).clamp(min=0)
        return xp.where(sh == 0, v, (v >> sh) & mask)
