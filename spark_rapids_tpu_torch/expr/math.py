"""Math expressions — the port of ``spark_rapids_tpu/expr/math.py``
(reference: mathExpressions.scala). Each is written once against the array
namespace ``xp``: numpy on the host engine, torch on the device.

``round`` is HALF_UP. On a decimal it rounds the unscaled integer exactly
at the requested scale and keeps the column's type (Spark's
``BigDecimal.setScale(s, HALF_UP)``); the JAX package multiplies the
unscaled integer as if it were the value, and its rounding does nothing.
``ceil`` and ``floor`` of a decimal likewise round its value to a whole
number exactly and keep the column's type (Spark narrows the type to scale
0); the JAX package returns the value unchanged.
"""
from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from .arithmetic import _combine_validity
from .base import EvalCol, EvalContext, Expression, Literal
from .cast import Cast, obj_array, rescale_py_half_up
from .xp_torch import TorchNamespace

__all__ = ["UnaryMathExpression", "Sqrt", "Exp", "Log", "Log10", "Log2",
           "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
           "Tanh", "Cbrt", "Ceil", "Floor", "Round", "Signum", "Pow",
           "Atan2", "Expm1", "Log1p", "ToDegrees", "ToRadians", "Rint"]

_LONG_MAX = 9223372036854775807
_LONG_MIN = -9223372036854775808


def _f2long(xp, v):
    """Float -> long with Java's cast: NaN -> 0, +-inf and the values past
    the range saturate."""
    nan = xp.isnan(v)
    hi = v >= 2.0 ** 63
    lo = v <= -(2.0 ** 63)
    safe = xp.where(nan | hi | lo, xp.zeros_like(v), v)
    out = xp.astype(safe, xp.int64)
    out = xp.where(hi, xp.full(out.shape, _LONG_MAX, xp.int64), out)
    out = xp.where(lo, xp.full(out.shape, _LONG_MIN, xp.int64), out)
    return out


def _fn(xp, name):
    """The element function ``name`` of numpy, or torch's of that name."""
    torch_names = {"arcsin": "asin", "arccos": "acos", "arctan": "atan",
                   "degrees": "rad2deg", "radians": "deg2rad",
                   "power": "pow", "arctan2": "atan2"}
    if not isinstance(xp, TorchNamespace):
        return getattr(np, name)
    import torch
    return getattr(torch, torch_names.get(name, name))


class UnaryMathExpression(Expression):
    """Double-typed elementwise math; a domain error gives NaN, as Spark."""

    fn = ""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    def coerce(self):
        if self.child.data_type != dt.DOUBLE:
            return type(self)(Cast(self.child, dt.DOUBLE))
        return self

    @property
    def data_type(self):
        return dt.DOUBLE

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        return EvalCol(self._compute(ctx.xp, c.values), c.validity, dt.DOUBLE)

    def _compute(self, xp, v):
        return _fn(xp, self.fn)(v)


class Sqrt(UnaryMathExpression):
    fn = "sqrt"


class Exp(UnaryMathExpression):
    fn = "exp"


class Expm1(UnaryMathExpression):
    fn = "expm1"


class Log(UnaryMathExpression):
    fn = "log"


class Log1p(UnaryMathExpression):
    fn = "log1p"


class Log10(UnaryMathExpression):
    fn = "log10"


class Log2(UnaryMathExpression):
    fn = "log2"


class Sin(UnaryMathExpression):
    fn = "sin"


class Cos(UnaryMathExpression):
    fn = "cos"


class Tan(UnaryMathExpression):
    fn = "tan"


class Asin(UnaryMathExpression):
    fn = "arcsin"


class Acos(UnaryMathExpression):
    fn = "arccos"


class Atan(UnaryMathExpression):
    fn = "arctan"


class Sinh(UnaryMathExpression):
    fn = "sinh"


class Cosh(UnaryMathExpression):
    fn = "cosh"


class Tanh(UnaryMathExpression):
    fn = "tanh"


class Cbrt(UnaryMathExpression):
    def _compute(self, xp, v):
        if not isinstance(xp, TorchNamespace):
            return np.cbrt(v)
        import torch
        return torch.sign(v) * torch.pow(v.abs(), 1.0 / 3.0)


class ToDegrees(UnaryMathExpression):
    fn = "degrees"


class ToRadians(UnaryMathExpression):
    fn = "radians"


class Rint(UnaryMathExpression):
    """Half to even (numpy.round and torch.round alike)."""
    fn = "round"


class Signum(UnaryMathExpression):
    def _compute(self, xp, v):
        if not isinstance(xp, TorchNamespace):
            return np.sign(v)
        import torch
        return torch.where(torch.isnan(v), v, torch.sign(v))  # NaN stays


class _RoundingFn(Expression):
    """ceil / floor: LONG for a float input (Spark semantics); an integral
    or decimal column passes through."""

    fn = ""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        t = self.child.data_type
        return t if isinstance(t, (dt.IntegralType, dt.DecimalType)) \
            else dt.LONG

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if isinstance(c.dtype, dt.IntegralType):
            return c
        xp = ctx.xp
        if isinstance(c.dtype, dt.DecimalType):
            return self._whole_decimal(ctx, c)
        v = xp.astype(c.values, xp.float64)
        return EvalCol(_f2long(xp, _fn(xp, self.fn)(v)), c.validity, dt.LONG)

    def _whole_decimal(self, ctx, c: EvalCol) -> EvalCol:
        """The decimal's value rounded to a whole number toward +inf (ceil)
        or -inf (floor), at the column's scale."""
        f = 10 ** c.dtype.scale
        up = self.fn == "ceil"
        if not ctx.is_device:
            vals = [(-(-int(v) // f) if up else int(v) // f) * f
                    for v in c.values]
            vals = obj_array(vals) if dt.is_d128(c.dtype) \
                else np.array(vals, dtype=np.int64)
            return EvalCol(vals, c.validity, c.dtype)
        xp = ctx.xp
        v = c.values
        q = -xp.floor_divide(-v, f) if up else xp.floor_divide(v, f)
        return EvalCol(q * f, c.validity, c.dtype)


class Ceil(_RoundingFn):
    fn = "ceil"


class Floor(_RoundingFn):
    fn = "floor"


class Round(Expression):
    """round(x, scale) with HALF_UP (Spark's default)."""

    def __init__(self, child: Expression, scale: Expression = None):
        self.child = child
        self.scale = scale if scale is not None else Literal(0, dt.INT)
        self.children = (self.child, self.scale)

    def with_children(self, children):
        return Round(children[0], children[1] if len(children) > 1 else None)

    @property
    def data_type(self):
        return self.child.data_type

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        c = self.child.eval(ctx)
        if not isinstance(self.scale, Literal):
            raise TypeError("round scale must be a literal")
        s = int(self.scale.value)
        if isinstance(c.dtype, dt.DecimalType):
            return self._round_decimal(ctx, c, s)
        if isinstance(c.dtype, dt.IntegralType):
            if s >= 0:
                return c
            f = 10 ** (-s)
            half = f // 2
            shifted = xp.where(c.values >= 0, c.values + half,
                               c.values - half)
            return EvalCol(xp.floor_divide(shifted, f) * f, c.validity,
                           c.dtype)
        f = 10.0 ** s
        v = c.values * f
        # HALF_UP: away from zero on a tie (numpy.round is half to even)
        r = xp.where(v >= 0, _fn(xp, "floor")(v + 0.5),
                     _fn(xp, "ceil")(v - 0.5)) / f
        return EvalCol(xp.astype(r, c.values.dtype), c.validity, c.dtype)

    def _round_decimal(self, ctx, c: EvalCol, s: int) -> EvalCol:
        """HALF_UP of the unscaled integer at scale ``s``, kept at the
        column's scale."""
        scale = c.dtype.scale
        if s >= scale:
            return c
        k = scale - s
        if not ctx.is_device:
            vals = [rescale_py_half_up(rescale_py_half_up(int(v), scale, s),
                                       s, scale) for v in c.values]
            vals = obj_array(vals) if dt.is_d128(c.dtype) \
                else np.array(vals, dtype=np.int64)
            return EvalCol(vals, c.validity, c.dtype)
        if dt.is_d128(c.dtype):
            from .decimal128 import d128_rescale
            limbs, _ = d128_rescale(c.values.contiguous(), scale, s,
                                    c.dtype.precision)
            back, _ = d128_rescale(limbs, s, scale, c.dtype.precision)
            return EvalCol(back, c.validity, c.dtype)
        xp = ctx.xp
        f = 10 ** k
        av = xp.abs(c.values)
        q = xp.floor_divide(av, f)
        q = q + xp.astype(2 * (av - q * f) >= f, xp.int64)
        v = xp.where(c.values < 0, -q, q) * f
        return EvalCol(v, c.validity, c.dtype)

    def runs_kernel(self) -> bool:
        return dt.is_d128(self.child.data_type)


class _BinaryDoubleFn(Expression):
    fn = ""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    def coerce(self):
        l, r = (e if e.data_type == dt.DOUBLE else Cast(e, dt.DOUBLE)
                for e in (self.left, self.right))
        return type(self)(l, r)

    @property
    def data_type(self):
        return dt.DOUBLE

    def eval(self, ctx: EvalContext) -> EvalCol:
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        return EvalCol(_fn(ctx.xp, self.fn)(l.values, r.values),
                       _combine_validity(ctx, l, r), dt.DOUBLE)


class Pow(_BinaryDoubleFn):
    fn = "power"


class Atan2(_BinaryDoubleFn):
    fn = "arctan2"
