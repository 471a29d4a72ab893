"""Cast expression — the port of ``spark_rapids_tpu/expr/cast.py``, cut to
the numeric, boolean, decimal and date/timestamp directions. Casts to and
from strings are not ported yet (ROADMAP Queue 1: breadth).

Decimal casts follow the JAX package (GpuCast.scala:1513): decimal ->
decimal rescales exactly with HALF_UP rounding and nulls what passes the
target precision (the overflow test made before a multiply, so nothing
wraps); crossing 18 digits moves between scaled int64 and two int64 limbs,
through the ``d128_rescale`` kernel on the device. Integral and float
sources scale by 10^s (floats rounded half to even, as the JAX package's
``round``); a decimal to a float divides by 10^s, to an integral truncates
in integer space and keeps the target's low bits (Spark's non-ANSI cast;
the JAX package truncates a float64 and saturates). Past the target
precision, or from a NaN or infinite float, the result is null on both
engines (the JAX package checks only the wide tier: its decimal64 results
from integers and floats are not checked).
"""
from __future__ import annotations

import math

import numpy as np

from ..columnar import dtypes as dt
from ..conf import STEP_BREADTH, not_ported
from .base import EvalCol, EvalContext, Expression

__all__ = ["Cast", "cast_supported", "obj_array", "rescale_py_half_up"]


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
        return (to.is_numeric and not isinstance(to, dt.DecimalType)) \
            or isinstance(to, dt.TimestampType)
    if isinstance(src, dt.TimestampType):
        return to in (dt.LONG, dt.INT) or isinstance(to, dt.DateType)
    return False


def rescale_py_half_up(v: int, from_s: int, to_s: int) -> int:
    """Exact Python-int rescale with BigDecimal HALF_UP rounding."""
    if to_s >= from_s:
        return v * 10 ** (to_s - from_s)
    f = 10 ** (from_s - to_s)
    q, r = divmod(abs(v), f)
    if 2 * r >= f:
        q += 1
    return -q if v < 0 else q


def _and_valid(ctx, validity, extra):
    if validity is None:
        return extra
    return ctx.xp.logical_and(validity, extra)


def obj_array(py) -> np.ndarray:
    """Python ints (a wide decimal's host values) as an object array."""
    out = np.empty(len(py), dtype=object)
    out[:] = py
    return out


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

    def __repr__(self):
        return f"cast({self.child!r} as {self.to!r})"

    def runs_kernel(self) -> bool:
        # d128_rescale: a decimal to or from a two-limb decimal, and an
        # integral or boolean column to a two-limb decimal
        src, to = self.child.data_type, self.to
        if src == to or not isinstance(to, dt.DecimalType):
            return False
        if isinstance(src, dt.DecimalType):
            return dt.is_d128(src) or dt.is_d128(to)
        return dt.is_d128(to) and src not in (dt.FLOAT, dt.DOUBLE) \
            and not isinstance(src, dt.NullType)

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        src, to = c.dtype, self.to
        if src == to:
            return c
        if not cast_supported(src, to):
            if isinstance(src, (dt.StringType, dt.BinaryType)) \
                    or isinstance(to, (dt.StringType, dt.BinaryType)):
                raise TypeError(f"cast {src!r} -> {to!r} is not ported yet "
                                + not_ported(STEP_BREADTH))
            raise TypeError(f"cast {src!r} -> {to!r} is not ported yet")
        xp = ctx.xp
        if isinstance(src, dt.NullType):
            n = c.shape0()
            shape = (n, 2) if dt.is_d128(to) and ctx.is_device else n
            return EvalCol(xp.zeros(shape, dtype=to.np_dtype()),
                           xp.zeros(n, dtype=bool), to)
        if isinstance(to, dt.BooleanType):
            if dt.is_d128(src):
                nonzero = xp.logical_or(c.values[:, 0] != 0,
                                        c.values[:, 1] != 0) \
                    if ctx.is_device \
                    else np.array([int(v) != 0 for v in c.values], bool)
                return EvalCol(nonzero, c.validity, to)
            return EvalCol(c.values != 0, c.validity, to)
        if isinstance(src, dt.DecimalType) and isinstance(to, dt.DecimalType):
            return _cast_decimal_decimal(ctx, c, src, to)
        if isinstance(src, dt.DecimalType):
            return _cast_from_decimal(ctx, c, src, to)
        if isinstance(to, dt.DecimalType):
            return _cast_to_decimal(ctx, c, src, to)
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


def _cast_from_decimal(ctx, c: EvalCol, src: dt.DecimalType,
                       to: dt.DataType) -> EvalCol:
    """decimal -> float (over 10^s), or integral: truncated toward zero in
    integer space, then the low bits of the target type (Spark's non-ANSI
    ``Decimal.toLong``, ``.toInt``, ``.toShort``, ``.toByte``). The JAX
    package truncates a float64 and saturates; a float64 holds 53 bits, so
    it is wrong from 2^53 on (ROADMAP Queue 3, repaired)."""
    xp = ctx.xp
    if to in (dt.FLOAT, dt.DOUBLE):
        if not dt.is_d128(src):
            fvals = xp.astype(c.values, xp.float64)
        elif ctx.is_device:
            from .decimal128 import d128_to_f64
            fvals = d128_to_f64(c.values)
        else:
            fvals = np.array([float(int(v)) for v in c.values], np.float64)
        scaled = fvals / (10.0 ** src.scale)
        return EvalCol(xp.astype(scaled, to.np_dtype()), c.validity, to)
    f = 10 ** src.scale
    if not dt.is_d128(src):
        # |v| < 10^18: abs cannot wrap
        v = xp.astype(c.values, xp.int64)
        q = xp.floor_divide(xp.abs(v), f)
        whole = xp.where(v < 0, -q, q)
    elif ctx.is_device:
        from .decimal128 import d128_trunc_low64
        whole = d128_trunc_low64(c.values, src.scale)
    else:
        whole = np.array([_low64(int(v), f) for v in c.values], np.int64)
    return EvalCol(xp.astype(whole, to.np_dtype()), c.validity, to)


def _low64(v: int, f: int) -> int:
    """``v / f`` truncated toward zero, its low 64 bits as a signed int."""
    q = abs(v) // f
    return ((-q if v < 0 else q) + 2**63) % 2**64 - 2**63


def _cast_to_decimal(ctx, c: EvalCol, src: dt.DataType,
                     to: dt.DecimalType) -> EvalCol:
    """integral, boolean or float -> decimal: times 10^s (floats rounded
    half to even), null past the precision or from a NaN or infinity."""
    xp = ctx.xp
    from_float = src in (dt.FLOAT, dt.DOUBLE)
    if not ctx.is_device:
        py, bad = [], []
        for v in c.values:
            if from_float:
                f = float(v)
                if not math.isfinite(f):
                    py.append(0)
                    bad.append(True)
                    continue
                u = int(np.round(f * 10.0 ** to.scale))
            else:
                u = int(v) * 10 ** to.scale
            over = abs(u) >= 10 ** to.precision
            py.append(0 if over and not dt.is_d128(to) else u)
            bad.append(over)
        ok = np.logical_not(np.array(bad, dtype=bool))
        vals = obj_array(py) if dt.is_d128(to) \
            else np.array(py, dtype=np.int64)
        return EvalCol(vals, _and_valid(ctx, c.validity, ok), to)
    if from_float:
        f = xp.round(xp.astype(c.values, xp.float64) * 10.0 ** to.scale)
        if dt.is_d128(to):
            from .decimal128 import d128_from_f64, d128_overflows
            limbs, over = d128_from_f64(f)
            over = xp.logical_or(over, d128_overflows(limbs, to.precision))
            return EvalCol(limbs, _and_valid(ctx, c.validity,
                                             xp.logical_not(over)), to)
        over = xp.logical_not(xp.abs(f) < float(10 ** to.precision))
        v = xp.astype(xp.where(over, xp.zeros_like(f), f), xp.int64)
        return EvalCol(v, _and_valid(ctx, c.validity, xp.logical_not(over)),
                       to)
    v = xp.astype(c.values, xp.int64)
    if dt.is_d128(to):
        from .decimal128 import d128_rescale
        limbs, over = d128_rescale(v.contiguous(), 0, to.scale, to.precision)
        return EvalCol(limbs, _and_valid(ctx, c.validity,
                                         xp.logical_not(over)), to)
    f = 10 ** to.scale
    # the overflow test before the multiply: the product could wrap int64
    over = xp.abs(v) >= (10 ** to.precision + f - 1) // f
    return EvalCol(v * f, _and_valid(ctx, c.validity, xp.logical_not(over)),
                   to)


def _cast_decimal_decimal(ctx, c: EvalCol, src: dt.DecimalType,
                          to: dt.DecimalType) -> EvalCol:
    """decimal -> decimal: exact rescale, HALF_UP on a scale reduction,
    overflow -> null (Spark non-ANSI CheckOverflow; GpuCast.scala:1513).
    Crossing the 18-digit boundary switches between scaled int64 and
    two-limb storage."""
    xp = ctx.xp
    src128, to128 = dt.is_d128(src), dt.is_d128(to)
    if ctx.is_device:
        if not src128 and not to128:
            vals = xp.astype(c.values, xp.int64)
            bound = 10 ** to.precision          # p <= 18: fits int64
            if to.scale >= src.scale:
                f = 10 ** (to.scale - src.scale)
                # the overflow test before the multiply (the product
                # could wrap int64 silently)
                over = xp.abs(vals) >= (bound + f - 1) // f
                v = vals * f
            else:
                f = 10 ** (src.scale - to.scale)
                av = xp.abs(vals)
                q = xp.floor_divide(av, f)
                r = av - q * f
                q = q + xp.astype(2 * r >= f, xp.int64)
                v = xp.where(vals < 0, -q, q)
                over = xp.abs(v) >= bound
            return EvalCol(v, _and_valid(ctx, c.validity,
                                         xp.logical_not(over)), to)
        from .decimal128 import d128_rescale, d128_to_i64
        # a decimal64 source goes to the kernel as scaled int64
        out_limbs, over = d128_rescale(c.values.contiguous(), src.scale,
                                       to.scale, to.precision)
        if to128:
            return EvalCol(out_limbs, _and_valid(ctx, c.validity,
                                                 xp.logical_not(over)), to)
        v64, over2 = d128_to_i64(out_limbs)
        over = xp.logical_or(over, over2)
        return EvalCol(v64, _and_valid(ctx, c.validity,
                                       xp.logical_not(over)), to)
    # host engine: exact Python-int arithmetic (object arrays when wide)
    py = [rescale_py_half_up(int(v), src.scale, to.scale) for v in c.values]
    over = np.array([abs(v) >= 10 ** to.precision for v in py], dtype=bool)
    if to128:
        vals = obj_array(py)
    else:
        vals = np.array([0 if o else v for v, o in zip(py, over)],
                        dtype=np.int64)
    return EvalCol(vals, _and_valid(ctx, c.validity, np.logical_not(over)),
                   to)
