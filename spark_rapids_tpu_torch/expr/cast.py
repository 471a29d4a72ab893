"""Cast expression — the port of ``spark_rapids_tpu/expr/cast.py``.

Strings: on the device, integral, boolean, date and decimal64 values
format into the byte matrix and strings parse to integral, float, boolean
and date values through the ``str_format`` and ``str_parse`` kernels
(``expr/cast_kernels.py``); the plan keeps the other directions on the host
engine (float and timestamp to string, string to timestamp and decimal, a
wide decimal to string), as the JAX package's ``tag_cast`` does. The host
engine's parse and format helpers below keep the kernels' rules, so that
the two engines agree (but a double: ``float(s)`` rounds correctly, the
device formula does not). Unlike the JAX package, a string parsed to a
decimal past 18 digits keeps its value (the JAX package nulls it past
10^18), and a non-finite or underscored decimal string is null (the JAX
package raises on "NaN" and takes "1_0").

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
from .base import EvalCol, EvalContext, Expression

__all__ = ["Cast", "cast_supported", "device_cast_reason", "obj_array",
           "rescale_py_half_up"]

_STRINGS = (dt.StringType, dt.BinaryType)


def _formattable(src: dt.DataType) -> bool:
    return src.is_numeric or isinstance(src, (dt.BooleanType, dt.DateType,
                                              dt.TimestampType))


def cast_supported(src: dt.DataType, to: dt.DataType) -> bool:
    """Whether this port evaluates the cast ``src -> to`` (either engine)."""
    if src == to or isinstance(src, dt.NullType):
        return True
    if isinstance(src, _STRINGS) and isinstance(to, _STRINGS):
        return True
    if isinstance(to, dt.StringType):
        return _formattable(src)
    if isinstance(src, dt.StringType):
        return _formattable(to)
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


def device_cast_reason(src: dt.DataType, to: dt.DataType):
    """Why the device does not run ``src -> to`` (None: it does): the JAX
    package's ``tag_cast`` (plan/overrides.py:80-107) and the decimal128
    tier's ``cast_ok`` (:945-953), with their reasons."""
    if src == to:
        return None
    if not cast_supported(src, to):
        return f"cast {src!r} -> {to!r} is not ported yet"
    if isinstance(to, _STRINGS):
        if src in (dt.FLOAT, dt.DOUBLE):
            return "float->string (shortest-roundtrip formatting) runs on host"
        if isinstance(src, dt.TimestampType):
            return "timestamp->string runs on host"
        if dt.is_d128(src):
            return "decimal128 -> string formats on the host"
    if isinstance(src, _STRINGS) and not isinstance(to, _STRINGS):
        if isinstance(to, (dt.TimestampType, dt.DecimalType)):
            return f"string -> {to!r} parse runs on host"
    return None


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
        # str_format / str_parse: a value to or from a string; d128_rescale:
        # a decimal to or from a two-limb decimal, and an integral or
        # boolean column to a two-limb decimal
        src, to = self.child.data_type, self.to
        if src != to and isinstance(src, _STRINGS) != isinstance(to, _STRINGS):
            return not isinstance(src, dt.NullType)
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
            raise TypeError(f"cast {src!r} -> {to!r} is not ported yet")
        xp = ctx.xp
        if isinstance(src, _STRINGS) and isinstance(to, _STRINGS):
            return _cast_string_binary(ctx, c, to)
        if isinstance(src, _STRINGS):
            return _cast_from_string(ctx, c, to)
        if isinstance(to, dt.StringType) \
                and not isinstance(src, dt.NullType):
            return _cast_to_string(ctx, c)
        if isinstance(src, dt.NullType):
            n = c.shape0()
            if isinstance(to, _STRINGS):
                return _null_strings(ctx, n, to)
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


# ---------------------------------------------------------------------------
# strings: the device directions on the kernels, the host engine's helpers
# (their rules equal the kernels'; Spark non-ANSI: malformed -> null)
# ---------------------------------------------------------------------------
_WS = " \t\n\r\f\v"
_TRUE_TOKENS = frozenset(("true", "t", "yes", "y", "1"))
_FALSE_TOKENS = frozenset(("false", "f", "no", "n", "0"))


def _null_strings(ctx, n: int, to: dt.DataType) -> EvalCol:
    if ctx.is_device:
        xp = ctx.xp
        return EvalCol(xp.zeros((n, 8), dtype=xp.uint8),
                       xp.zeros(n, dtype=bool), to,
                       xp.zeros(n, dtype=xp.int32))
    vals = np.empty(n, dtype=object)
    vals[:] = "" if isinstance(to, dt.StringType) else b""
    return EvalCol(vals, np.zeros(n, dtype=bool), to)


def _cast_string_binary(ctx, c: EvalCol, to: dt.DataType) -> EvalCol:
    """binary <-> string: the same bytes."""
    if ctx.is_device:
        return EvalCol(c.values, c.validity, to, c.lengths)
    if isinstance(to, dt.BinaryType):
        vals = [v.encode() if isinstance(v, str) else v for v in c.values]
    else:
        vals = [v.decode("utf-8", "replace")
                if isinstance(v, (bytes, bytearray)) else v
                for v in c.values]
    return EvalCol(obj_array(vals), c.validity, to)


def _cast_to_string(ctx, c: EvalCol) -> EvalCol:
    from .cast_kernels import str_format
    src = c.dtype
    if ctx.is_device:
        if isinstance(src, dt.BooleanType):
            data, lengths = str_format(c.values, "bool")
        elif isinstance(src, dt.DateType):
            data, lengths = str_format(c.values, "date")
        elif isinstance(src, dt.DecimalType) and not dt.is_d128(src):
            data, lengths = str_format(c.values, "decimal", src.scale)
        elif src.is_integral:
            data, lengths = str_format(c.values, "long")
        else:
            # float formatting (shortest round trip), timestamps and wide
            # decimals have no kernel: the plan keeps them on the host
            raise TypeError(f"device cast {src!r} -> string unsupported")
        return EvalCol(data, c.validity, dt.STRING, lengths)
    # whole-column numpy where it formats as str() and isoformat() do
    v = c.values
    if isinstance(src, dt.BooleanType):
        vals = np.where(np.asarray(v, dtype=bool), "true", "false")
    elif isinstance(src, dt.DateType):
        vals = np.asarray(v, dtype=np.int64).astype("datetime64[D]") \
            .astype(str)
    elif isinstance(src, dt.TimestampType):
        vals = [_format_timestamp(int(x)) for x in v]
    elif isinstance(src, dt.DecimalType):
        vals = _format_decimals(v, src)
    elif src in (dt.FLOAT, dt.DOUBLE):
        vals = [repr(float(x)) for x in v]
    else:
        vals = np.asarray(v, dtype=np.int64).astype(str)
    return EvalCol(obj_array(vals), c.validity, dt.STRING)


def _cast_from_string(ctx, c: EvalCol, to: dt.DataType) -> EvalCol:
    if ctx.is_device:
        from .cast_kernels import str_parse
        xp = ctx.xp
        if isinstance(to, dt.BooleanType):
            vals, ok = str_parse(c.values, c.lengths, "bool")
        elif isinstance(to, dt.DateType):
            vals, ok = str_parse(c.values, c.lengths, "date")
        elif to in (dt.FLOAT, dt.DOUBLE):
            vals, ok = str_parse(c.values, c.lengths, "double")
            vals = xp.astype(vals, to.np_dtype())
            if to == dt.FLOAT:
                # flushed to a signed zero below float32's least normal,
                # as the JAX package's XLA:CPU does
                vals = xp.where(xp.abs(vals) < 1.1754943508222875e-38,
                                vals * 0, vals)
        elif to.is_integral:
            vals, ok = str_parse(c.values, c.lengths, "long")
            if to != dt.LONG:
                info = np.iinfo(to.np_dtype())
                ok = xp.logical_and(ok, xp.logical_and(vals >= int(info.min),
                                                       vals <= int(info.max)))
                vals = xp.astype(vals, to.np_dtype())
        else:
            raise TypeError(f"device cast string -> {to!r} unsupported")
        return EvalCol(vals, _and_valid(ctx, c.validity, ok), to)
    # each distinct string parsed once
    memo: dict = {}
    one = _py_parse
    if to.is_integral:
        info = np.iinfo(to.np_dtype())
        lo, hi = int(info.min), int(info.max)

        def one(s, to):
            return _py_parse_integral(s.strip(_WS), lo, hi)

    def parse(s):
        if not isinstance(s, str):
            return None
        v = memo.get(s, memo)
        if v is memo:
            v = memo[s] = one(s, to)
        return v
    res = [parse(s) for s in c.values]
    ok = np.fromiter((r is not None for r in res), dtype=bool,
                     count=len(res))
    if c.validity is not None:
        ok &= np.asarray(c.validity, dtype=bool)
    zeros = [0 if r is None else r for r in res]
    out = obj_array(zeros) if dt.is_d128(to) \
        else np.array(zeros, dtype=to.np_dtype())
    return EvalCol(out, ok, to)


def _format_decimals(values, src: dt.DecimalType):
    """The decimal strings of a column's unscaled values; a decimal64 column
    as whole-column numpy."""
    if dt.is_d128(src) or src.scale <= 0:
        return [_format_decimal(int(v), src.scale) for v in values]
    v = np.asarray(values, dtype=np.int64)
    f = 10 ** src.scale
    mag = np.abs(v)      # |v| < 10^18: abs cannot wrap
    whole = (mag // f).astype(str)
    frac = np.char.zfill((mag % f).astype(str), src.scale)
    text = np.char.add(np.char.add(whole, "."), frac)
    return np.where(v < 0, np.char.add("-", text), text)


def _format_decimal(unscaled: int, scale: int) -> str:
    if scale <= 0:
        return str(unscaled)
    sign = "-" if unscaled < 0 else ""
    digits = str(abs(unscaled)).rjust(scale + 1, "0")
    return f"{sign}{digits[:-scale]}.{digits[-scale:]}"


def _format_timestamp(micros: int) -> str:
    import datetime
    ts = datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=micros)
    base = ts.strftime("%Y-%m-%d %H:%M:%S")
    if ts.microsecond:
        return base + f".{ts.microsecond:06d}".rstrip("0")
    return base


def _py_parse(s: str, to: dt.DataType):
    s = s.strip(_WS)
    if not s:
        return None
    if isinstance(to, dt.BooleanType):
        low = s.lower()
        if low in _TRUE_TOKENS:
            return True
        if low in _FALSE_TOKENS:
            return False
        return None
    if isinstance(to, dt.DateType):
        return _py_parse_date(s)
    if isinstance(to, dt.TimestampType):
        return _py_parse_timestamp(s)
    if to in (dt.FLOAT, dt.DOUBLE):
        if "_" in s:           # Python's float() takes underscores; Spark not
            return None
        low = s.lower()
        if low == "nan":
            return float("nan")
        try:
            v = float(s)
        except ValueError:
            return None
        # Python takes '-nan'; Spark only an unsigned NaN
        if v != v:
            return None
        return np.float32(v) if to == dt.FLOAT else v
    if isinstance(to, dt.DecimalType):
        return _py_parse_decimal(s, to)
    info = np.iinfo(to.np_dtype())
    return _py_parse_integral(s, int(info.min), int(info.max))


def _py_parse_integral(s: str, lo: int, hi: int):
    """[+-]digits[.digits] of a trimmed string, the fraction truncated;
    null when malformed or outside [lo, hi]."""
    if not s:
        return None
    sign = 1
    body = s
    if body[0] in "+-":
        sign = -1 if body[0] == "-" else 1
        body = body[1:]
    ip, point, fp = body.partition(".")
    if not ip.isdigit() or (point and fp and not fp.isdigit()):
        return None
    if not ip.isascii() or (fp and not fp.isascii()):
        return None
    v = sign * int(ip)
    return v if lo <= v <= hi else None


def _py_parse_decimal(s: str, to: dt.DecimalType):
    """The unscaled value, HALF_UP at the target scale; null past the
    precision, for a non-finite value or an underscore."""
    import decimal
    if "_" in s:
        return None
    try:
        d = decimal.Decimal(s)
    except decimal.InvalidOperation:
        return None
    if not d.is_finite():
        return None
    ctx = decimal.Context(prec=100, Emax=999, Emin=-999)
    scaled = int(d.scaleb(to.scale, context=ctx).to_integral_value(
        rounding=decimal.ROUND_HALF_UP))
    if abs(scaled) >= 10 ** to.precision:
        return None
    return scaled


def _py_parse_date(s: str):
    parts = s.split("-")
    # a leading '-' (a negative year) leaves parts[0] empty: rejected
    if not 1 <= len(parts) <= 3 or not all(parts):
        return None
    if not all(p.isdigit() and p.isascii() for p in parts):
        return None
    if len(parts[0]) != 4:
        return None
    y = int(parts[0])
    m = int(parts[1]) if len(parts) > 1 else 1
    d = int(parts[2]) if len(parts) > 2 else 1
    if len(parts) > 1 and len(parts[1]) > 2:
        return None
    if len(parts) > 2 and len(parts[2]) > 2:
        return None
    import datetime
    try:
        return datetime.date(y, m, d).toordinal() - 719163
    except ValueError:
        return None


def _py_parse_timestamp(s: str):
    import datetime
    for sep in (" ", "T"):
        if sep in s:
            ds, _, ts = s.partition(sep)
            days = _py_parse_date(ds)
            if days is None:
                return None
            try:
                t = datetime.time.fromisoformat(ts)
            except ValueError:
                return None
            micros = ((t.hour * 60 + t.minute) * 60 + t.second) * 1_000_000 \
                + t.microsecond
            if t.tzinfo is not None:
                # a zone offset shifts to UTC (Spark's behaviour)
                micros -= int(t.utcoffset().total_seconds() * 1_000_000)
            return days * 86_400_000_000 + micros
    days = _py_parse_date(s)
    if days is None:
        return None
    return days * 86_400_000_000
