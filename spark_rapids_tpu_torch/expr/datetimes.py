"""Date and time expressions — the port of
``spark_rapids_tpu/expr/datetimes.py`` (reference:
datetimeExpressions.scala).

All civil-calendar math is branch-free integer arithmetic (Hinnant's
algorithms) written once against an array namespace ``xp``: numpy on the
host engine, torch on the device, a handful of whole-column ops per part.
Both floor-divide, so days before 1970 land in the right year.

Timezone: UTC only, like the reference. Representation: DATE = int32 days
since the epoch; TIMESTAMP = int64 microseconds. ``from_unixtime`` and
``date_format`` format strings and run on the host engine only, as in the
JAX package.
"""
from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from .arithmetic import _combine_validity
from .base import EvalCol, EvalContext, Expression

__all__ = ["Year", "Month", "DayOfMonth", "DayOfWeek", "WeekDay",
           "DayOfYear", "WeekOfYear", "Quarter", "Hour", "Minute", "Second",
           "DateAdd", "DateSub", "DateDiff", "AddMonths", "LastDay",
           "MonthsBetween", "UnixTimestamp", "FromUnixTime",
           "DateFormatClass", "TruncDate", "TimeAdd", "civil_from_days",
           "days_from_civil"]

_US_PER_DAY = 86_400_000_000
_US_PER_SEC = 1_000_000


def civil_from_days(xp, z):
    """days-since-epoch -> (year, month, day). Hinnant civil_from_days."""
    z = xp.astype(z, xp.int64) + 719468
    era = xp.floor_divide(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = xp.floor_divide(
        doe - xp.floor_divide(doe, 1460) + xp.floor_divide(doe, 36524)
        - xp.floor_divide(doe, 146096), 365)                 # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + xp.floor_divide(yoe, 4)
                 - xp.floor_divide(yoe, 100))                # [0, 365]
    mp = xp.floor_divide(5 * doy + 2, 153)                   # [0, 11]
    d = doy - xp.floor_divide(153 * mp + 2, 5) + 1           # [1, 31]
    m = mp + xp.where(mp < 10, 3, -9)                        # [1, 12]
    y = y + xp.astype(m <= 2, xp.int64)
    return (xp.astype(y, xp.int32), xp.astype(m, xp.int32),
            xp.astype(d, xp.int32))


def days_from_civil(xp, y, m, d):
    """(year, month, day) -> days-since-epoch. Hinnant days_from_civil."""
    y = xp.astype(y, xp.int64) - xp.astype(m <= 2, xp.int64)
    era = xp.floor_divide(y, 400)
    yoe = y - era * 400
    mp = (xp.astype(m, xp.int64) + 9) % 12
    doy = xp.floor_divide(153 * mp + 2, 5) + xp.astype(d, xp.int64) - 1
    doe = yoe * 365 + xp.floor_divide(yoe, 4) - xp.floor_divide(yoe, 100) + doy
    return xp.astype(era * 146097 + doe - 719468, xp.int32)


def _days_in_month(xp, y, m):
    lengths = xp.asarray(
        np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                 dtype=np.int32))
    leap = xp.logical_and(y % 4 == 0,
                          xp.logical_or(y % 100 != 0, y % 400 == 0))
    base = lengths[xp.astype(m, xp.int64) - 1]
    return xp.astype(xp.where(xp.logical_and(m == 2, leap), 29, base),
                     xp.int32)


def _to_days(ctx, c: EvalCol):
    """DATE or TIMESTAMP EvalCol -> int32 days."""
    xp = ctx.xp
    if isinstance(c.dtype, dt.TimestampType):
        return xp.astype(xp.floor_divide(c.values, _US_PER_DAY), xp.int32)
    return xp.astype(c.values, xp.int32)


class ExtractDatePart(Expression):
    """Base: one int field out of a DATE/TIMESTAMP column."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.INT

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        vals = self._compute(ctx, c)
        return EvalCol(ctx.xp.astype(vals, ctx.xp.int32), c.validity, dt.INT)

    def _compute(self, ctx, c: EvalCol):
        raise NotImplementedError


class Year(ExtractDatePart):
    def _compute(self, ctx, c):
        y, _, _ = civil_from_days(ctx.xp, _to_days(ctx, c))
        return y


class Month(ExtractDatePart):
    def _compute(self, ctx, c):
        _, m, _ = civil_from_days(ctx.xp, _to_days(ctx, c))
        return m


class DayOfMonth(ExtractDatePart):
    def _compute(self, ctx, c):
        _, _, d = civil_from_days(ctx.xp, _to_days(ctx, c))
        return d


class DayOfWeek(ExtractDatePart):
    """1 = Sunday ... 7 = Saturday (Spark semantics)."""

    def _compute(self, ctx, c):
        days = ctx.xp.astype(_to_days(ctx, c), ctx.xp.int64)
        return ((days + 4) % 7) + 1


class WeekDay(ExtractDatePart):
    """0 = Monday ... 6 = Sunday."""

    def _compute(self, ctx, c):
        days = ctx.xp.astype(_to_days(ctx, c), ctx.xp.int64)
        return (days + 3) % 7


class DayOfYear(ExtractDatePart):
    def _compute(self, ctx, c):
        xp = ctx.xp
        days = _to_days(ctx, c)
        y, _, _ = civil_from_days(xp, days)
        jan1 = days_from_civil(xp, y, xp.full_like(y, 1), xp.full_like(y, 1))
        return days - jan1 + 1


class WeekOfYear(ExtractDatePart):
    """ISO-8601 week number (Spark semantics)."""

    def _compute(self, ctx, c):
        xp = ctx.xp
        days = xp.astype(_to_days(ctx, c), xp.int64)
        # the Thursday of this date's ISO week determines the ISO year
        thursday = days - ((days + 3) % 7) + 3
        iso_y, _, _ = civil_from_days(xp, thursday)
        jan1 = xp.astype(days_from_civil(xp, iso_y, xp.full_like(iso_y, 1),
                                         xp.full_like(iso_y, 1)), xp.int64)
        return xp.floor_divide(thursday - jan1, 7) + 1


class Quarter(ExtractDatePart):
    def _compute(self, ctx, c):
        _, m, _ = civil_from_days(ctx.xp, _to_days(ctx, c))
        return ctx.xp.floor_divide(m + 2, 3)


class TimePart(ExtractDatePart):
    divisor = 1
    modulus = 1

    def _compute(self, ctx, c):
        xp = ctx.xp
        us = xp.astype(c.values, xp.int64)
        us_in_day = us - xp.floor_divide(us, _US_PER_DAY) * _US_PER_DAY
        return xp.floor_divide(us_in_day, self.divisor) % self.modulus


class Hour(TimePart):
    divisor = 3_600_000_000
    modulus = 24


class Minute(TimePart):
    divisor = 60_000_000
    modulus = 60


class Second(TimePart):
    divisor = _US_PER_SEC
    modulus = 60


# ---------------------------------------------------------------------------
# date arithmetic
# ---------------------------------------------------------------------------
class DateAdd(Expression):
    sign = 1

    def __init__(self, start: Expression, days: Expression):
        self.start, self.days = start, days
        self.children = (start, days)

    @property
    def data_type(self):
        return dt.DATE

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        s = self.start.eval(ctx)
        d = self.days.eval(ctx)
        vals = xp.astype(s.values, xp.int32) \
            + self.sign * xp.astype(d.values, xp.int32)
        return EvalCol(xp.astype(vals, xp.int32), _combine_validity(ctx, s, d),
                       dt.DATE)


class DateSub(DateAdd):
    sign = -1


class DateDiff(Expression):
    def __init__(self, end: Expression, start: Expression):
        self.end, self.start = end, start
        self.children = (end, start)

    @property
    def data_type(self):
        return dt.INT

    def eval(self, ctx: EvalContext) -> EvalCol:
        e = self.end.eval(ctx)
        s = self.start.eval(ctx)
        vals = _to_days(ctx, e) - _to_days(ctx, s)
        return EvalCol(ctx.xp.astype(vals, ctx.xp.int32),
                       _combine_validity(ctx, e, s), dt.INT)


class AddMonths(Expression):
    def __init__(self, start: Expression, months: Expression):
        self.start, self.months = start, months
        self.children = (start, months)

    @property
    def data_type(self):
        return dt.DATE

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        s = self.start.eval(ctx)
        mo = self.months.eval(ctx)
        y, m, d = civil_from_days(xp, _to_days(ctx, s))
        total = xp.astype(y, xp.int64) * 12 + xp.astype(m - 1, xp.int64) \
            + xp.astype(mo.values, xp.int64)
        ny = xp.astype(xp.floor_divide(total, 12), xp.int32)
        nm = xp.astype(total % 12, xp.int32) + 1
        nd = xp.minimum(d, _days_in_month(xp, ny, nm))
        return EvalCol(days_from_civil(xp, ny, nm, nd),
                       _combine_validity(ctx, s, mo), dt.DATE)


class LastDay(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.DATE

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        c = self.child.eval(ctx)
        y, m, _ = civil_from_days(xp, _to_days(ctx, c))
        d = _days_in_month(xp, y, m)
        return EvalCol(days_from_civil(xp, y, m, d), c.validity, dt.DATE)


class MonthsBetween(Expression):
    """months_between(end, start[, roundOff]) — Spark's formula, rounded to
    8 digits."""

    def __init__(self, end: Expression, start: Expression, round_off=True):
        self.end, self.start, self.round_off = end, start, round_off
        self.children = (end, start)

    def with_children(self, children):
        return MonthsBetween(children[0], children[1], self.round_off)

    @property
    def data_type(self):
        return dt.DOUBLE

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        e = self.end.eval(ctx)
        s = self.start.eval(ctx)
        dy_e = _to_days(ctx, e)
        dy_s = _to_days(ctx, s)
        y1, m1, d1 = civil_from_days(xp, dy_e)
        y2, m2, d2 = civil_from_days(xp, dy_s)
        f64 = xp.float64
        months = (xp.astype(y1, f64) - xp.astype(y2, f64)) * 12 \
            + xp.astype(m1 - m2, f64)
        both_last = xp.logical_and(d1 == _days_in_month(xp, y1, m1),
                                   d2 == _days_in_month(xp, y2, m2))

        def time_frac(col, days):
            if isinstance(col.dtype, dt.TimestampType):
                us = xp.astype(col.values, f64) \
                    - xp.astype(days, f64) * _US_PER_DAY
                return us / _US_PER_SEC
            return xp.zeros(days.shape[0], dtype=f64)

        sec1 = xp.astype(d1, f64) * 86400 + time_frac(e, dy_e)
        sec2 = xp.astype(d2, f64) * 86400 + time_frac(s, dy_s)
        frac = (sec1 - sec2) / (31.0 * 86400)
        # the same day of month (time ignored), or both last of their
        # month: whole months
        out = xp.where(xp.logical_or(both_last, d1 == d2), months,
                       months + frac)
        if self.round_off:
            out = xp.round(out * 1e8) / 1e8
        return EvalCol(out, _combine_validity(ctx, e, s), dt.DOUBLE)


class TimeAdd(Expression):
    """timestamp + interval (the interval literal in microseconds)."""

    def __init__(self, start: Expression, interval_us: Expression):
        self.start, self.interval = start, interval_us
        self.children = (start, interval_us)

    @property
    def data_type(self):
        return dt.TIMESTAMP

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        s = self.start.eval(ctx)
        i = self.interval.eval(ctx)
        vals = xp.astype(s.values, xp.int64) + xp.astype(i.values, xp.int64)
        return EvalCol(vals, _combine_validity(ctx, s, i), dt.TIMESTAMP)


class UnixTimestamp(Expression):
    """unix_timestamp(ts) -> seconds since the epoch (the default format)."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.LONG

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        c = self.child.eval(ctx)
        v = xp.astype(c.values, xp.int64)
        secs = v * 86400 if isinstance(c.dtype, dt.DateType) \
            else xp.floor_divide(v, _US_PER_SEC)
        return EvalCol(secs, c.validity, dt.LONG)


_JAVA_TO_STRFTIME = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
    ("mm", "%M"), ("ss", "%S"),
]


def _java_fmt_to_strftime(fmt: str) -> str:
    for j, p in _JAVA_TO_STRFTIME:
        fmt = fmt.replace(j, p)
    return fmt


def _host_strings(out, validity) -> EvalCol:
    vals = np.empty(len(out), dtype=object)
    vals[:] = out
    return EvalCol(vals, validity, dt.STRING)


class FromUnixTime(Expression):
    """from_unixtime(sec, fmt) -> string. Host engine only (formatting)."""

    def __init__(self, sec: Expression, fmt: str = "yyyy-MM-dd HH:mm:ss"):
        self.sec, self.fmt = sec, fmt
        self.children = (sec,)

    def with_children(self, children):
        return FromUnixTime(children[0], self.fmt)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        import datetime as _dt
        c = self.sec.eval(ctx)
        sf = _java_fmt_to_strftime(self.fmt)
        return _host_strings(
            [_dt.datetime.fromtimestamp(int(v), _dt.timezone.utc).strftime(sf)
             for v in c.values], c.validity)


class DateFormatClass(Expression):
    """date_format(ts, fmt) -> string. Host engine only."""

    def __init__(self, child: Expression, fmt: str):
        self.child, self.fmt = child, fmt
        self.children = (child,)

    def with_children(self, children):
        return DateFormatClass(children[0], self.fmt)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        import datetime as _dt
        c = self.child.eval(ctx)
        sf = _java_fmt_to_strftime(self.fmt)
        utc = _dt.timezone.utc
        out = []
        for v in c.values:
            if isinstance(c.dtype, dt.DateType):
                t = _dt.datetime(1970, 1, 1, tzinfo=utc) \
                    + _dt.timedelta(days=int(v))
            else:
                t = _dt.datetime.fromtimestamp(int(v) / 1e6, utc)
            out.append(t.strftime(sf))
        return _host_strings(out, c.validity)


class TruncDate(Expression):
    """trunc(date, 'year'|'month'|'week'|'quarter')."""

    def __init__(self, child: Expression, fmt: str):
        self.child, self.fmt = child, fmt.lower()
        self.children = (child,)

    def with_children(self, children):
        return TruncDate(children[0], self.fmt)

    @property
    def data_type(self):
        return dt.DATE

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        c = self.child.eval(ctx)
        days = _to_days(ctx, c)
        y, m, _ = civil_from_days(xp, days)
        one = xp.full_like(y, 1)
        f = self.fmt
        if f in ("year", "yyyy", "yy"):
            out = days_from_civil(xp, y, one, one)
        elif f in ("month", "mon", "mm"):
            out = days_from_civil(xp, y, m, one)
        elif f == "quarter":
            qm = xp.floor_divide(m - 1, 3) * 3 + 1
            out = days_from_civil(xp, y, qm, one)
        elif f == "week":
            d64 = xp.astype(days, xp.int64)
            out = xp.astype(d64 - (d64 + 3) % 7, xp.int32)
        else:
            raise ValueError(f"unsupported trunc format {self.fmt!r}")
        return EvalCol(out, c.validity, dt.DATE)
