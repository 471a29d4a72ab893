"""Date parts of DATE (and TIMESTAMP) columns — the port of the date32 half
of ``spark_rapids_tpu/expr/datetimes.py`` (reference:
datetimeExpressions.scala).

All civil-calendar math is branch-free integer arithmetic (Hinnant's
algorithms) written once against an array namespace ``xp``: numpy on the
host engine, torch on the device, a handful of whole-column ops per part.
Both floor-divide, so days before 1970 land in the right year.

Timezone: UTC only, like the reference. Representation: DATE = int32 days
since the epoch; TIMESTAMP = int64 microseconds. Timestamp parts (hour,
minute, second) and date arithmetic are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import numpy as np

from ..columnar import dtypes as dt
from .base import EvalCol, EvalContext, Expression

__all__ = ["Year", "Month", "DayOfMonth", "DayOfWeek", "WeekDay",
           "DayOfYear", "WeekOfYear", "Quarter", "civil_from_days",
           "days_from_civil"]

_US_PER_DAY = 86_400_000_000


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
