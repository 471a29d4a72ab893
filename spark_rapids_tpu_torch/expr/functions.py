"""User-facing column DSL, modeled on pyspark.sql.functions / Column — the
port of ``spark_rapids_tpu/expr/functions.py`` for the operators,
aggregates and functions this engine runs.

``col("a") * 2 > lit(3)`` builds an Expression tree consumed by the
DataFrame API (spark_rapids_tpu_torch.session).
"""
from __future__ import annotations

from typing import Any

from ..columnar import dtypes as dt
from . import aggregates as agg
from .arithmetic import (Abs, Add, Divide, IntegralDivide, Multiply,
                         Remainder, Subtract, UnaryMinus)
from .base import Alias, AttributeReference, Expression, Literal
from .cast import Cast
from .conditional import CaseWhen, Coalesce
from .predicates import (And, EqualNullSafe, EqualTo, GreaterThan,
                         GreaterThanOrEqual, In, IsNaN, IsNotNull, IsNull,
                         LessThan, LessThanOrEqual, Not, Or)

__all__ = ["Column", "SortOrder", "col", "lit", "when", "coalesce",
           "sum", "count", "count_star", "min", "max", "avg", "mean", "abs",
           "first", "last", "stddev", "stddev_samp", "stddev_pop",
           "variance", "var_samp", "var_pop", "approx_percentile",
           "sqrt", "exp", "log", "ceil", "floor", "round", "pow",
           "shiftleft", "shiftright", "shiftrightunsigned", "bitwise_not",
           "substring", "upper", "lower", "initcap", "length",
           "octet_length", "bit_length", "ascii", "char", "reverse", "trim",
           "ltrim", "rtrim", "lpad", "rpad", "repeat", "concat", "concat_ws",
           "instr", "locate", "replace", "substring_index", "regexp_extract",
           "regexp_replace", "get_json_object", "year", "month", "dayofmonth", "dayofweek",
           "weekday", "dayofyear", "weekofyear", "quarter", "hour", "minute",
           "second", "date_add", "date_sub", "datediff", "add_months",
           "last_day", "months_between", "unix_timestamp", "from_unixtime",
           "date_format", "trunc", "hash", "xxhash64", "spark_partition_id",
           "monotonically_increasing_id", "scalar_subquery"]


class Column:
    """Wrapper giving Expressions Python operator sugar."""

    def __init__(self, expr: Expression):
        self.expr = expr

    # arithmetic
    def __add__(self, other):
        return Column(Add(self.expr, _to_expr(other)))

    def __radd__(self, other):
        return Column(Add(_to_expr(other), self.expr))

    def __sub__(self, other):
        return Column(Subtract(self.expr, _to_expr(other)))

    def __rsub__(self, other):
        return Column(Subtract(_to_expr(other), self.expr))

    def __mul__(self, other):
        return Column(Multiply(self.expr, _to_expr(other)))

    def __rmul__(self, other):
        return Column(Multiply(_to_expr(other), self.expr))

    def __truediv__(self, other):
        return Column(Divide(self.expr, _to_expr(other)))

    def __rtruediv__(self, other):
        return Column(Divide(_to_expr(other), self.expr))

    def __mod__(self, other):
        return Column(Remainder(self.expr, _to_expr(other)))

    def __floordiv__(self, other):
        return Column(IntegralDivide(self.expr, _to_expr(other)))

    def __neg__(self):
        return Column(UnaryMinus(self.expr))

    # comparisons
    def __eq__(self, other):  # type: ignore[override]
        return Column(EqualTo(self.expr, _to_expr(other)))

    def __ne__(self, other):  # type: ignore[override]
        return Column(Not(EqualTo(self.expr, _to_expr(other))))

    def __lt__(self, other):
        return Column(LessThan(self.expr, _to_expr(other)))

    def __le__(self, other):
        return Column(LessThanOrEqual(self.expr, _to_expr(other)))

    def __gt__(self, other):
        return Column(GreaterThan(self.expr, _to_expr(other)))

    def __ge__(self, other):
        return Column(GreaterThanOrEqual(self.expr, _to_expr(other)))

    def eq_null_safe(self, other):
        return Column(EqualNullSafe(self.expr, _to_expr(other)))

    # boolean (PySpark convention: &/|/~ are logical)
    def __and__(self, other):
        return Column(And(self.expr, _to_expr(other)))

    def __or__(self, other):
        return Column(Or(self.expr, _to_expr(other)))

    def __invert__(self):
        return Column(Not(self.expr))

    # misc
    def alias(self, name: str) -> "Column":
        return Column(Alias(self.expr, name))

    def cast(self, to: dt.DataType) -> "Column":
        return Column(Cast(self.expr, to))

    def is_null(self) -> "Column":
        return Column(IsNull(self.expr))

    def is_not_null(self) -> "Column":
        return Column(IsNotNull(self.expr))

    def is_nan(self) -> "Column":
        return Column(IsNaN(self.expr))

    def isin(self, *values) -> "Column":
        return Column(In(self.expr, *[_to_expr(v) for v in values]))

    def between(self, low, high) -> "Column":
        return (self >= low) & (self <= high)

    def like(self, pattern: str) -> "Column":
        from .strings import Like
        return Column(Like(self.expr, Literal(pattern)))

    def rlike(self, pattern: str) -> "Column":
        from .strings import RLike
        return Column(RLike(self.expr, Literal(pattern)))

    def contains(self, needle) -> "Column":
        from .strings import Contains
        return Column(Contains(self.expr, _to_expr(needle)))

    def startswith(self, prefix) -> "Column":
        from .strings import StartsWith
        return Column(StartsWith(self.expr, _to_expr(prefix)))

    def endswith(self, suffix) -> "Column":
        from .strings import EndsWith
        return Column(EndsWith(self.expr, _to_expr(suffix)))

    def substr(self, pos, ln) -> "Column":
        from .strings import Substring
        return Column(Substring(self.expr, _to_expr(pos), _to_expr(ln)))

    def asc(self) -> "SortOrder":
        return SortOrder(self.expr, ascending=True)

    def desc(self) -> "SortOrder":
        return SortOrder(self.expr, ascending=False)

    def __repr__(self):
        return f"Column({self.expr!r})"

    __hash__ = None  # type: ignore[assignment]


class SortOrder:
    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: bool = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: nulls first for asc, nulls last for desc
        self.nulls_first = ascending if nulls_first is None else nulls_first


def _to_expr(v: Any) -> Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, Expression):
        return v
    return Literal(v)


def col(name: str) -> Column:
    return Column(AttributeReference(name))


def lit(value: Any) -> Column:
    return Column(Literal(value))


class _When:
    def __init__(self, branches):
        self._branches = branches

    def when(self, cond: Column, value) -> "_When":
        return _When(self._branches + [(_to_expr(cond), _to_expr(value))])

    def otherwise(self, value) -> Column:
        flat = [e for branch in self._branches for e in branch]
        flat.append(_to_expr(value))
        return Column(CaseWhen(*flat))

    @property
    def column(self) -> Column:
        return Column(CaseWhen(*[e for branch in self._branches
                                 for e in branch]))


def when(cond: Column, value) -> _When:
    return _When([(_to_expr(cond), _to_expr(value))])


def coalesce(*cols) -> Column:
    return Column(Coalesce(*[_to_expr(c) for c in cols]))


# -- aggregates ----------------------------------------------------------------
def sum(c) -> Column:  # noqa: A001
    return Column(agg.Sum(_to_expr(c)))


def count(c) -> Column:
    return Column(agg.Count(_to_expr(c)))


def count_star() -> Column:
    return Column(agg.CountStar())


def min(c) -> Column:  # noqa: A001
    return Column(agg.Min(_to_expr(c)))


def max(c) -> Column:  # noqa: A001
    return Column(agg.Max(_to_expr(c)))


def avg(c) -> Column:
    return Column(agg.Average(_to_expr(c)))


mean = avg


def first(c, ignore_nulls: bool = True) -> Column:
    return Column(agg.First(_to_expr(c), ignore_nulls))


def last(c, ignore_nulls: bool = True) -> Column:
    return Column(agg.Last(_to_expr(c), ignore_nulls))


def stddev(c) -> Column:
    return Column(agg.StddevSamp(_to_expr(c)))


def stddev_samp(c) -> Column:
    return Column(agg.StddevSamp(_to_expr(c)))


def stddev_pop(c) -> Column:
    return Column(agg.StddevPop(_to_expr(c)))


def variance(c) -> Column:
    return Column(agg.VarianceSamp(_to_expr(c)))


def var_samp(c) -> Column:
    return Column(agg.VarianceSamp(_to_expr(c)))


def var_pop(c) -> Column:
    return Column(agg.VariancePop(_to_expr(c)))


def approx_percentile(c, percentage, accuracy: int = 10000) -> Column:
    """A bounded t-digest sketch honouring ``accuracy`` (at most about
    accuracy / 2 centroids a group); host engine only."""
    return Column(agg.ApproximatePercentile(_to_expr(c), percentage,
                                            accuracy=accuracy))


def abs(c) -> Column:  # noqa: A001
    return Column(Abs(_to_expr(c)))


# -- math ----------------------------------------------------------------------
def sqrt(c) -> Column:
    from .math import Sqrt
    return Column(Sqrt(_to_expr(c)))


def exp(c) -> Column:
    from .math import Exp
    return Column(Exp(_to_expr(c)))


def log(c) -> Column:
    from .math import Log
    return Column(Log(_to_expr(c)))


def ceil(c) -> Column:
    from .math import Ceil
    return Column(Ceil(_to_expr(c)))


def floor(c) -> Column:
    from .math import Floor
    return Column(Floor(_to_expr(c)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    from .math import Round
    return Column(Round(_to_expr(c), Literal(scale)))


def pow(c, p) -> Column:  # noqa: A001
    from .math import Pow
    return Column(Pow(_to_expr(c), _to_expr(p)))


def shiftleft(c, n) -> Column:
    from .arithmetic import ShiftLeft
    return Column(ShiftLeft(_to_expr(c), _to_expr(n)))


def shiftright(c, n) -> Column:
    from .arithmetic import ShiftRight
    return Column(ShiftRight(_to_expr(c), _to_expr(n)))


def shiftrightunsigned(c, n) -> Column:
    from .arithmetic import ShiftRightUnsigned
    return Column(ShiftRightUnsigned(_to_expr(c), _to_expr(n)))


def bitwise_not(c) -> Column:
    from .arithmetic import BitwiseNot
    return Column(BitwiseNot(_to_expr(c)))


# -- strings -------------------------------------------------------------------
def substring(c, pos, ln) -> Column:
    from .strings import Substring
    return Column(Substring(_to_expr(c), _to_expr(pos), _to_expr(ln)))


def upper(c) -> Column:
    from .strings import Upper
    return Column(Upper(_to_expr(c)))


def lower(c) -> Column:
    from .strings import Lower
    return Column(Lower(_to_expr(c)))


def initcap(c) -> Column:
    from .strings import InitCap
    return Column(InitCap(_to_expr(c)))


def length(c) -> Column:
    from .strings import Length
    return Column(Length(_to_expr(c)))


def octet_length(c) -> Column:
    from .strings import OctetLength
    return Column(OctetLength(_to_expr(c)))


def bit_length(c) -> Column:
    from .strings import BitLength
    return Column(BitLength(_to_expr(c)))


def substring_index(c, delim: str, count: int) -> Column:
    from .strings import SubstringIndex
    return Column(SubstringIndex(_to_expr(c), Literal(delim), Literal(count)))


def concat(*cols) -> Column:
    from .strings import Concat
    return Column(Concat(*[_to_expr(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Column:
    from .strings import ConcatWs
    return Column(ConcatWs(Literal(sep), *[_to_expr(c) for c in cols]))


def char(c) -> Column:
    """chr(n) — the character for code n & 0xFF (Spark's `chr`)."""
    from .strings import Chr
    return Column(Chr(_to_expr(c)))


def trim(c) -> Column:
    from .strings import StringTrim
    return Column(StringTrim(_to_expr(c)))


def ltrim(c) -> Column:
    from .strings import StringTrimLeft
    return Column(StringTrimLeft(_to_expr(c)))


def rtrim(c) -> Column:
    from .strings import StringTrimRight
    return Column(StringTrimRight(_to_expr(c)))


def lpad(c, ln: int, pad: str = " ") -> Column:
    from .strings import StringLpad
    return Column(StringLpad(_to_expr(c), Literal(ln), Literal(pad)))


def rpad(c, ln: int, pad: str = " ") -> Column:
    from .strings import StringRpad
    return Column(StringRpad(_to_expr(c), Literal(ln), Literal(pad)))


def repeat(c, n: int) -> Column:
    from .strings import StringRepeat
    return Column(StringRepeat(_to_expr(c), Literal(n)))


def reverse(c) -> Column:
    from .strings import StringReverse
    return Column(StringReverse(_to_expr(c)))


def replace(c, search: str, replacement: str) -> Column:
    from .strings import StringReplace
    return Column(StringReplace(_to_expr(c), Literal(search),
                                Literal(replacement)))


def locate(substr: str, c, pos: int = 1) -> Column:
    from .strings import StringLocate
    return Column(StringLocate(Literal(substr), _to_expr(c), Literal(pos)))


def instr(c, substr: str) -> Column:
    from .strings import StringLocate
    return Column(StringLocate(Literal(substr), _to_expr(c), Literal(1)))


def ascii(c) -> Column:  # noqa: A001
    from .strings import Ascii
    return Column(Ascii(_to_expr(c)))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    from .strings import RegExpExtract
    return Column(RegExpExtract(_to_expr(c), Literal(pattern), Literal(idx)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    from .strings import RegExpReplace
    return Column(RegExpReplace(_to_expr(c), Literal(pattern),
                                Literal(replacement)))


def get_json_object(c, path: str) -> Column:
    """JSONPath extraction over string columns (reference:
    GpuGetJsonObject; the $.field and [index] subset, host engine only)."""
    from .strings import GetJsonObject
    return Column(GetJsonObject(_to_expr(c), Literal(path)))


# -- date parts ----------------------------------------------------------------
def year(c) -> Column:
    from .datetimes import Year
    return Column(Year(_to_expr(c)))


def month(c) -> Column:
    from .datetimes import Month
    return Column(Month(_to_expr(c)))


def dayofmonth(c) -> Column:
    from .datetimes import DayOfMonth
    return Column(DayOfMonth(_to_expr(c)))


def dayofweek(c) -> Column:
    from .datetimes import DayOfWeek
    return Column(DayOfWeek(_to_expr(c)))


def weekday(c) -> Column:
    from .datetimes import WeekDay
    return Column(WeekDay(_to_expr(c)))


def dayofyear(c) -> Column:
    from .datetimes import DayOfYear
    return Column(DayOfYear(_to_expr(c)))


def weekofyear(c) -> Column:
    from .datetimes import WeekOfYear
    return Column(WeekOfYear(_to_expr(c)))


def quarter(c) -> Column:
    from .datetimes import Quarter
    return Column(Quarter(_to_expr(c)))


def hour(c) -> Column:
    from .datetimes import Hour
    return Column(Hour(_to_expr(c)))


def minute(c) -> Column:
    from .datetimes import Minute
    return Column(Minute(_to_expr(c)))


def second(c) -> Column:
    from .datetimes import Second
    return Column(Second(_to_expr(c)))


# -- date arithmetic and formatting --------------------------------------------
def date_add(c, days) -> Column:
    from .datetimes import DateAdd
    return Column(DateAdd(_to_expr(c), _to_expr(days)))


def date_sub(c, days) -> Column:
    from .datetimes import DateSub
    return Column(DateSub(_to_expr(c), _to_expr(days)))


def datediff(end, start) -> Column:
    from .datetimes import DateDiff
    return Column(DateDiff(_to_expr(end), _to_expr(start)))


def add_months(c, months) -> Column:
    from .datetimes import AddMonths
    return Column(AddMonths(_to_expr(c), _to_expr(months)))


def last_day(c) -> Column:
    from .datetimes import LastDay
    return Column(LastDay(_to_expr(c)))


def months_between(end, start, round_off: bool = True) -> Column:
    from .datetimes import MonthsBetween
    return Column(MonthsBetween(_to_expr(end), _to_expr(start), round_off))


def unix_timestamp(c) -> Column:
    from .datetimes import UnixTimestamp
    return Column(UnixTimestamp(_to_expr(c)))


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    from .datetimes import FromUnixTime
    return Column(FromUnixTime(_to_expr(c), fmt))


def date_format(c, fmt: str) -> Column:
    from .datetimes import DateFormatClass
    return Column(DateFormatClass(_to_expr(c), fmt))


def trunc(c, fmt: str) -> Column:
    from .datetimes import TruncDate
    return Column(TruncDate(_to_expr(c), fmt))


# -- hashes and ids ------------------------------------------------------------
def hash(*cols) -> Column:  # noqa: A001
    from .hashing import Murmur3Hash
    return Column(Murmur3Hash(*[_to_expr(c) for c in cols]))


def xxhash64(*cols) -> Column:
    from .hashing import XxHash64
    return Column(XxHash64(*[_to_expr(c) for c in cols]))


def spark_partition_id() -> Column:
    from .hashing import SparkPartitionID
    return Column(SparkPartitionID())


def monotonically_increasing_id() -> Column:
    from .hashing import MonotonicallyIncreasingID
    return Column(MonotonicallyIncreasingID())


# -- subqueries ----------------------------------------------------------------
def scalar_subquery(df) -> Column:
    """One-row one-column subquery, executed before the main query and
    injected as a scalar (reference: GpuScalarSubquery)."""
    from .subquery import ScalarSubquery
    return Column(ScalarSubquery(df.logical))
