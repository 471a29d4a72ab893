"""Data types and the TypeSig capability algebra.

The port's copy of ``spark_rapids_tpu/columnar/dtypes.py``, cut down to the
flat types the engine carries: the fixed-width types (booleans, integers,
floats, dates, timestamps), strings as a byte matrix, and decimals. Nested
types are not ported yet (ROADMAP Queue 1: breadth).

Device mapping (torch tensors, one per plane):
  - integers map to int8/16/32/64, floats to float32/64, BOOLEAN to bool
  - DATE is days-since-epoch int32; TIMESTAMP is micros-since-epoch int64
  - DECIMAL(p<=18, s) is the scaled value as int64; DECIMAL(19..38, s) is a
    ``(capacity, 2)`` int64 plane of limbs ``[hi, lo]``, the value being
    ``hi * 2**64 + uint64(lo)`` (expr/decimal128.py). On the host, the
    wider tier is an object array of Python ints.
"""
from __future__ import annotations

import re
from typing import Iterable

import dataclasses

import numpy as np

__all__ = [
    "DataType", "IntegralType", "FractionalType",
    "BooleanType", "ByteType", "ShortType", "IntegerType", "LongType",
    "FloatType", "DoubleType", "StringType", "BinaryType", "DateType",
    "TimestampType", "NullType", "DecimalType", "is_d128",
    "BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE", "STRING",
    "BINARY", "DATE", "TIMESTAMP", "NULL",
    "TypeSig", "TypeEnum", "from_simple_name", "ArrayType",
]


class DataType:
    """Base class for SQL-level data types (reference: Spark's DataType)."""

    #: short name used in TypeSig docs / explain output
    simple_name: str = "?"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return self.simple_name

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (IntegralType, FractionalType, DecimalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    def np_dtype(self) -> np.dtype:
        """The numpy dtype of the value plane (host array / device tensor)."""
        raise NotImplementedError(self.simple_name)


class IntegralType(DataType):
    pass


class FractionalType(DataType):
    pass


def _fixed(name: str, base: type, simple_name: str, np_type) -> type:
    """A fixed-width type: one value plane of ``np_type``."""
    return type(name, (base,), {"simple_name": simple_name,
                                "np_dtype": lambda self: np.dtype(np_type)})


BooleanType = _fixed("BooleanType", DataType, "boolean", np.bool_)
ByteType = _fixed("ByteType", IntegralType, "tinyint", np.int8)
ShortType = _fixed("ShortType", IntegralType, "smallint", np.int16)
IntegerType = _fixed("IntegerType", IntegralType, "int", np.int32)
LongType = _fixed("LongType", IntegralType, "bigint", np.int64)
FloatType = _fixed("FloatType", FractionalType, "float", np.float32)
DoubleType = _fixed("DoubleType", FractionalType, "double", np.float64)
#: days since unix epoch (int32), like Arrow date32
DateType = _fixed("DateType", DataType, "date", np.int32)
#: microseconds since unix epoch (int64), like Spark/Arrow timestamp[us]
TimestampType = _fixed("TimestampType", DataType, "timestamp", np.int64)
NullType = _fixed("NullType", DataType, "null", np.int8)


class StringType(DataType):
    simple_name = "string"


class BinaryType(DataType):
    simple_name = "binary"


@dataclasses.dataclass(frozen=True, eq=True)
class DecimalType(DataType):
    """DECIMAL(precision, scale): scaled int64 up to 18 digits, two int64
    limbs beyond (the value plane's numpy dtype is int64 in both tiers, as
    in the JAX package)."""
    precision: int = 10
    scale: int = 0

    MAX_INT64_PRECISION = 18
    MAX_PRECISION_128 = 38

    def __post_init__(self):
        if not 1 <= self.precision <= 38:
            raise ValueError(f"bad decimal precision {self.precision}")
        if not 0 <= self.scale <= self.precision:
            raise ValueError(f"bad decimal scale {self.scale}")

    @property
    def simple_name(self):  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    def np_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __repr__(self):
        return self.simple_name


@dataclasses.dataclass(frozen=True, eq=True)
class ArrayType(DataType):
    """ARRAY<element>: on the host engine a column of Python lists. Only
    ``approx_percentile``'s sketch state and list result use it: the device
    has no array layout yet (ROADMAP Queue 1, collections)."""
    element: DataType = None
    contains_null: bool = True

    @property
    def simple_name(self):  # type: ignore[override]
        return f"array<{self.element.simple_name}>"

    def np_dtype(self) -> np.dtype:
        return np.dtype(object)

    def __repr__(self):
        return self.simple_name


def is_d128(t: DataType) -> bool:
    """True for decimals stored as two int64 limbs on the device (precision
    beyond the scaled-int64 tier)."""
    return isinstance(t, DecimalType) \
        and t.precision > DecimalType.MAX_INT64_PRECISION


# Singletons
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

_BY_NAME = {t.simple_name: t for t in (BOOLEAN, BYTE, SHORT, INT, LONG,
                                       FLOAT, DOUBLE, STRING, BINARY, DATE,
                                       TIMESTAMP, NULL)}


def from_simple_name(name: str) -> DataType:
    """``repr`` of a type (its simple name, e.g. ``"double"``) -> the type.
    Lets batches cross from another engine by name (columnar/interop.py)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        pass
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", name)
    if m:
        return DecimalType(int(m.group(1)), int(m.group(2)))
    raise TypeError(f"data type {name!r} is not ported yet")


class TypeEnum:
    """Canonical names for TypeSig membership (reference TypeEnum in TypeChecks.scala)."""
    BOOLEAN = "BOOLEAN"
    BYTE = "BYTE"
    SHORT = "SHORT"
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    STRING = "STRING"
    BINARY = "BINARY"
    DATE = "DATE"
    TIMESTAMP = "TIMESTAMP"
    NULL = "NULL"
    DECIMAL = "DECIMAL"
    ARRAY = "ARRAY"


def _enum_of(d: DataType) -> str:
    for enum, cls in ((TypeEnum.BOOLEAN, BooleanType),
                      (TypeEnum.BYTE, ByteType), (TypeEnum.SHORT, ShortType),
                      (TypeEnum.INT, IntegerType), (TypeEnum.LONG, LongType),
                      (TypeEnum.FLOAT, FloatType),
                      (TypeEnum.DOUBLE, DoubleType),
                      (TypeEnum.STRING, StringType),
                      (TypeEnum.BINARY, BinaryType),
                      (TypeEnum.DATE, DateType),
                      (TypeEnum.TIMESTAMP, TimestampType),
                      (TypeEnum.NULL, NullType),
                      (TypeEnum.DECIMAL, DecimalType),
                      (TypeEnum.ARRAY, ArrayType)):
        if isinstance(d, cls):
            return enum
    raise TypeError(f"unknown data type {d!r}")


class TypeSig:
    """Immutable set of supported types, with the widest decimal precision
    it admits.

    Mirrors the algebra of the reference's ``TypeSig`` (TypeChecks.scala:166):
    ``+`` union, ``-`` removal, and ``is_supported``/``reasons_not_supported``
    used at tag time. Decimals pass up to 18 digits unless a rule raises the
    gate to 38 with ``with_decimal128`` (the DECIMAL_128 tier).
    """

    __slots__ = ("_types", "_max_decimal_precision", "_notes")

    def __init__(self, types: Iterable[str] = (),
                 max_decimal_precision: int =
                 DecimalType.MAX_INT64_PRECISION, notes=None):
        self._types = frozenset(types)
        self._max_decimal_precision = max_decimal_precision
        #: a note on how a supported type runs (the reference's ps-note)
        self._notes = dict(notes or {})

    @staticmethod
    def of(*enums: str) -> "TypeSig":
        return TypeSig(enums)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self._types | other._types,
                       max(self._max_decimal_precision,
                           other._max_decimal_precision),
                       {**self._notes, **other._notes})

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self._types - other._types,
                       self._max_decimal_precision,
                       {k: v for k, v in self._notes.items()
                        if k not in other._types})

    def with_decimal128(self) -> "TypeSig":
        """The same types with the decimal gate raised to 38 digits: the
        ops whose device code takes two-limb columns opt in per rule."""
        return TypeSig(self._types, DecimalType.MAX_PRECISION_128,
                       self._notes)

    def with_ps_note(self, type_enum: str, note: str) -> "TypeSig":
        """The type supported, with a note on how (e.g. ASCII-only)."""
        return TypeSig(self._types | {type_enum},
                       self._max_decimal_precision,
                       {**self._notes, type_enum: note})

    def is_supported(self, d: DataType) -> bool:
        return not self.reasons_not_supported(d)

    def reasons_not_supported(self, d: DataType) -> list:
        if _enum_of(d) not in self._types:
            return [f"{d!r} is not ported to the device yet"]
        if isinstance(d, DecimalType) \
                and d.precision > self._max_decimal_precision:
            return [f"{d!r} exceeds max supported decimal precision "
                    f"{self._max_decimal_precision}"]
        return []

    def describe(self) -> str:
        return ", ".join(f"{t} ({self._notes[t]})" if t in self._notes
                         else t for t in sorted(self._types))

    def __contains__(self, d: DataType) -> bool:
        return self.is_supported(d)

    def __repr__(self):
        return f"TypeSig({self.describe()})"


# Common signatures (named after the reference's, TypeChecks.scala:400-523)
TypeSig.integral = TypeSig.of(TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                              TypeEnum.LONG)
TypeSig.fp = TypeSig.of(TypeEnum.FLOAT, TypeEnum.DOUBLE)
TypeSig.numeric = TypeSig.integral + TypeSig.fp + TypeSig.of(TypeEnum.DECIMAL)
