"""Data types and the TypeSig capability algebra.

The port's copy of ``spark_rapids_tpu/columnar/dtypes.py``, cut down to the
flat types the engine carries: the device-supported ones are the fixed-width
types (booleans, integers, floats, dates, timestamps). Strings ride the host
engine only; decimals and nested types are not ported yet (ROADMAP Queue 1).

Device mapping (torch tensors, one per plane):
  - integers map to int8/16/32/64, floats to float32/64, BOOLEAN to bool
  - DATE is days-since-epoch int32; TIMESTAMP is micros-since-epoch int64
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

__all__ = [
    "DataType", "IntegralType", "FractionalType",
    "BooleanType", "ByteType", "ShortType", "IntegerType", "LongType",
    "FloatType", "DoubleType", "StringType", "BinaryType", "DateType",
    "TimestampType", "NullType",
    "BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE", "STRING",
    "BINARY", "DATE", "TIMESTAMP", "NULL",
    "TypeSig", "TypeEnum", "from_simple_name",
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
        return isinstance(self, (IntegralType, FractionalType))

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
        raise TypeError(f"data type {name!r} is not ported yet") from None


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
                      (TypeEnum.NULL, NullType)):
        if isinstance(d, cls):
            return enum
    raise TypeError(f"unknown data type {d!r}")


class TypeSig:
    """Immutable set of supported types.

    Mirrors the algebra of the reference's ``TypeSig`` (TypeChecks.scala:166):
    ``+`` union, ``-`` removal, and ``is_supported``/``reasons_not_supported``
    used at tag time.
    """

    __slots__ = ("_types",)

    def __init__(self, types: Iterable[str] = ()):
        self._types = frozenset(types)

    @staticmethod
    def of(*enums: str) -> "TypeSig":
        return TypeSig(enums)

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self._types | other._types)

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self._types - other._types)

    def is_supported(self, d: DataType) -> bool:
        return not self.reasons_not_supported(d)

    def reasons_not_supported(self, d: DataType) -> list:
        if _enum_of(d) not in self._types:
            return [f"{d!r} is not ported to the device yet"]
        return []

    def describe(self) -> str:
        return ", ".join(sorted(self._types))

    def __contains__(self, d: DataType) -> bool:
        return self.is_supported(d)

    def __repr__(self):
        return f"TypeSig({self.describe()})"


# Common signatures (named after the reference's, TypeChecks.scala:400-523)
TypeSig.integral = TypeSig.of(TypeEnum.BYTE, TypeEnum.SHORT, TypeEnum.INT,
                              TypeEnum.LONG)
TypeSig.fp = TypeSig.of(TypeEnum.FLOAT, TypeEnum.DOUBLE)
TypeSig.numeric = TypeSig.integral + TypeSig.fp
