"""Host-side columnar batches (the CPU staging layer).

The port's copy of ``spark_rapids_tpu/columnar/host.py``: data sits in host
memory in a layout that uploads to the device without reinterpretation.
Fixed-width types are numpy arrays; strings stay numpy object arrays so the
host engine can compute on them directly. A string column decoded from
Arrow keeps its Arrow array, so the upload encodes the device byte matrix
straight from Arrow's buffers.

Decimals hold their scaled integers: int64 up to 18 digits, an object
array of Python ints beyond (exact host arithmetic). They are read from the
Arrow decimal128 buffer (little-endian 64-bit word pairs) in one pass, not
a ``Decimal`` a row, and a wide column fresh from Arrow keeps its Arrow
array so the upload reads its limbs from that buffer too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa

from . import dtypes as dt

__all__ = ["HostColumn", "HostTable"]


def _arrow_to_dtype(t: pa.DataType) -> dt.DataType:
    for pred, d in ((pa.types.is_boolean, dt.BOOLEAN), (pa.types.is_int8, dt.BYTE),
                    (pa.types.is_int16, dt.SHORT), (pa.types.is_int32, dt.INT),
                    (pa.types.is_int64, dt.LONG), (pa.types.is_float32, dt.FLOAT),
                    (pa.types.is_float64, dt.DOUBLE),
                    (pa.types.is_string, dt.STRING),
                    (pa.types.is_large_string, dt.STRING),
                    (pa.types.is_binary, dt.BINARY),
                    (pa.types.is_large_binary, dt.BINARY),
                    (pa.types.is_date32, dt.DATE),
                    (pa.types.is_timestamp, dt.TIMESTAMP)):
        if pred(t):
            return d
    if pa.types.is_decimal(t):
        return dt.DecimalType(t.precision, t.scale)
    raise TypeError(f"arrow type {t} is not ported yet")


_TO_ARROW = {dt.BOOLEAN: pa.bool_(), dt.BYTE: pa.int8(), dt.SHORT: pa.int16(),
             dt.INT: pa.int32(), dt.LONG: pa.int64(), dt.FLOAT: pa.float32(),
             dt.DOUBLE: pa.float64(), dt.STRING: pa.string(),
             dt.BINARY: pa.binary(), dt.DATE: pa.date32(),
             dt.TIMESTAMP: pa.timestamp("us"), dt.NULL: pa.null()}


def _dtype_to_arrow(d: dt.DataType) -> pa.DataType:
    if isinstance(d, dt.DecimalType):
        return pa.decimal128(d.precision, d.scale)
    if isinstance(d, dt.ArrayType):
        return pa.list_(_dtype_to_arrow(d.element))
    return _TO_ARROW[d]


def decimal_words(arr: pa.Array) -> np.ndarray:
    """A decimal128 Arrow array without nulls -> its ``(n, 2)`` int64
    words ``[lo, hi]`` (the buffer as it lies, little-endian)."""
    n = len(arr)
    buf = arr.buffers()[1]
    if buf is None or not n:
        return np.zeros((n, 2), dtype=np.int64)
    return np.frombuffer(buf, dtype=np.int64, count=2 * (n + arr.offset)) \
        .reshape(-1, 2)[arr.offset:]


def _arrow_decimal_values(arr: pa.Array, d: "dt.DecimalType"):
    """-> (values, the decimal128(38, s) array they came from): the scaled
    ints of a decimal column, nulls as 0 (the JAX package's cast and fill),
    int64 up to 18 digits, an object array of Python ints beyond."""
    ints = arr.cast(pa.decimal128(38, d.scale)).fill_null(0)
    words = decimal_words(ints)
    if not dt.is_d128(d):
        return words[:, 0].copy(), ints
    hi = words[:, 1].astype(object)
    lo = words[:, 0].view(np.uint64).astype(object)
    values = np.empty(len(words), dtype=object)
    values[:] = hi * (1 << 64) + lo
    return values, ints


def _decimal_to_arrow(col: "HostColumn") -> pa.Array:
    """A decimal column -> its Arrow decimal128 array, built from the
    values' 64-bit words (exact at any precision; nulls hold 0)."""
    n = len(col.values)
    valid = col.valid_mask()
    words = np.zeros((n, 2), dtype=np.int64)
    if col.values.dtype == object:
        vals = np.where(valid, col.values, 0)
        words[:, 0] = (vals & 0xFFFFFFFFFFFFFFFF).astype(np.uint64) \
            .view(np.int64)
        words[:, 1] = ((vals >> 64) & 0xFFFFFFFFFFFFFFFF).astype(np.uint64) \
            .view(np.int64)
    else:
        v = np.where(valid, col.values.astype(np.int64), 0)
        words[:, 0] = v
        words[:, 1] = v >> 63
    bitmap = None
    if col.validity is not None:
        bitmap = pa.py_buffer(np.packbits(valid, bitorder="little")
                              .tobytes())
    return pa.Array.from_buffers(_dtype_to_arrow(col.dtype), n,
                                 [bitmap, pa.py_buffer(words.tobytes())])


@dataclasses.dataclass
class HostColumn:
    """One host column: values + optional validity mask (True = present)."""
    dtype: dt.DataType
    values: np.ndarray          # fixed width: typed array; string: object array of str
    validity: Optional[np.ndarray] = None   # bool array, None means all-valid
    #: the Arrow array the values were decoded from (string columns, and
    #: wide decimals as decimal128(38, s) with nulls filled, fresh off a
    #: scan); the upload reads its buffers instead of re-encoding
    arrow: Optional[pa.Array] = dataclasses.field(default=None, repr=False,
                                                  compare=False)

    def __post_init__(self):
        if self.validity is not None and self.validity.dtype != np.bool_:
            self.validity = self.validity.astype(np.bool_)

    def __len__(self) -> int:
        return len(self.values)

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.values), dtype=np.bool_)
        return self.validity

    # -- conversions ---------------------------------------------------------
    @staticmethod
    def from_arrow(arr: pa.ChunkedArray | pa.Array) -> "HostColumn":
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        d = _arrow_to_dtype(arr.type)
        validity = None
        if arr.null_count:
            validity = np.asarray(arr.is_valid())
        if isinstance(d, (dt.StringType, dt.BinaryType)):
            values = arr.to_numpy(zero_copy_only=False).astype(object)
            if validity is not None:
                values[~validity] = "" if isinstance(d, dt.StringType) else b""
            return HostColumn(d, values, validity, arr)
        elif isinstance(d, dt.DecimalType):
            values, ints = _arrow_decimal_values(arr, d)
            return HostColumn(d, values, validity,
                              ints if dt.is_d128(d) else None)
        elif isinstance(d, dt.DateType):
            values = np.asarray(arr.cast(pa.int32()).fill_null(0))
        elif isinstance(d, dt.TimestampType):
            values = np.asarray(
                arr.cast(pa.timestamp("us")).cast(pa.int64()).fill_null(0))
        else:
            fill = False if pa.types.is_boolean(arr.type) else 0
            values = np.asarray(arr.fill_null(fill))
            if values.dtype != d.np_dtype():
                values = values.astype(d.np_dtype())
        return HostColumn(d, values, validity)

    def to_arrow(self) -> pa.Array:
        at = _dtype_to_arrow(self.dtype)
        mask = None if self.validity is None else ~self.validity
        if isinstance(self.dtype, (dt.StringType, dt.BinaryType,
                                   dt.ArrayType)):
            vals = list(self.values)
            if mask is not None:
                vals = [None if m else v for v, m in zip(vals, mask)]
            return pa.array(vals, type=at)
        if isinstance(self.dtype, dt.DecimalType):
            return _decimal_to_arrow(self)
        if isinstance(self.dtype, dt.DateType):
            return pa.array(self.values.astype(np.int32), type=pa.int32(),
                            mask=mask).cast(pa.date32())
        if isinstance(self.dtype, dt.TimestampType):
            return pa.array(self.values.astype(np.int64), type=pa.int64(),
                            mask=mask).cast(pa.timestamp("us"))
        return pa.array(self.values, type=at, mask=mask)

    def take(self, indices: np.ndarray) -> "HostColumn":
        vals = self.values[indices]
        validity = None if self.validity is None else self.validity[indices]
        return HostColumn(self.dtype, vals, validity)

    def slice(self, start: int, length: int) -> "HostColumn":
        end = start + length
        validity = None if self.validity is None else self.validity[start:end]
        return HostColumn(self.dtype, self.values[start:end], validity)


@dataclasses.dataclass
class HostTable:
    """A batch of host columns with names (reference: host-side ColumnarBatch)."""
    names: List[str]
    columns: List[HostColumn]

    def __post_init__(self):
        if len(self.names) != len(self.columns):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.columns)} columns")
        if self.columns:
            n = len(self.columns[0])
            if any(len(c) != n for c in self.columns):
                raise ValueError("ragged host table")

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> HostColumn:
        return self.columns[self.names.index(name)]

    # -- conversions ---------------------------------------------------------
    @staticmethod
    def from_arrow(table: pa.Table) -> "HostTable":
        cols = [HostColumn.from_arrow(table.column(i))
                for i in range(table.num_columns)]
        return HostTable(list(table.column_names), cols)

    def to_arrow(self) -> pa.Table:
        return pa.table({n: c.to_arrow() for n, c in zip(self.names, self.columns)})

    def take(self, indices: np.ndarray) -> "HostTable":
        return HostTable(list(self.names), [c.take(indices) for c in self.columns])

    def slice(self, start: int, length: int) -> "HostTable":
        return HostTable(list(self.names),
                         [c.slice(start, length) for c in self.columns])

    def nbytes(self) -> int:
        """Value and validity bytes; a string counts its UTF-8 bytes plus a
        4-byte offset (the JAX package's host-tier stage statistics)."""
        total = 0
        for c in self.columns:
            if c.values.dtype == object:
                total += sum(len(str(v).encode()) for v in c.values) \
                    + 4 * len(c.values)
            else:
                total += c.values.nbytes
            if c.validity is not None:
                total += c.validity.nbytes
        return total

    @staticmethod
    def concat(tables: "Sequence[HostTable]") -> "HostTable":
        if not tables:
            raise ValueError("cannot concat zero host tables")
        first = tables[0]
        if len(tables) == 1:
            return first
        cols = []
        for i in range(first.num_columns):
            parts = [t.columns[i] for t in tables]
            values = np.concatenate([p.values for p in parts])
            if any(p.validity is not None for p in parts):
                validity = np.concatenate([p.valid_mask() for p in parts])
            else:
                validity = None
            cols.append(HostColumn(first.columns[i].dtype, values, validity))
        return HostTable(list(first.names), cols)
