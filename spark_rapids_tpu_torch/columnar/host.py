"""Host-side columnar batches (the CPU staging layer).

The port's copy of ``spark_rapids_tpu/columnar/host.py``: data sits in host
memory in a layout that uploads to the device without reinterpretation.
Fixed-width types are numpy arrays; strings stay numpy object arrays so the
host engine can compute on them directly. A string column decoded from
Arrow keeps its Arrow array, so the upload encodes the device byte matrix
straight from Arrow's buffers.
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
    raise TypeError(f"arrow type {t} is not ported yet")


_TO_ARROW = {dt.BOOLEAN: pa.bool_(), dt.BYTE: pa.int8(), dt.SHORT: pa.int16(),
             dt.INT: pa.int32(), dt.LONG: pa.int64(), dt.FLOAT: pa.float32(),
             dt.DOUBLE: pa.float64(), dt.STRING: pa.string(),
             dt.BINARY: pa.binary(), dt.DATE: pa.date32(),
             dt.TIMESTAMP: pa.timestamp("us"), dt.NULL: pa.null()}


def _dtype_to_arrow(d: dt.DataType) -> pa.DataType:
    return _TO_ARROW[d]


@dataclasses.dataclass
class HostColumn:
    """One host column: values + optional validity mask (True = present)."""
    dtype: dt.DataType
    values: np.ndarray          # fixed width: typed array; string: object array of str
    validity: Optional[np.ndarray] = None   # bool array, None means all-valid
    #: the Arrow array the values were decoded from (string columns fresh
    #: off a scan); the upload reads its buffers instead of re-encoding
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
        if isinstance(self.dtype, (dt.StringType, dt.BinaryType)):
            vals = list(self.values)
            if mask is not None:
                vals = [None if m else v for v, m in zip(vals, mask)]
            return pa.array(vals, type=at)
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
