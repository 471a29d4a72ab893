"""In-memory data source (arrow table), the LocalTableScan analogue — the
port of ``spark_rapids_tpu/io/memory.py``."""
from __future__ import annotations

import math
from typing import Iterator, List, Optional

import pyarrow as pa

from ..columnar.host import HostTable
from ..plan.logical import DataSource
from ..plan.schema import Field, Schema

__all__ = ["InMemorySource"]


class InMemorySource(DataSource):
    def __init__(self, table: pa.Table, num_partitions: int = 1,
                 batch_rows: int = 1 << 20):
        self.table = table
        self._parts = max(1, num_partitions)
        self.batch_rows = batch_rows
        self._decoded = {}  # (pidx, columns) -> List[HostTable]
        ht = HostTable.from_arrow(table.slice(0, 0))
        # trust declared nullability only when the data agrees: pyarrow
        # does not validate nullable=False against the arrays
        self._schema = Schema([
            Field(n, c.dtype, table.schema.field(i).nullable
                  or table.column(i).null_count > 0)
            for i, (n, c) in enumerate(zip(ht.names, ht.columns))])

    def schema(self) -> Schema:
        return self._schema

    def partitions(self) -> int:
        return self._parts

    def read_partition(self, pidx: int, columns: Optional[List[str]] = None
                       ) -> Iterator[HostTable]:
        key = (pidx, None if columns is None else tuple(columns))
        cached = self._decoded.get(key)
        if cached is not None:
            yield from cached
            return
        n = self.table.num_rows
        per = math.ceil(n / self._parts) if n else 0
        lo = min(n, pidx * per)
        hi = min(n, (pidx + 1) * per)
        t = self.table.slice(lo, hi - lo)
        if columns:
            t = t.select(columns)
        out: List[HostTable] = []
        pos = 0
        while pos < t.num_rows or (pos == 0 and t.num_rows == 0):
            ht = HostTable.from_arrow(t.slice(pos, self.batch_rows))
            out.append(ht)
            yield ht
            pos += self.batch_rows
            if t.num_rows == 0:
                break
        # the arrow->HostTable decode is deterministic and the source is
        # immutable: cache it so repeated executions skip the decode.
        # Bounded: distinct column subsets must not accumulate
        if len(self._decoded) >= 4 * self._parts:
            self._decoded.clear()
        self._decoded[key] = out

    def estimated_size_bytes(self) -> int:
        """The planner's broadcast estimate: the Arrow table's buffer bytes,
        as the JAX package reads it, so both plan the same joins."""
        return self.table.nbytes

    def name(self) -> str:
        return f"InMemory[{self.table.num_rows} rows]"
