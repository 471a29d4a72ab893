"""Schema: ordered named fields with nullability (the port's copy of
``spark_rapids_tpu/plan/schema.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

from ..columnar import dtypes as dt

__all__ = ["Field", "Schema"]


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: dt.DataType
    nullable: bool = True


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._by_name = {f.name: f for f in self.fields}
        if len(self._by_name) != len(self.fields):
            names = [f.name for f in self.fields]
            dupes = {n for n in names if names.count(n) > 1}
            raise ValueError(f"duplicate column names: {sorted(dupes)}")

    @staticmethod
    def of(*pairs) -> "Schema":
        return Schema([Field(n, t) for n, t in pairs])

    def __len__(self):
        return len(self.fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def field(self, name: str) -> Field:
        return self._by_name[name]

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def to_dict(self) -> Dict[str, dt.DataType]:
        return {f.name: f.dtype for f in self.fields}

    def nullable_dict(self) -> Dict[str, bool]:
        return {f.name: f.nullable for f in self.fields}

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self._by_name[n] for n in names])

    def __repr__(self):
        inner = ", ".join(
            f"{f.name}: {f.dtype!r}{'' if f.nullable else ' not null'}"
            for f in self.fields)
        return f"Schema({inner})"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields
