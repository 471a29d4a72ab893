"""Expression tree core — the port of ``spark_rapids_tpu/expr/base.py``.

Each expression evaluates columnar over a whole batch, and one expression
class carries BOTH evaluation paths:

- device: torch ops over ``DeviceColumn`` tensors (``expr/xp_torch.py``)
- host:   numpy ops over ``HostColumn`` arrays (the host engine)

The two paths share code through an ``EvalContext`` whose ``xp`` is the
array namespace of the path.

SQL null semantics: value ops propagate null if any input is null; And/Or use
Kleene three-valued logic; aggregates skip nulls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.device import DeviceColumn, DeviceTable, bucket_width
from ..columnar.host import HostTable
from .xp_torch import TorchNamespace

__all__ = ["EvalCol", "EvalContext", "Expression", "AttributeReference",
           "Literal", "Alias", "resolve_expression"]


class _NumpyNamespace:
    """numpy, plus the ``astype(x, dtype)`` function the torch namespace has
    (``np.astype`` exists only from numpy 2)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)


_HOST_XP = _NumpyNamespace()


@dataclasses.dataclass
class EvalCol:
    """Backend-agnostic column during evaluation (values+validity arrays)."""
    values: Any                 # np.ndarray | torch.Tensor; strings: obj array (host)
    validity: Any               # bool array or None (all valid)
    dtype: dt.DataType
    lengths: Any = None         # device strings: int32 byte lengths

    def valid_mask(self, ctx: "EvalContext"):
        if self.validity is None:
            return ctx.xp.ones(self.shape0(), dtype=bool)
        return self.validity

    def shape0(self) -> int:
        return self.values.shape[0]


class EvalContext:
    """Evaluation context: column lookup + array backend."""

    def __init__(self, is_device: bool, xp, columns: Dict[str, EvalCol],
                 num_rows: int):
        self.is_device = is_device
        self.xp = xp
        self._columns = columns
        #: rows of every evaluated plane (the batch capacity on the device)
        self.num_rows = num_rows

    @staticmethod
    def for_host(table: HostTable) -> "EvalContext":
        cols = {n: EvalCol(c.values, c.validity, c.dtype)
                for n, c in zip(table.names, table.columns)}
        return EvalContext(False, _HOST_XP, cols, table.num_rows)

    @staticmethod
    def for_device(table: DeviceTable) -> "EvalContext":
        def to_eval(c: DeviceColumn) -> EvalCol:
            # null-free columns enter evaluation with validity=None so every
            # null-propagation AND drops out of the batch function
            return EvalCol(c.data, None if c.all_valid else c.validity,
                           c.dtype, c.lengths)

        cols = {n: to_eval(c) for n, c in zip(table.names, table.columns)}
        return EvalContext(True, TorchNamespace(table.device), cols,
                           table.capacity)

    def lookup(self, name: str) -> EvalCol:
        return self._columns[name]


class Expression:
    """Base expression node.

    Subclasses define ``data_type``/``nullable`` after resolution and
    implement ``eval(ctx)``. ``children`` drives tree traversal for the
    tagging/meta layer (plan/meta.py).
    """

    children: Tuple["Expression", ...] = ()

    @property
    def data_type(self) -> dt.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    @property
    def name(self) -> str:
        return type(self).__name__

    def eval(self, ctx: EvalContext) -> EvalCol:
        raise NotImplementedError(type(self).__name__)

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        """Rebuild this node with new children (for resolution rewrites).

        Default assumes the constructor takes the children positionally
        (unary/binary op convention); others override.
        """
        return type(self)(*children)

    def __repr__(self):
        if self.children:
            return f"{self.name}({', '.join(map(repr, self.children))})"
        return self.name

    def references(self) -> set:
        """Column names read (for column pruning)."""
        refs = set()
        for c in self.children:
            refs |= c.references()
        return refs


@dataclasses.dataclass(repr=False)
class AttributeReference(Expression):
    """A named column reference, resolved against the child's schema."""
    column_name: str
    _dtype: Optional[dt.DataType] = None
    _nullable: bool = True

    def __post_init__(self):
        self.children = ()

    @property
    def data_type(self) -> dt.DataType:
        if self._dtype is None:
            raise RuntimeError(f"unresolved attribute {self.column_name!r}")
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.column_name

    def eval(self, ctx: EvalContext) -> EvalCol:
        return ctx.lookup(self.column_name)

    def references(self) -> set:
        return {self.column_name}

    def __repr__(self):
        return f"col({self.column_name!r})"


@dataclasses.dataclass(repr=False)
class Literal(Expression):
    """A typed scalar constant (reference: literals.scala)."""
    value: Any
    _dtype: Optional[dt.DataType] = None

    def __post_init__(self):
        self.children = ()
        if self._dtype is None:
            self._dtype = _infer_literal_type(self.value)

    @property
    def data_type(self) -> dt.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        n = ctx.num_rows
        string_like = isinstance(self._dtype, (dt.StringType, dt.BinaryType))
        if string_like and ctx.is_device:
            return _device_string_literal(self.value, self._dtype, n,
                                          xp.device)
        if self.value is None:
            if string_like:
                return EvalCol(np.empty(n, dtype=object),
                               np.zeros(n, dtype=bool), self._dtype)
            return EvalCol(xp.zeros(n, dtype=self._dtype.np_dtype()),
                           xp.zeros(n, dtype=bool), self._dtype)
        if string_like:
            values = np.empty(n, dtype=object)
            values[:] = self.value
            return EvalCol(values, None, self._dtype)
        v = self.value
        import datetime
        if isinstance(self._dtype, dt.TimestampType) \
                and isinstance(v, datetime.datetime):
            utc = datetime.timezone.utc
            aware = v if v.tzinfo is not None else v.replace(tzinfo=utc)
            epoch = datetime.datetime(1970, 1, 1, tzinfo=utc)
            v = int((aware - epoch).total_seconds() * 1_000_000)
        elif isinstance(self._dtype, dt.DateType) \
                and isinstance(v, datetime.date):
            v = (v - datetime.date(1970, 1, 1)).days
        return EvalCol(xp.full((n,), v, dtype=self._dtype.np_dtype()), None,
                       self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(repr=False)
class Alias(Expression):
    """Renames its child in project output."""
    child: Expression
    alias: str

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def data_type(self) -> dt.DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    @property
    def name(self) -> str:
        return self.alias

    def eval(self, ctx: EvalContext) -> EvalCol:
        return self.child.eval(ctx)

    def with_children(self, children):
        return Alias(children[0], self.alias)

    def __repr__(self):
        return f"{self.child!r} AS {self.alias}"


def _device_string_literal(value, dtype: dt.DataType, n: int,
                           device) -> EvalCol:
    """A string literal in the device layout: every row the value's bytes,
    zero-padded to the bucketed width, and its byte length (a null literal
    is empty and null). The rows are one broadcast row, not n copies."""
    b = b"" if value is None else (
        value.encode() if isinstance(value, str) else bytes(value))
    row = np.zeros(bucket_width(max(len(b), 1)), dtype=np.uint8)
    row[:len(b)] = np.frombuffer(b, dtype=np.uint8)
    mat = torch.from_numpy(row).to(device).expand(n, -1)
    lengths = torch.full((n,), len(b), dtype=torch.int32, device=device)
    validity = torch.zeros(n, dtype=torch.bool, device=device) \
        if value is None else None
    return EvalCol(mat, validity, dtype, lengths)


def _infer_literal_type(value: Any) -> dt.DataType:
    if value is None:
        return dt.NULL
    if isinstance(value, bool):
        return dt.BOOLEAN
    if isinstance(value, int):
        return dt.INT if -2**31 <= value < 2**31 else dt.LONG
    if isinstance(value, float):
        return dt.DOUBLE
    if isinstance(value, str):
        return dt.STRING
    if isinstance(value, (bytes, bytearray)):
        return dt.BINARY
    import datetime
    if isinstance(value, datetime.datetime):
        return dt.TIMESTAMP
    if isinstance(value, datetime.date):
        return dt.DATE
    raise TypeError(f"literal {value!r} is of a type not ported yet")


def resolve_expression(expr: Expression, schema: Dict[str, dt.DataType],
                       nullable: Optional[Dict[str, bool]] = None) -> Expression:
    """Resolve attribute dtypes and insert implicit casts bottom-up.

    Catalyst's analyzer equivalent, minimal: binds AttributeReferences to the
    child schema and lets nodes with a ``coerce`` hook rewrite their children
    (numeric promotion for arithmetic/comparison).
    """
    new_children = [resolve_expression(c, schema, nullable)
                    for c in expr.children]
    if isinstance(expr, AttributeReference):
        if expr.column_name not in schema:
            raise KeyError(f"column {expr.column_name!r} not found; "
                           f"available: {list(schema)}")
        is_nullable = True if nullable is None \
            else nullable.get(expr.column_name, True)
        return AttributeReference(expr.column_name, schema[expr.column_name],
                                  is_nullable)
    out = expr.with_children(new_children) if expr.children else expr
    coerce = getattr(out, "coerce", None)
    if coerce is not None:
        out = coerce()
    return out
