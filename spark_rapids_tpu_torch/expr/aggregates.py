"""Aggregate functions — the port of ``spark_rapids_tpu/expr/aggregates.py``
for sum, count, avg, min and max.

Each aggregate declares, in the style of the reference's partial/final mode
projections (aggregate.scala:193-208):

- ``input_projection``: expressions evaluated per input row before reduction
- ``update_ops``:  per projected column, the reduction used in the partial pass
- ``merge_ops``:   reductions used when merging partial states
- ``state_fields``: (suffix, dtype, nullable) of partial-state columns
- ``evaluate(prefix)``: final expression over state columns

Reduction op names understood by the aggregate kernels: ``sum, count, min,
max``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..columnar import dtypes as dt
from .arithmetic import Divide
from .base import AttributeReference, Expression, Literal
from .cast import Cast

__all__ = ["AggregateFunction", "Sum", "Count", "CountStar", "Min", "Max",
           "Average"]


class AggregateFunction(Expression):
    def __init__(self, child: Optional[Expression] = None):
        self.child = child
        self.children = (child,) if child is not None else ()

    def with_children(self, children):
        return type(self)(children[0]) if children else type(self)()

    # -- aggregation contract -------------------------------------------------
    def input_projection(self) -> List[Expression]:
        return [self.child]

    def update_ops(self) -> List[str]:
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def state_fields(self, prefix: str) -> List[Tuple[str, dt.DataType, bool]]:
        raise NotImplementedError

    def evaluate(self, prefix: str) -> Expression:
        """Final projection over the named state columns."""
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return True


def _sum_result_type(t: dt.DataType) -> dt.DataType:
    if isinstance(t, dt.DecimalType):
        # Spark: sum(decimal(p, s)) = decimal(min(p + 10, 38), s); past 18
        # digits the state is a limb plane on the device
        return dt.DecimalType(
            min(t.precision + 10, dt.DecimalType.MAX_PRECISION_128), t.scale)
    return dt.DOUBLE if isinstance(t, dt.FractionalType) else dt.LONG


class Sum(AggregateFunction):
    @property
    def data_type(self):
        return _sum_result_type(self.child.data_type)

    def input_projection(self):
        return [Cast(self.child, self.data_type)
                if self.child.data_type != self.data_type else self.child]

    def update_ops(self):
        return ["sum"]

    def merge_ops(self):
        return ["sum"]

    def state_fields(self, prefix):
        return [(f"{prefix}_sum", self.data_type, True)]

    def evaluate(self, prefix):
        return AttributeReference(f"{prefix}_sum", self.data_type, True)


class Count(AggregateFunction):
    @property
    def data_type(self):
        return dt.LONG

    @property
    def nullable(self):
        return False

    def update_ops(self):
        return ["count"]

    def merge_ops(self):
        return ["sum"]

    def state_fields(self, prefix):
        return [(f"{prefix}_count", dt.LONG, False)]

    def evaluate(self, prefix):
        return AttributeReference(f"{prefix}_count", dt.LONG, False)


class CountStar(Count):
    """count(*) — counts rows regardless of nulls."""

    def __init__(self, child: Optional[Expression] = None):
        super().__init__(None)

    def input_projection(self):
        return [Literal(1, dt.LONG)]


class Min(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type

    def update_ops(self):
        return ["min"]

    def merge_ops(self):
        return ["min"]

    def state_fields(self, prefix):
        return [(f"{prefix}_min", self.data_type, True)]

    def evaluate(self, prefix):
        return AttributeReference(f"{prefix}_min", self.data_type, True)


class Max(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type

    def update_ops(self):
        return ["max"]

    def merge_ops(self):
        return ["max"]

    def state_fields(self, prefix):
        return [(f"{prefix}_max", self.data_type, True)]

    def evaluate(self, prefix):
        return AttributeReference(f"{prefix}_max", self.data_type, True)


class Average(AggregateFunction):
    @property
    def data_type(self):
        return dt.DOUBLE

    def input_projection(self):
        return [Cast(self.child, dt.DOUBLE)
                if self.child.data_type != dt.DOUBLE else self.child,
                self.child]

    def update_ops(self):
        return ["sum", "count"]

    def merge_ops(self):
        return ["sum", "sum"]

    def state_fields(self, prefix):
        return [(f"{prefix}_sum", dt.DOUBLE, True),
                (f"{prefix}_count", dt.LONG, False)]

    def evaluate(self, prefix):
        return Divide(AttributeReference(f"{prefix}_sum", dt.DOUBLE, True),
                      AttributeReference(f"{prefix}_count", dt.LONG, False)
                      ).coerce()
