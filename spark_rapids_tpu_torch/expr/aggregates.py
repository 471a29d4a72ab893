"""Aggregate functions — the port of ``spark_rapids_tpu/expr/aggregates.py``
for sum, count, avg, min, max, first, last and the variance family.

Each aggregate declares, in the style of the reference's partial/final mode
projections (aggregate.scala:193-208):

- ``input_projection``: expressions evaluated per input row before reduction
- ``update_ops``:  per projected column, the reduction used in the partial pass
- ``merge_ops``:   reductions used when merging partial states
- ``state_fields``: (suffix, dtype, nullable) of partial-state columns
- ``evaluate(prefix)``: final expression over state columns

Reduction op names understood by the aggregate kernels: ``sum, count, min,
max, first, last`` and the moments' ``moment_mean``, ``moment_m2``,
``moment_mean_merge:<n>`` and ``moment_m2_merge:<n>:<mean>`` (the merges
read the named sibling state columns).

Variance and standard deviation keep ``(count, mean, M2)`` and merge them
with Chan's formula, as Spark does. The JAX package keeps ``(sum, sum of
squares, count)`` and takes ``sumsq - sum^2 / n``, which cancels: on 1000
copies of 123456.789 its variance is -2.15e-05 and its stddev NaN. Here a
group's mean is taken about its first value (and a merge's about its first
state's mean), so that equal values give exactly 0.
``approx_percentile`` keeps a t-digest sketch (``utils/tdigest.py``) as an
array state, which only the host engine holds, as in the JAX package;
``collect_list``/``collect_set`` wait for the port's array columns
(ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..columnar import dtypes as dt
from .arithmetic import Divide
from .base import AttributeReference, Expression, Literal
from .cast import Cast

__all__ = ["AggregateFunction", "Sum", "Count", "CountStar", "Min", "Max",
           "Average", "First", "Last", "StddevPop", "StddevSamp",
           "VariancePop", "VarianceSamp", "ApproximatePercentile"]


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


class First(AggregateFunction):
    """The first non-null value of a group, by row position (the JAX
    package skips nulls whatever ``ignore_nulls`` says)."""

    def __init__(self, child=None, ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def data_type(self):
        return self.child.data_type

    op = "first"

    def update_ops(self):
        return [self.op]

    def merge_ops(self):
        return [self.op]

    def state_fields(self, prefix):
        return [(f"{prefix}_{self.op}", self.data_type, True)]

    def evaluate(self, prefix):
        return AttributeReference(f"{prefix}_{self.op}", self.data_type, True)


class Last(First):
    op = "last"


class _MomentAgg(AggregateFunction):
    """Variance and standard deviation over ``(count, mean, M2)``;
    population or sample by ``ddof``; null where the count is at most
    ``ddof``."""

    ddof = 0

    @property
    def data_type(self):
        return dt.DOUBLE

    def input_projection(self):
        c = Cast(self.child, dt.DOUBLE) \
            if self.child.data_type != dt.DOUBLE else self.child
        return [c, c, c]

    def update_ops(self):
        return ["count", "moment_mean", "moment_m2"]

    def merge_ops(self):
        return ["sum", "moment_mean_merge:{0}", "moment_m2_merge:{0}:{1}"]

    def state_fields(self, prefix):
        return [(f"{prefix}_n", dt.LONG, False),
                (f"{prefix}_mean", dt.DOUBLE, True),
                (f"{prefix}_m2", dt.DOUBLE, True)]

    def _variance_expr(self, prefix) -> Expression:
        from .arithmetic import Subtract
        from .conditional import If
        from .predicates import GreaterThan
        m2 = AttributeReference(f"{prefix}_m2", dt.DOUBLE, True)
        n = Cast(AttributeReference(f"{prefix}_n", dt.LONG, False), dt.DOUBLE)
        ddof = Literal(float(self.ddof), dt.DOUBLE)
        return If(GreaterThan(n, ddof),
                  Divide(m2, Subtract(n, ddof).coerce()).coerce(),
                  Literal(None, dt.DOUBLE))

    def evaluate(self, prefix):
        return self._variance_expr(prefix)


class VariancePop(_MomentAgg):
    ddof = 0


class VarianceSamp(_MomentAgg):
    ddof = 1


class _StddevMixin(_MomentAgg):
    def evaluate(self, prefix):
        from .math import Sqrt
        return Sqrt(self._variance_expr(prefix))


class StddevPop(_StddevMixin):
    ddof = 0


class StddevSamp(_StddevMixin):
    ddof = 1


class _PercentileEval(Expression):
    """approx_percentile's final projection: the value at each requested
    rank of the merged sketch (host engine only)."""

    def __init__(self, child: Expression, percentages: Tuple[float, ...],
                 scalar: bool):
        self.children = (child,)
        self.percentages = tuple(percentages)
        self.scalar = scalar

    def with_children(self, children):
        return _PercentileEval(children[0], self.percentages, self.scalar)

    @property
    def data_type(self):
        return dt.DOUBLE if self.scalar else dt.ArrayType(dt.DOUBLE, False)

    def eval(self, ctx):
        import numpy as np
        from ..utils.tdigest import digest_quantiles
        from .base import EvalCol
        digests = self.children[0].eval(ctx).values
        n = len(digests)
        validity = np.array([d is not None and len(d) > 0 for d in digests],
                            dtype=bool)
        picks = [digest_quantiles(d, self.percentages) if ok else None
                 for d, ok in zip(digests, validity)]
        if self.scalar:
            data = np.array([float(p[0]) if p is not None else 0.0
                             for p in picks], dtype=np.float64)
        else:
            data = np.empty(n, dtype=object)
            data[:] = [[float(x) for x in p] if p is not None else []
                       for p in picks]
        return EvalCol(data, None if validity.all() else validity,
                       self.data_type)


class ApproximatePercentile(AggregateFunction):
    """approx_percentile(col, percentage[, accuracy]) (reference:
    GpuApproximatePercentile.scala, a cuDF t-digest). The state is a bounded
    merging t-digest: a partial pass sketches its rows into at most about
    accuracy / 2 centroids, a merge concatenates and recompresses, and the
    result interpolates between centroids (the reference's documented
    divergence from Spark's exact pick)."""

    def __init__(self, child: Optional[Expression] = None,
                 percentages=(0.5,), scalar: Optional[bool] = None,
                 accuracy: int = 10000):
        super().__init__(child)
        if isinstance(percentages, (int, float)):
            scalar = True if scalar is None else scalar
            percentages = (float(percentages),)
        elif scalar is None:
            scalar = False
        for p in percentages:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"percentage {p} not in [0, 1]")
        if accuracy <= 0:
            raise ValueError(f"accuracy must be positive, got {accuracy}")
        self.percentages = tuple(float(p) for p in percentages)
        self.scalar = scalar
        self.accuracy = int(accuracy)

    def with_children(self, children):
        return ApproximatePercentile(children[0] if children else None,
                                     self.percentages, self.scalar,
                                     self.accuracy)

    @property
    def data_type(self):
        return dt.DOUBLE if self.scalar else dt.ArrayType(dt.DOUBLE, False)

    def input_projection(self):
        return [Cast(self.child, dt.DOUBLE)
                if self.child.data_type != dt.DOUBLE else self.child]

    def update_ops(self):
        return [f"tdigest:{self.accuracy}"]

    def merge_ops(self):
        return [f"tdigest_merge:{self.accuracy}"]

    def state_fields(self, prefix):
        return [(f"{prefix}_values", dt.ArrayType(dt.DOUBLE), False)]

    def evaluate(self, prefix):
        return _PercentileEval(
            AttributeReference(f"{prefix}_values", dt.ArrayType(dt.DOUBLE),
                               False), self.percentages, self.scalar)
