"""Scalar subqueries — the port of ``spark_rapids_tpu/expr/subquery.py``.

Reference: GpuScalarSubquery / ExecSubqueryExpression — the subquery plan
executes BEFORE the main query and its single value is injected as a scalar.
Same shape here: ``scalar_subquery(df)`` embeds the sub-plan as an
expression; at physical-planning time the session executes it and replaces
the expression with a typed Literal, so the main plan runs with a plain
scalar (TPC-H q11/q15/q22), never a join.
"""
from __future__ import annotations

from ..columnar import dtypes as dt
from .base import EvalContext, Expression, Literal

__all__ = ["ScalarSubquery"]


class ScalarSubquery(Expression):
    """One-row one-column subquery; replaced by a Literal at plan time."""

    def __init__(self, logical_plan):
        self.plan = logical_plan
        self.children = ()
        fields = list(logical_plan.schema)
        if len(fields) != 1:
            raise ValueError(
                f"scalar subquery must have exactly one column, got "
                f"{[f.name for f in fields]}")
        self._dtype = fields[0].dtype

    @property
    def data_type(self) -> dt.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return True  # empty subquery result -> null

    def with_children(self, children):
        return self

    def references(self):
        return set()  # correlated subqueries are not supported

    def to_literal(self, session, device) -> Literal:
        """Execute the sub-plan and wrap its value (the subquery runs in
        the session, before the main query, like the reference): no row ->
        a null literal, more than one -> an error."""
        table = session._physical(self.plan, device).collect()
        n = table.num_rows
        if n == 0:
            return Literal(None, self._dtype)
        if n > 1:
            raise ValueError(
                f"scalar subquery returned {n} rows (expected at most 1)")
        col = table.columns[0]
        if col.validity is not None and not bool(col.validity[0]):
            return Literal(None, self._dtype)
        v = col.values[0]
        if hasattr(v, "item"):
            v = v.item()  # a host value: the result is already downloaded
        return Literal(v, self._dtype)

    def eval(self, ctx: EvalContext):
        raise RuntimeError(
            "ScalarSubquery must be replaced by a Literal at plan time "
            "(the session's subquery pass)")

    def __repr__(self):
        return "scalar_subquery(...)"
