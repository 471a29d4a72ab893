"""TorchSession + DataFrame — the user entry point; the port of
``spark_rapids_tpu/session.py``.

Holds the RapidsConf and the torch device queries run on, and drives
logical -> physical -> overrides -> execution. A device plan that holds an
exchange runs under adaptive execution (plan/aqe.py) unless
``spark.rapids.tpu.aqe.enabled`` is off.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import pyarrow as pa
import torch

from .conf import AQE_ENABLED, RapidsConf
from .expr.base import Alias, AttributeReference, Expression
from .expr.functions import SortOrder, _to_expr, col as _col
from .expr.subquery import ScalarSubquery
from .io.memory import InMemorySource
from .io.parquet import ParquetSource
from .plan.aqe import AdaptiveExec, walk_plan
from .plan.logical import (LogicalAggregate, LogicalFilter, LogicalJoin,
                           LogicalLimit, LogicalPlan, LogicalProject,
                           LogicalScan, LogicalSort)
from .plan.overrides import apply_overrides, explain_plan
from .plan.physical import (PLAN_EXPR_ATTRS, PhysicalPlan,
                            ShuffleExchangeExec)
from .plan.planner import plan_physical
from .plan.schema import Schema

__all__ = ["TorchSession", "DataFrame", "GroupedData"]


class TorchSession:
    """A session whose device plans run on ``device`` (default ``"cuda"``).

    A session asked for CUDA on a machine without a usable CUDA device
    raises: it never carries on on the CPU unless the caller asked for
    ``device="cpu"``.
    """

    def __init__(self, conf: Optional[Union[RapidsConf, Dict]] = None,
                 device: Union[str, torch.device] = "cuda"):
        if isinstance(conf, dict):
            conf = RapidsConf(conf)
        self.conf = conf or RapidsConf()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession: no CUDA device is available; pass "
                "device='cpu' to run the engine on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchSession: unsupported device {device!r}")

    def create_dataframe(self, data, num_partitions: int = 1) -> "DataFrame":
        if isinstance(data, pa.Table):
            table = data
        elif isinstance(data, dict):
            table = pa.table(data)
        else:  # pandas
            table = pa.Table.from_pandas(data, preserve_index=False)
        return DataFrame(self, LogicalScan(InMemorySource(table,
                                                          num_partitions)))

    def read_parquet(self, paths, num_partitions: Optional[int] = None
                     ) -> "DataFrame":
        """A DataFrame over Parquet files (a file, a directory of
        ``*.parquet`` or a glob; partitioned by file)."""
        return DataFrame(self, LogicalScan(
            ParquetSource(paths, self.conf, num_partitions)))

    def _physical(self, logical: LogicalPlan,
                  device: Optional[bool] = None) -> PhysicalPlan:
        cpu = plan_physical(logical, self.conf)
        use_device = self.conf.is_sql_enabled if device is None else device
        # scalar subqueries run first, on the same engine, and enter the
        # main plan as literals (so AQE plans it with the value in place)
        _bind_subqueries(cpu, self, device)
        if not use_device:
            return cpu
        if self.conf.get(AQE_ENABLED) and any(
                isinstance(n, ShuffleExchangeExec) for n in walk_plan(cpu)):
            # stages materialize and the rest re-plans at each exchange
            return AdaptiveExec(cpu, self.conf, self.device)
        return apply_overrides(cpu, self.conf, self.device)

    def set_conf(self, key: str, value) -> "TorchSession":
        self.conf = self.conf.set(key, value)
        return self


class DataFrame:
    def __init__(self, session: TorchSession, logical: LogicalPlan):
        self.session = session
        self.logical = logical

    @property
    def schema(self) -> Schema:
        return self.logical.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # -- transformations -----------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        return DataFrame(self.session, LogicalProject(
            self.logical, [self._col_expr(c) for c in cols]))

    def with_column(self, name: str, c) -> "DataFrame":
        exprs: List[Expression] = [
            AttributeReference(n) for n in self.schema.names if n != name]
        exprs.append(Alias(_to_expr(c), name))
        return DataFrame(self.session, LogicalProject(self.logical, exprs))

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self.session,
                         LogicalFilter(self.logical, _to_expr(cond)))

    where = filter

    def agg(self, *aggs) -> "DataFrame":
        """Aggregate over all rows (no grouping keys)."""
        return GroupedData(self, []).agg(*aggs)

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [self._col_expr(c) for c in cols])

    groupBy = group_by

    def sort(self, *orders, ascending: bool = True) -> "DataFrame":
        """A global sort by column names, Columns or ``SortOrder``s (names
        and Columns sort ``ascending``, with Spark's default null order)."""
        sos = [o if isinstance(o, SortOrder)
               else SortOrder(self._col_expr(o), ascending) for o in orders]
        return DataFrame(self.session, LogicalSort(self.logical, sos))

    order_by = orderBy = sort

    def distinct(self) -> "DataFrame":
        """Row dedup = zero-aggregate group-by over all columns (the
        planner lowers it to the grouped aggregate's key dedup)."""
        return DataFrame(self.session, LogicalAggregate(
            self.logical, [self._col_expr(n) for n in self.columns], []))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, LogicalLimit(self.logical, n))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Join ``other`` on same-named columns ``on`` (output once) or on a
        ``condition`` whose equalities between the two sides are the keys
        (the rest is the residual condition). The device runs every hash
        join type on keys of any ported type but binary; a join without
        equi-keys is not ported yet."""
        if isinstance(on, str):
            on = [on]
        cond = _to_expr(condition) if condition is not None else None
        return DataFrame(self.session, LogicalJoin(self.logical,
                                                   other.logical, on, cond,
                                                   how))

    def _col_expr(self, c) -> Expression:
        return _to_expr(_col(c) if isinstance(c, str) else c)

    # -- actions -------------------------------------------------------------
    def collect(self, device: Optional[bool] = None) -> pa.Table:
        """Run the query: on the session's device (``device=True``, the
        default when SQL is enabled) or on the host engine
        (``device=False``)."""
        plan = self.session._physical(self.logical, device)
        try:
            return plan.collect().to_arrow()
        finally:
            # the plan is single-use: close its spill-registered outputs
            # (broadcast builds, grace parts) now rather than at GC
            plan.release_spill_handles()

    def to_pandas(self, device: Optional[bool] = None):
        return self.collect(device).to_pandas()

    def explain(self, mode: str = "plan") -> str:
        """``"plan"``: the physical plan that runs; ``"device"``: the tagging
        report — each host node and whether, or why not, it runs on the
        device."""
        if mode == "device":
            text = explain_plan(plan_physical(self.logical,
                                              self.session.conf),
                                self.session.conf)
        else:
            text = self.session._physical(self.logical).tree_string()
        print(text)
        return text


class GroupedData:
    """``DataFrame.group_by(...)``: the grouping keys, waiting for ``agg``."""

    def __init__(self, df: DataFrame, groupings: List[Expression]):
        self.df = df
        self.groupings = groupings

    def agg(self, *aggs) -> DataFrame:
        return DataFrame(self.df.session, LogicalAggregate(
            self.df.logical, self.groupings, [_to_expr(a) for a in aggs]))


def _bind_subqueries(plan: PhysicalPlan, session: TorchSession,
                     device: Optional[bool]) -> None:
    """Run every scalar subquery of ``plan`` (in the session, before the main
    query — reference: ExecSubqueryExpression / GpuScalarSubquery) and put
    its value in the plan as a typed literal."""

    def bind(e: Expression) -> Expression:
        if isinstance(e, ScalarSubquery):
            return e.to_literal(session, device)
        if e.children:
            new = [bind(c) for c in e.children]
            if any(n is not o for n, o in zip(new, e.children)):
                e = e.with_children(new)
        return e

    def bind_any(v):
        if isinstance(v, Expression):
            return bind(v)
        if isinstance(v, list):
            return [bind_any(x) for x in v]
        if isinstance(v, SortOrder):  # shared with the exchange's bounds
            v.expr = bind(v.expr)
        return v

    for node in walk_plan(plan):
        for attr in PLAN_EXPR_ATTRS:
            v = getattr(node, attr, None)
            if v is not None:
                setattr(node, attr, bind_any(v))
