"""Logical -> host physical planning — the port of
``spark_rapids_tpu/plan/planner.py`` for scan, filter, project and the
ungrouped aggregate.

Produces the host plan that the overrides layer (plan/overrides.py) then
tags and lowers onto the device. Aggregates are planned two-phase (partial
-> exchange -> final -> post-project) like Spark and the reference.
"""
from __future__ import annotations

from typing import List, Optional, Set

from ..expr.base import Expression
from .logical import (LogicalAggregate, LogicalFilter, LogicalPlan,
                      LogicalProject, LogicalScan)
from .physical import (AggSpec, CpuFilterExec, CpuHashAggregateExec,
                       CpuProjectExec, CpuScanExec, PhysicalPlan,
                       ShuffleExchangeExec, SinglePartitioning)

__all__ = ["plan_physical"]


def plan_physical(logical: LogicalPlan) -> PhysicalPlan:
    return _plan(logical, required=None)


def _plan(node: LogicalPlan, required: Optional[Set[str]]) -> PhysicalPlan:
    if isinstance(node, LogicalScan):
        cols = None
        if required is not None:
            cols = [n for n in node.schema.names if n in required]
            if not cols:  # count(*)-style: keep the narrowest column
                cols = [node.schema.names[0]] if node.schema.names else None
        return CpuScanExec(node.source, cols)

    if isinstance(node, LogicalProject):
        exprs = list(node.exprs)
        if required is not None:
            # column pruning through pass-through projections (the
            # with_column idiom projects every input column): outputs
            # nobody above needs are dropped (Spark's ColumnPruning rule)
            kept = [e for e in exprs if e.name in required]
            exprs = kept or exprs[:1]  # count(*)-style: keep one column
        child = _plan(node.child, _refs(exprs))
        return CpuProjectExec(child, exprs, [e.name for e in exprs])

    if isinstance(node, LogicalFilter):
        child_req = None if required is None \
            else required | node.condition.references()
        return CpuFilterExec(_plan(node.child, child_req), node.condition)

    if isinstance(node, LogicalAggregate):
        refs = _refs(node.groupings)
        for _, fn in node.aggregates:
            refs |= _refs(fn.input_projection())
        return plan_aggregate(_plan(node.child, refs), node)

    raise NotImplementedError(
        f"{type(node).__name__} is not ported yet (ROADMAP Queue 1)")


def plan_aggregate(child: PhysicalPlan, node: LogicalAggregate
                   ) -> PhysicalPlan:
    if node.groupings:
        raise NotImplementedError(
            "keyed aggregates are not ported yet (ROADMAP Queue 1 step 4)")
    # 1. pre-projection: aggregate inputs
    specs = [AggSpec(f"_agg{i}", fn)
             for i, (_, fn) in enumerate(node.aggregates)]
    pre_exprs: List[Expression] = []
    pre_names: List[str] = []
    for spec in specs:
        for in_name, in_expr in zip(spec.input_cols,
                                    spec.fn.input_projection()):
            pre_exprs.append(in_expr)
            pre_names.append(in_name)
    pre = CpuProjectExec(child, pre_exprs, pre_names)
    # 2. partial aggregate, 3. exchange, 4. final merge
    partial = CpuHashAggregateExec(pre, [], specs, "partial")
    exchange = ShuffleExchangeExec(partial, SinglePartitioning()) \
        if partial.num_partitions > 1 else partial
    final = CpuHashAggregateExec(exchange, [], specs, "final")
    # 5. post-projection: evaluated aggregate results
    post_exprs = [spec.fn.evaluate(spec.prefix) for spec in specs]
    post_names = [out_name for out_name, _ in node.aggregates]
    return CpuProjectExec(final, post_exprs, post_names)


def _refs(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        out |= e.references()
    return out
