"""Logical -> host physical planning — the port of
``spark_rapids_tpu/plan/planner.py`` for scan, filter, project, aggregate,
sort, limit and join.

Produces the host plan that the overrides layer (plan/overrides.py) then
tags and lowers onto the device. Aggregates are planned two-phase (partial
-> exchange -> final -> post-project) like Spark and the reference; a sort
of more than one partition gets a range exchange first; a limit over a sort
becomes top-n; joins are planned by plan/joins_planner.py.
"""
from __future__ import annotations

from typing import List, Optional, Set

from ..conf import RapidsConf
from ..expr.base import AttributeReference, Expression
from .joins_planner import plan_join
from .logical import (LogicalAggregate, LogicalFilter, LogicalJoin,
                      LogicalLimit, LogicalPlan, LogicalProject, LogicalScan,
                      LogicalSort)
from .physical import (AggSpec, CpuCollectLimitExec, CpuFilterExec,
                       CpuGlobalLimitExec, CpuHashAggregateExec,
                       CpuLocalLimitExec, CpuProjectExec, CpuScanExec,
                       CpuSortExec, CpuTakeOrderedExec, HashPartitioning,
                       PhysicalPlan, RangePartitioning, ShuffleExchangeExec,
                       SinglePartitioning)

__all__ = ["plan_physical"]


def plan_physical(logical: LogicalPlan, conf: RapidsConf) -> PhysicalPlan:
    return _plan(logical, conf, required=None)


def _plan(node: LogicalPlan, conf: RapidsConf,
          required: Optional[Set[str]]) -> PhysicalPlan:
    nparts = conf.shuffle_partitions
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
        child = _plan(node.child, conf, _refs(exprs))
        return CpuProjectExec(child, exprs, [e.name for e in exprs])

    if isinstance(node, LogicalFilter):
        child_req = None if required is None \
            else required | node.condition.references()
        return CpuFilterExec(_plan(node.child, conf, child_req),
                             node.condition)

    if isinstance(node, LogicalAggregate):
        refs = _refs(node.groupings)
        for _, fn in node.aggregates:
            refs |= _refs(fn.input_projection())
        return plan_aggregate(_plan(node.child, conf, refs), node, nparts)

    if isinstance(node, LogicalSort):
        child_req = None if required is None \
            else required | _refs(o.expr for o in node.orders)
        child = _plan(node.child, conf, child_req)
        if node.global_sort and child.num_partitions > 1:
            child = ShuffleExchangeExec(
                child, RangePartitioning(node.orders, nparts))
        return CpuSortExec(child, node.orders)

    if isinstance(node, LogicalLimit):
        if isinstance(node.child, LogicalSort) and node.child.global_sort:
            # limit-over-sort is top-n: only each partition's top n rows
            # cross the exchange, not a range-partitioned global sort
            # (reference: limit.scala GpuTakeOrderedAndProjectExec)
            sort = node.child
            child_req = None if required is None \
                else required | _refs(o.expr for o in sort.orders)
            child = _plan(sort.child, conf, child_req)
            local = CpuTakeOrderedExec(child, sort.orders, node.n)
            if child.num_partitions > 1:
                single = ShuffleExchangeExec(local, SinglePartitioning())
                return CpuTakeOrderedExec(single, sort.orders, node.n)
            return local
        child = _plan(node.child, conf, required)
        local = CpuLocalLimitExec(child, node.n)
        if child.num_partitions > 1:
            single = ShuffleExchangeExec(local, SinglePartitioning())
            return CpuCollectLimitExec(single, node.n)
        return CpuGlobalLimitExec(local, node.n)

    if isinstance(node, LogicalJoin):
        return plan_join(node, conf, required,
                         lambda n, req: _plan(n, conf, req), nparts)

    raise NotImplementedError(
        f"{type(node).__name__} is not ported yet (ROADMAP Queue 1)")


def plan_aggregate(child: PhysicalPlan, node: LogicalAggregate,
                   nparts: int) -> PhysicalPlan:
    # 1. pre-projection: group keys + aggregate inputs
    specs = [AggSpec(f"_agg{i}", fn)
             for i, (_, fn) in enumerate(node.aggregates)]
    pre_exprs: List[Expression] = list(node.groupings)
    pre_names: List[str] = [g.name for g in node.groupings]
    for spec in specs:
        for in_name, in_expr in zip(spec.input_cols,
                                    spec.fn.input_projection()):
            pre_exprs.append(in_expr)
            pre_names.append(in_name)
    pre = CpuProjectExec(child, pre_exprs, pre_names)
    key_names = [g.name for g in node.groupings]
    # 2. partial aggregate, 3. exchange, 4. final merge
    partial = CpuHashAggregateExec(pre, key_names, specs, "partial")
    exchange = partial
    if partial.num_partitions > 1:
        part = HashPartitioning(key_names, nparts) if key_names \
            else SinglePartitioning()
        exchange = ShuffleExchangeExec(partial, part)
    final = CpuHashAggregateExec(exchange, key_names, specs, "final")
    # 5. post-projection: keys + evaluated aggregate results
    post_exprs: List[Expression] = []
    post_names: List[str] = []
    for g in node.groupings:
        f = final.schema.field(g.name)
        post_exprs.append(AttributeReference(g.name, f.dtype, f.nullable))
        post_names.append(g.name)
    for spec, (out_name, _) in zip(specs, node.aggregates):
        post_exprs.append(spec.fn.evaluate(spec.prefix))
        post_names.append(out_name)
    return CpuProjectExec(final, post_exprs, post_names)


def _refs(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        out |= e.references()
    return out
