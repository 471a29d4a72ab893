"""Join planning — the port of ``spark_rapids_tpu/plan/joins_planner.py``:
equi-key extraction, key type coercion, and the choice between a broadcast
hash join, a shuffled hash join and, for a join without equi-keys (a cross
join, or a condition with no equality between the sides), the broadcast
nested-loop join (reference: GpuOverrides join rules; Spark's
ExtractEquiJoinKeys is mirrored by ``extract_equi_keys``).
"""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ..columnar import dtypes as dt
from ..conf import BROADCAST_THRESHOLD, RapidsConf
from ..expr.base import Alias, AttributeReference, Expression
from ..expr.predicates import And, EqualTo
from .logical import LogicalJoin, LogicalPlan, LogicalScan
from .physical import (CpuProjectExec, HashPartitioning, PhysicalPlan,
                       ShuffleExchangeExec)
from .physical_joins import (CpuBroadcastHashJoinExec,
                             CpuBroadcastNestedLoopJoinExec,
                             CpuShuffledHashJoinExec)

__all__ = ["plan_join", "extract_equi_keys"]


def _estimate_subtree_bytes(node: LogicalPlan) -> Optional[int]:
    """Sum of scan-source estimates under a logical node; None if unknown."""
    if isinstance(node, LogicalScan):
        return node.source.estimated_size_bytes()
    sizes = [_estimate_subtree_bytes(c) for c in node.children]
    if not sizes or any(s is None for s in sizes):
        return None
    return sum(sizes)


def extract_equi_keys(condition: Optional[Expression], lnames: Set[str],
                      rnames: Set[str]
                      ) -> Tuple[List[str], List[str], Optional[Expression]]:
    """Split a join condition into equi-key column pairs + residual."""
    if condition is None:
        return [], [], None
    conjuncts: List[Expression] = []

    def flatten(e: Expression):
        if isinstance(e, And):
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)
    flatten(condition)
    lkeys, rkeys, residual = [], [], []
    for c in conjuncts:
        if isinstance(c, EqualTo) \
                and isinstance(c.left, AttributeReference) \
                and isinstance(c.right, AttributeReference):
            ln, rn = c.left.column_name, c.right.column_name
            if ln in lnames and rn in rnames:
                lkeys.append(ln)
                rkeys.append(rn)
                continue
            if rn in lnames and ln in rnames:
                lkeys.append(rn)
                rkeys.append(ln)
                continue
        residual.append(c)
    res: Optional[Expression] = None
    for c in residual:
        res = c if res is None else And(res, c)
    return lkeys, rkeys, res


def _coerce_join_keys(left: PhysicalPlan, right: PhysicalPlan,
                      lkeys, rkeys):
    """Cast mismatched numeric key pairs to their common type BEFORE hashing:
    an int64 key and a float64 key of equal value would otherwise hash to
    different shuffle partitions and the co-partitioned join would drop the
    match.

    The casts live in HIDDEN ``__jk*`` columns so user-visible column types
    are untouched (USING joins coerce visibly at the logical layer,
    plan/logical.py ``_coerce_using_keys``). Returns (left, right, lkeys,
    rkeys, hidden): ``hidden`` names the temp columns the caller projects
    away above the join."""
    from ..expr.arithmetic import numeric_promote
    from ..expr.cast import Cast

    commons = {}
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        lt = left.schema.field(lk).dtype
        rt = right.schema.field(rk).dtype
        if lt == rt or not (lt.is_numeric and rt.is_numeric) \
                or isinstance(lt, dt.DecimalType) \
                or isinstance(rt, dt.DecimalType):
            # decimal keys are joined as they are, as the JAX package does
            continue
        commons[i] = numeric_promote(lt, rt)
    if not commons:
        return left, right, list(lkeys), list(rkeys), []

    def add_temps(plan: PhysicalPlan, keys, side):
        exprs: List[Expression] = []
        names = []
        for f in plan.schema:
            exprs.append(AttributeReference(f.name, f.dtype, f.nullable))
            names.append(f.name)
        for i, common in commons.items():
            f = plan.schema.field(keys[i])
            exprs.append(Alias(
                Cast(AttributeReference(f.name, f.dtype, f.nullable), common),
                f"__jk{side}{i}"))
            names.append(f"__jk{side}{i}")
        return CpuProjectExec(plan, exprs, names)

    lkeys2 = [f"__jkl{i}" if i in commons else k for i, k in enumerate(lkeys)]
    rkeys2 = [f"__jkr{i}" if i in commons else k for i, k in enumerate(rkeys)]
    hidden = [f"__jk{s}{i}" for i in commons for s in ("l", "r")]
    return (add_temps(left, lkeys, "l"), add_temps(right, rkeys, "r"),
            lkeys2, rkeys2, hidden)


def plan_join(node: LogicalJoin, conf: RapidsConf,
              required: Optional[Set[str]], plan_fn,
              nparts: int) -> PhysicalPlan:
    """A broadcast hash join when the right subtree's estimated bytes are
    within ``spark.rapids.tpu.autoBroadcastJoinThreshold`` (and its
    unmatched rows never reach the output), else hash exchanges on both
    sides and a shuffled hash join; without equi-keys a broadcast
    nested-loop join over the whole condition. ``plan_fn(logical,
    required)`` plans a child."""
    lnames = set(node.left.schema.names)
    rnames = set(node.right.schema.names)
    if node.on:
        lkeys, rkeys, residual = list(node.on), list(node.on), node.condition
        merge_keys = True
    else:
        lkeys, rkeys, residual = extract_equi_keys(node.condition, lnames,
                                                   rnames)
        merge_keys = False
    lreq = rreq = None
    if required is not None:
        refs = set(required) | set(lkeys) | set(rkeys)
        if residual is not None:
            refs |= residual.references()
        lreq = refs & lnames
        rreq = refs & rnames
    left = plan_fn(node.left, lreq)
    right = plan_fn(node.right, rreq)
    left, right, lkeys, rkeys, hidden = _coerce_join_keys(left, right, lkeys,
                                                          rkeys)

    def strip_hidden(join: PhysicalPlan) -> PhysicalPlan:
        if not hidden:
            return join
        keep = [f for f in join.schema if f.name not in hidden]
        return CpuProjectExec(
            join, [AttributeReference(f.name, f.dtype, f.nullable)
                   for f in keep], [f.name for f in keep])

    if not lkeys:
        return CpuBroadcastNestedLoopJoinExec(left, right, node.how,
                                              node.condition)
    threshold = conf.get(BROADCAST_THRESHOLD)
    rsize = _estimate_subtree_bytes(node.right)
    # broadcasting the RIGHT side is only sound when unmatched right rows
    # never appear in the output (they would repeat per left partition)
    broadcastable = node.how in ("inner", "left", "left_semi", "left_anti")
    if broadcastable and threshold >= 0 and rsize is not None \
            and rsize <= threshold:
        return strip_hidden(CpuBroadcastHashJoinExec(
            left, right, lkeys, rkeys, node.how, residual, merge_keys))
    if left.num_partitions > 1 or right.num_partitions > 1:
        left = ShuffleExchangeExec(left, HashPartitioning(lkeys, nparts))
        right = ShuffleExchangeExec(right, HashPartitioning(rkeys, nparts))
    return strip_hidden(CpuShuffledHashJoinExec(
        left, right, lkeys, rkeys, node.how, residual, merge_keys))
