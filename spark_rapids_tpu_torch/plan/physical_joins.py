"""Host-engine equi-joins — the port of ``spark_rapids_tpu/plan/physical_joins.py``
for the hash joins (reference: GpuShuffledHashJoinExec /
GpuBroadcastHashJoinExec).

numpy, not pandas (the JAX package's host join is ``pandas.merge``): each
key pair is coded over both sides at once (integers as themselves, floats
and strings by ``np.unique`` / Arrow's ``dictionary_encode``), the codes of
a multi-key join fold into one, and a stable sort of the right side's codes
plus two ``searchsorted`` passes give every left row its run of matching
right rows. Output rows come in left-row order, each left row's matches in
right-row order.

Spark join-key semantics: null keys never match; NaN keys match NaN; -0.0
matches 0.0; ``on=`` joins output the key columns once (coalesced for full
outer), expression equi-joins keep both sides' columns.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..columnar.host import HostColumn, HostTable
from ..expr.base import EvalContext, Expression
from .host_groupby import object_codes, unique_rows
from .logical import _join_schema
from .physical import PhysicalPlan, empty_result_table

__all__ = ["CpuShuffledHashJoinExec", "CpuBroadcastHashJoinExec",
           "join_host_tables"]


def _key_codes(lt: HostTable, rt: HostTable, lkeys: Sequence[str],
               rkeys: Sequence[str]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (left codes, left usable, right codes, right usable): int64 codes
    equal exactly where the key tuples are equal under Spark's rules (any
    int64 value, negatives included), and a row is usable where none of its
    keys is null."""
    nl = lt.num_rows
    planes = []
    lnull = np.zeros(nl, dtype=bool)
    rnull = np.zeros(rt.num_rows, dtype=bool)
    for lkn, rkn in zip(lkeys, rkeys):
        lc, rc = lt.column(lkn), rt.column(rkn)
        lnull |= ~lc.valid_mask()
        rnull |= ~rc.valid_mask()
        both = np.concatenate([lc.values, rc.values])
        if both.dtype == object:
            planes.append(object_codes(both))
        elif both.dtype.kind == "f":
            # -0.0 == 0.0 and NaN == NaN in np.unique
            planes.append(np.unique(both, return_inverse=True)[1]
                          .reshape(-1).astype(np.int64))
        else:
            planes.append(both.astype(np.int64))
    if len(planes) == 1:
        code = planes[0]
    else:
        code = unique_rows(np.stack(planes, axis=1))[2].astype(np.int64)
    return code[:nl], ~lnull, code[nl:], ~rnull


def _inner_pairs(lcode: np.ndarray, lvalid: np.ndarray, rcode: np.ndarray,
                 rvalid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Matching (left row, right row) index pairs of the usable rows."""
    r_rows = np.nonzero(rvalid)[0]
    order = np.argsort(rcode[r_rows], kind="stable")
    r_sorted = rcode[r_rows][order]
    starts = np.searchsorted(r_sorted, lcode, side="left")
    counts = np.searchsorted(r_sorted, lcode, side="right") - starts
    counts = np.where(lvalid, counts, 0)
    li = np.repeat(np.arange(len(lcode), dtype=np.int64), counts)
    # each pair's rank within its left row's run of matches
    run_start = np.repeat(np.cumsum(counts) - counts, counts)
    k = np.arange(len(li), dtype=np.int64) - run_start
    ri = r_rows[order[np.repeat(starts, counts) + k]]
    return li, ri.astype(np.int64)


def _gather_with_nulls(table: HostTable, idx: np.ndarray) -> HostTable:
    """take() where idx == -1 produces an all-null row."""
    safe = np.where(idx < 0, 0, idx)
    matched = idx >= 0
    out_cols: List[HostColumn] = []
    for c in table.columns:
        if table.num_rows == 0:
            vals = np.zeros(len(idx), dtype=c.values.dtype)
            if c.values.dtype == object:
                vals[:] = ""
            out_cols.append(HostColumn(c.dtype, vals,
                                       np.zeros(len(idx), dtype=bool)))
            continue
        validity = c.valid_mask()[safe] & matched
        out_cols.append(HostColumn(c.dtype, c.values[safe],
                                   None if validity.all() else validity))
    return HostTable(list(table.names), out_cols)


def join_host_tables(lt: HostTable, rt: HostTable, lkeys: Sequence[str],
                     rkeys: Sequence[str], how: str,
                     condition: Optional[Expression],
                     merge_keys: bool) -> HostTable:
    if not lkeys:
        raise NotImplementedError(
            "joins without equi-keys (cross and nested-loop joins) are not "
            "ported yet (ROADMAP Queue 1 step 6)")
    li, ri = _inner_pairs(*_key_codes(lt, rt, lkeys, rkeys))
    if condition is not None:
        pairs = _combine(lt, rt, li, ri, lkeys, "inner", False)
        c = condition.eval(EvalContext.for_host(pairs))
        keep = np.asarray(c.values, dtype=np.bool_)
        if c.validity is not None:
            keep &= c.validity
        li, ri = li[keep], ri[keep]
    if how == "inner":
        return _combine(lt, rt, li, ri, lkeys, how, merge_keys)
    lmatched = np.zeros(lt.num_rows, dtype=bool)
    lmatched[li] = True
    if how == "left_semi":
        return lt.take(np.nonzero(lmatched)[0])
    if how == "left_anti":
        return lt.take(np.nonzero(~lmatched)[0])
    if how not in ("left", "right", "full"):
        raise ValueError(how)
    if how in ("left", "full"):
        extra = np.nonzero(~lmatched)[0]
        li = np.concatenate([li, extra])
        ri = np.concatenate([ri, np.full(len(extra), -1, dtype=np.int64)])
    if how in ("right", "full"):
        rmatched = np.zeros(rt.num_rows, dtype=bool)
        rmatched[ri[ri >= 0]] = True
        extra = np.nonzero(~rmatched)[0]
        ri = np.concatenate([ri, extra])
        li = np.concatenate([li, np.full(len(extra), -1, dtype=np.int64)])
    return _combine(lt, rt, li, ri, lkeys, how, merge_keys)


def _combine(lt: HostTable, rt: HostTable, li: np.ndarray, ri: np.ndarray,
             lkeys: Sequence[str], how: str, merge_keys: bool) -> HostTable:
    lpart = _gather_with_nulls(lt, li)
    rpart = _gather_with_nulls(rt, ri)
    names: List[str] = []
    cols: List[HostColumn] = []
    on = list(lkeys) if merge_keys else []
    for k in on:
        lc = lpart.column(k)
        if how in ("right", "full"):
            # a right-only row takes its key from the right side
            rc = rpart.column(k)
            take_r = ~lc.valid_mask()
            vals = lc.values.copy()
            vals[take_r] = rc.values[take_r]
            validity = lc.valid_mask() | rc.valid_mask()
            lc = HostColumn(lc.dtype, vals,
                            None if validity.all() else validity)
        cols.append(lc)
        names.append(k)
    for part in (lpart, rpart):
        for n, c in zip(part.names, part.columns):
            if n not in on:
                names.append(n)
                cols.append(c)
    return HostTable(names, cols)


class CpuShuffledHashJoinExec(PhysicalPlan):
    """Equi-join of co-partitioned children: partition p of the left joins
    partition p of the right."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str, condition: Optional[Expression],
                 merge_keys: bool):
        self.left, self.right = left, right
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.condition = condition
        self.merge_keys = merge_keys
        on = self.left_keys if merge_keys else None
        self.schema = _join_schema(left.schema, right.schema, on, how)

    @property
    def num_partitions(self) -> int:
        return self.left.num_partitions

    def _right_table(self, pidx: int) -> HostTable:
        return _concat_or_empty(list(self.right.execute(pidx)),
                                self.right)

    def execute(self, pidx: int) -> Iterator[HostTable]:
        lt = _concat_or_empty(list(self.left.execute(pidx)), self.left)
        out = join_host_tables(lt, self._right_table(pidx), self.left_keys,
                               self.right_keys, self.how, self.condition,
                               self.merge_keys)
        yield HostTable(self.schema.names, out.columns)

    def node_desc(self):
        return f"{self.how} lkeys={self.left_keys} rkeys={self.right_keys}"


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """Equi-join with the build (right) side read whole, once, and joined
    to every left partition (reference: GpuBroadcastHashJoinExec.scala)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._broadcast: Optional[HostTable] = None

    def _right_table(self, pidx: int) -> HostTable:
        if self._broadcast is None:
            self._broadcast = _concat_or_empty(
                [b for p in range(self.right.num_partitions)
                 for b in self.right.execute(p)], self.right)
        return self._broadcast


def _concat_or_empty(batches: List[HostTable],
                     plan: PhysicalPlan) -> HostTable:
    return HostTable.concat(batches) if batches \
        else empty_result_table(plan.schema)
