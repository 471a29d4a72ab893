"""The host engine's window — the port of
``spark_rapids_tpu/plan/physical_window.py`` (reference: the CPU side of
GpuWindowExec.scala and GpuWindowExpression.scala's frame semantics).

Rows are sorted by (partition keys, order keys); the output is in that
order with the window columns appended. Frames: the whole partition, the
running frame (RANGE UNBOUNDED PRECEDING..CURRENT ROW takes the peer rows
in), and bounded ROWS and RANGE frames.

Every frame is a row range ``[lo, hi)`` and reduces the same way. Counts
and integer sums are differences of prefix sums (exact: int64 wraps, as
Spark's non-ANSI sums do). A float sum, a min and a max reduce the frame's
own rows, as power-of-two blocks of its length: the JAX package's float
sums are differences of prefix sums over the whole sorted batch, so one
partition's large value wipes out the next partition's sums, and its
min/max leave no room for an all-NaN or +-inf frame beside a null
(ROADMAP's reference faults). Min and max reduce Spark's order keys of
floats (NaN greatest, -0.0 below 0.0), as the port's aggregates do.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable
from ..expr.aggregates import (AggregateFunction, Average, Count, CountStar,
                               Max, Min, Sum)
from ..expr.base import AttributeReference, EvalContext
from ..expr.functions import SortOrder
from ..expr.window import (DenseRank, Lag, Lead, NTile, Rank, RowNumber,
                           WindowExpression)
from .host_groupby import _float_order_key, group_codes
from .physical import (PhysicalPlan, _sort_indices, empty_result_table,
                       host_eval_exprs)
from .schema import Field, Schema

__all__ = ["CpuWindowExec"]

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


class CpuWindowExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 window_cols: Sequence[Tuple[str, WindowExpression]]):
        self.child = child
        self.children = (child,)
        self.window_cols = list(window_cols)
        fields = list(child.schema.fields)
        for name, w in self.window_cols:
            fields.append(Field(name, w.data_type, w.nullable))
        self.schema = Schema(fields)

    def node_desc(self):
        return ", ".join(n for n, _ in self.window_cols)

    def execute(self, pidx: int) -> Iterator[HostTable]:
        batches = list(self.child.execute(pidx))
        if not batches:
            return
        table = HostTable.concat(batches)
        n = table.num_rows
        if n == 0:
            yield empty_result_table(self.schema)
            return
        spec = self.window_cols[0][1].spec
        part_names = [f"_wpart{i}" for i in range(len(spec.partition_exprs))]
        if part_names:
            extra = host_eval_exprs(table, list(spec.partition_exprs),
                                    part_names)
            table = HostTable(list(table.names) + part_names,
                              list(table.columns) + list(extra.columns))
        orders = [SortOrder(AttributeReference(
            p, table.column(p).dtype, True), True) for p in part_names] \
            + list(spec.orders)
        idx = _sort_indices(table, orders) if orders else np.arange(n)
        srt = table.take(idx)
        gid = group_codes(srt, part_names)[0]
        new_seg = np.ones(n, dtype=bool)
        new_seg[1:] = gid[1:] != gid[:-1]
        pos = np.arange(n, dtype=np.int64)
        seg_start = np.maximum.accumulate(np.where(new_seg, pos, 0))
        seg_end = _next_start(new_seg)
        out_cols: List[HostColumn] = [srt.column(c)
                                      for c in self.child.schema.names]
        for _, w in self.window_cols:
            out_cols.append(_window_column(srt, w, new_seg, seg_start,
                                           seg_end, pos))
        yield HostTable(self.schema.names, out_cols)


def _next_start(flags: np.ndarray) -> np.ndarray:
    """For each row, the first flagged position after it (n if none)."""
    n = len(flags)
    nxt = np.where(flags, np.arange(n, dtype=np.int64), n)
    after = np.full(n, n, dtype=np.int64)
    if n > 1:
        after[:-1] = np.minimum.accumulate(nxt[::-1])[::-1][1:]
    return after


def _peer_starts(srt: HostTable, spec, new_seg: np.ndarray) -> np.ndarray:
    """True where a peer group (equal order keys: NaN == NaN, -0.0 == 0.0,
    null == null) starts."""
    peers = new_seg.copy()
    ctx = EvalContext.for_host(srt)
    for o in spec.orders:
        c = o.expr.eval(ctx)
        v = np.asarray(c.values)
        valid = c.validity if c.validity is not None \
            else np.ones(len(v), dtype=bool)
        if v.dtype.kind == "f":
            same = (v[1:] == v[:-1]) | (np.isnan(v[1:]) & np.isnan(v[:-1]))
        else:
            same = v[1:] == v[:-1]
        same = np.where(valid[1:] & valid[:-1], same,
                        ~valid[1:] & ~valid[:-1])
        peers[1:] |= ~same
    return peers


def _window_column(srt: HostTable, w: WindowExpression, new_seg, seg_start,
                   seg_end, pos) -> HostColumn:
    fn = w.fn
    n = len(pos)
    pos_in_seg = pos - seg_start
    if isinstance(fn, RowNumber):
        return HostColumn(dt.INT, (pos_in_seg + 1).astype(np.int32))
    if isinstance(fn, NTile):
        seg_len = seg_end - seg_start
        base = seg_len // fn.n
        rem = seg_len % fn.n
        cut = rem * (base + 1)
        # Spark: the first (len % k) buckets get one row more
        tile = np.where(pos_in_seg < cut,
                        pos_in_seg // np.maximum(base + 1, 1),
                        rem + (pos_in_seg - cut) // np.maximum(base, 1))
        return HostColumn(dt.INT, (tile + 1).astype(np.int32))
    if isinstance(fn, (Lag, Lead)):
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        src = np.clip(pos + off, 0, max(n - 1, 0))
        in_seg = (pos + off >= seg_start) & (pos + off < seg_end)
        c = fn.child.eval(EvalContext.for_host(srt))
        vals = np.asarray(c.values)[src]
        valid = (c.validity[src] if c.validity is not None
                 else np.ones(n, dtype=bool)) & in_seg
        if fn.default is not None:
            vals = vals.copy()
            vals[~in_seg] = fn.default
            valid = valid | ~in_seg
        return HostColumn(c.dtype, vals, None if valid.all() else valid)
    if isinstance(fn, (Rank, DenseRank)):
        peers = _peer_starts(srt, w.spec, new_seg)
        if isinstance(fn, DenseRank):
            codes = np.cumsum(peers)
            return HostColumn(dt.INT,
                              (codes - codes[seg_start] + 1).astype(np.int32))
        first = np.maximum.accumulate(np.where(peers, pos, 0))
        return HostColumn(dt.INT, (first - seg_start + 1).astype(np.int32))
    if isinstance(fn, AggregateFunction):
        return _agg_window(srt, w, new_seg, seg_start, seg_end, pos)
    raise NotImplementedError(type(fn).__name__)


def _frame(srt: HostTable, w: WindowExpression, new_seg, seg_start, seg_end,
           pos):
    """The frame ``[lo, hi)`` of every row."""
    frame = w.spec.frame
    if frame.is_unbounded_entire or (not w.spec.orders
                                     and frame.start is None
                                     and frame.end == 0):
        return seg_start, seg_end
    if frame.is_running:
        if frame.kind == "range" and w.spec.orders:
            # the end of the row's peer group
            hi = np.minimum(_next_start(_peer_starts(srt, w.spec, new_seg)),
                            seg_end)
        else:
            hi = pos + 1
        return seg_start, hi
    if frame.kind == "rows":
        lo = seg_start if frame.start is None \
            else np.maximum(pos + frame.start, seg_start)
        hi = seg_end if frame.end is None \
            else np.minimum(pos + frame.end + 1, seg_end)
        return lo, np.maximum(hi, lo)
    if frame.kind == "range" and len(w.spec.orders) == 1:
        sk, null_mask, scale = _range_sort_key(srt, w.spec.orders[0])
        lo = seg_start if frame.start is None else _bsearch(
            sk, _range_target(sk, frame.start * scale, null_mask),
            seg_start, seg_end, strict=False)
        hi = seg_end if frame.end is None else _bsearch(
            sk, _range_target(sk, frame.end * scale, null_mask),
            seg_start, seg_end, strict=True)
        return lo, np.maximum(hi, lo)
    raise NotImplementedError(f"frame {frame.describe()}")


def _agg_window(srt: HostTable, w: WindowExpression, new_seg, seg_start,
                seg_end, pos) -> HostColumn:
    fn = w.fn
    n = srt.num_rows
    if isinstance(fn, CountStar):
        vals = np.ones(n, dtype=np.int64)
        valid = np.ones(n, dtype=bool)
    else:
        c = fn.children[0].eval(EvalContext.for_host(srt))
        vals = np.asarray(c.values)
        valid = c.validity if c.validity is not None \
            else np.ones(n, dtype=bool)
    out_dt = fn.data_type
    lo, hi = _frame(srt, w, new_seg, seg_start, seg_end, pos)
    if isinstance(fn, (Count, CountStar)):
        ccnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
        return HostColumn(dt.LONG, (ccnt[hi] - ccnt[lo]).astype(np.int64))
    if isinstance(fn, (Min, Max)):
        op = "min" if isinstance(fn, Min) else "max"
        if vals.dtype.kind == "f":
            red, cnt = _frame_reduce(_order_key(vals), valid, lo, hi, op)
            out = _from_order_key(red).astype(vals.dtype)
        else:
            out, cnt = _frame_reduce(vals.astype(np.int64), valid, lo, hi,
                                     op)
        has = cnt > 0
        return HostColumn(out_dt, _cast_np(out, out_dt),
                          None if has.all() else has)
    if not isinstance(fn, (Sum, Average)):
        raise NotImplementedError(type(fn).__name__)
    if vals.dtype.kind == "f":
        s, cnt = _frame_reduce(vals.astype(np.float64), valid, lo, hi, "add")
    else:
        x = np.where(valid, vals, 0).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(x)])
        ccnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
        s = csum[hi] - csum[lo]
        cnt = ccnt[hi] - ccnt[lo]
    has = cnt > 0
    if isinstance(fn, Sum):
        return HostColumn(out_dt, _cast_np(s, out_dt),
                          None if has.all() else has)
    avg = s.astype(np.float64)
    if isinstance(fn.children[0].data_type, dt.DecimalType):
        # the value's average, not the scaled integers'
        avg = avg / 10.0 ** fn.children[0].data_type.scale
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = avg / cnt
    return HostColumn(dt.DOUBLE, avg, None if has.all() else has)


def _order_key(v: np.ndarray) -> np.ndarray:
    """Spark's order of floats as int64 keys (NaN greatest, -0.0 below
    0.0)."""
    d = v.astype(np.float64)
    return np.where(np.isnan(d), _I64_MAX, _float_order_key(d))


def _from_order_key(k: np.ndarray) -> np.ndarray:
    out = _float_order_key(k).view(np.float64).copy()
    out[k == _I64_MAX] = np.nan
    return out


def _apply(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    if op == "add":
        return a + b
    return np.minimum(a, b) if op == "min" else np.maximum(a, b)


def _frame_reduce(x: np.ndarray, valid: np.ndarray, lo, hi, op: str):
    """``op`` over the valid rows of each ``[lo, hi)`` (x: float64 for
    "add", int64 keys for "min" and "max"), taken as the power-of-two
    blocks of the frame's length, smallest first; a level of blocks is
    built from the last by one doubling -> (values, counts)."""
    n = len(x)
    ident = {"add": 0.0, "min": _I64_MAX, "max": _I64_MIN}[op]
    lv = np.where(valid, x, ident).astype(x.dtype)
    lc = valid.astype(np.int64)
    length = hi - lo
    acc = np.full(n, ident, dtype=x.dtype)
    cnt = np.zeros(n, dtype=np.int64)
    cur = np.asarray(lo, dtype=np.int64).copy()
    k = 0
    with np.errstate(invalid="ignore", over="ignore"):
        while n and (1 << k) <= n:
            take = ((length >> k) & 1).astype(bool)
            idx = np.minimum(cur, n - 1)
            acc = np.where(take, _apply(acc, lv[idx], op), acc)
            cnt += np.where(take, lc[idx], 0)
            cur += take.astype(np.int64) << k
            s = 1 << k
            if s < n:
                lv = np.concatenate([_apply(lv[:n - s], lv[s:], op),
                                     lv[n - s:]])
                lc = np.concatenate([lc[:n - s] + lc[s:], lc[n - s:]])
            k += 1
    return acc, cnt


def _range_sort_key(srt: HostTable, order):
    """The sort axis of a bounded RANGE frame -> (key, null mask, scale).

    Integral, date and decimal keys stay int64 (no 2^53 float loss; decimal
    offsets scale by 10^scale, so bounds are in value units); float keys
    are float64 with NaN at the top. DESC negates, so offsets apply along
    the sort direction; null keys become the sentinel at their end, one
    peer window (Spark: a null key's RANGE window is its null peers)."""
    c = order.expr.eval(EvalContext.for_host(srt))
    vals = np.asarray(c.values)
    scale = 10 ** c.dtype.scale if isinstance(c.dtype, dt.DecimalType) else 1
    if vals.dtype.kind == "f":
        sk = np.where(np.isnan(vals), np.inf, vals.astype(np.float64))
        lo_sent, hi_sent = -np.inf, np.inf
    else:
        sk = vals.astype(np.int64)
        lo_sent, hi_sent = _I64_MIN, _I64_MAX
    with np.errstate(over="ignore"):
        if not order.ascending:
            sk = -sk
    null_mask = None
    if c.validity is not None and not c.validity.all():
        null_mask = ~c.validity
        sk = np.where(null_mask, lo_sent if order.nulls_first else hi_sent,
                      sk)
    return sk, null_mask, scale


def _range_target(sk, offset, null_mask):
    """sk + offset; a null row keeps its sentinel."""
    with np.errstate(over="ignore"):
        t = sk + offset
    return t if null_mask is None else np.where(null_mask, sk, t)


def _bsearch(sk, target, lo0, hi0, strict: bool):
    """The first position of each [lo0, hi0) with sk >= target (> when
    ``strict``): a vectorized binary search."""
    lo = np.asarray(lo0, dtype=np.int64).copy()
    hi = np.asarray(hi0, dtype=np.int64).copy()
    n = len(sk)
    for _ in range(max(1, int(n).bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        mv = sk[np.clip(mid, 0, max(n - 1, 0))]
        right = (mv <= target) if strict else (mv < target)
        lo = np.where(active & right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return lo


def _cast_np(vals: np.ndarray, out_dt) -> np.ndarray:
    want = out_dt.np_dtype()
    if dt.is_d128(out_dt):
        return np.array([int(v) for v in vals], dtype=object)
    if vals.dtype == want:
        return vals
    with np.errstate(invalid="ignore"):
        return vals.astype(want)
