"""Device window — the port of ``spark_rapids_tpu/exec/window.py``
(reference: GpuWindowExec.scala, the running window at :161,1346; frames
to scans and rolling reductions in GpuWindowExpression.scala).

A partition's batches concatenate into one; one sort (the port's chained
stable sorts, exec/sort.py) puts its rows in (partition, order) order, and
every window function is then data-parallel over that layout:

- segment starts, dense ranks, the first row of each peer group, running
  min/max and running or whole-partition float sums are segmented scans,
  ``seg_scan`` (csrc/window.cu);
- a bounded RANGE frame's bounds are binary searches, ``frame_bounds``;
- a bounded frame's min, max and float sum reduce the frame's own rows,
  ``frame_reduce``;
- counts and integer sums (decimals too) are differences of int64 prefix
  sums (``torch.cumsum``: exact, and wrapping as Spark's non-ANSI sums);
  segment and peer-group ends are reverse ``seg_scan`` mins; ranks, ntile
  and lag/lead are index arithmetic and gathers.

Two reference faults are not copied: the JAX package's float sums are
differences of prefix sums over the whole sorted batch (one partition's
large value wipes out the next partition's sums), and its running min/max
fill null rows with the type's finite extremes (a frame of -inf beside a
null gives -1.8e308). Min and max here follow Spark's order (NaN greatest,
-0.0 below 0.0), with an identity no value passes.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable,
                               concat_device_tables, torch_dtype)
from ..expr.aggregates import (AggregateFunction, Average, Count, CountStar,
                               Max, Min, Sum)
from ..expr.base import EvalContext, Literal
from ..expr.functions import SortOrder
from ..expr.window import (DenseRank, Lag, Lead, NTile, Rank, RowNumber,
                           WindowExpression)
from ..plan.physical import PhysicalPlan
from ..plan.schema import Field, Schema
from .base import TpuExec
from .sort import _order_keys, lexsort
from .window_kernels import frame_bounds, frame_reduce, seg_scan

__all__ = ["TpuWindowExec"]

_I64_MIN = -2**63
_I64_MAX = 2**63 - 1


def _eq_prev_values(values: torch.Tensor, lengths=None) -> torch.Tensor:
    """Equality with the previous row (Spark grouping: NaN == NaN, -0.0 ==
    0.0); a string compares its whole byte row and its length, a wide
    decimal both limbs."""
    v = values
    if v.dim() == 2:
        eq = (v == torch.roll(v, 1, 0)).all(dim=1)
        if lengths is not None:
            eq = eq & (lengths == torch.roll(lengths, 1))
        return eq
    if v.is_floating_point():
        v = torch.where(v == 0, torch.zeros_like(v), v)
        p = torch.roll(v, 1)
        return (v == p) | (torch.isnan(v) & torch.isnan(p))
    return v == torch.roll(v, 1)


def _changes(c, cap: int, device) -> torch.Tensor:
    """True where an evaluated key differs from the previous row's (nulls
    equal each other, and nothing else)."""
    eq = _eq_prev_values(c.values, c.lengths)
    valid = c.validity if c.validity is not None \
        else torch.ones(cap, dtype=torch.bool, device=device)
    null = ~valid
    pnull = torch.roll(null, 1)
    return ~torch.where(null | pnull, null & pnull, eq)


def _next_start(flags: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """For each row, the first flagged position after it (cap if none): the
    reverse min scan, over one segment, of each next row's position where
    it is flagged."""
    cap = flags.shape[0]
    nxt = torch.full_like(pos, cap)
    nxt[:-1] = torch.where(flags[1:], pos[1:], cap)
    return seg_scan(nxt, None, "min", reverse=True)


class TpuWindowExec(TpuExec):
    def __init__(self, child: PhysicalPlan,
                 window_cols: Sequence[Tuple[str, WindowExpression]]):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.window_cols = list(window_cols)
        fields = list(child.schema.fields)
        for name, w in self.window_cols:
            fields.append(Field(name, w.data_type, w.nullable))
        self.schema = Schema(fields)

    def node_desc(self):
        return ", ".join(n for n, _ in self.window_cols)

    @property
    def fusible(self) -> bool:
        return False  # a window needs its whole partition

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        batches = list(self.child_device_batches(pidx))
        if not batches:
            return
        table = concat_device_tables(batches) if len(batches) > 1 \
            else batches[0]
        out = self._window(table)
        self.account_batch()
        yield out

    def _window(self, table: DeviceTable) -> DeviceTable:
        spec = self.window_cols[0][1].spec
        cap, device = table.capacity, table.device
        # sort by (partition keys, order keys), real rows first
        orders = [SortOrder(e, True) for e in spec.partition_exprs] \
            + list(spec.orders)
        order = lexsort(_order_keys(table, orders))
        cols = tuple(c.gather(order) for c in table.columns)
        pos = torch.arange(cap, dtype=torch.int64, device=device)
        mask = pos < table.num_rows
        srt = DeviceTable(cols, mask, table.num_rows, table.names)
        ctx = EvalContext.for_device(srt)
        new_seg = torch.zeros(cap, dtype=torch.bool, device=device)
        for e in spec.partition_exprs:
            new_seg |= _changes(e.eval(ctx), cap, device)
        # the masked rows after the real ones are a segment of their own
        new_seg |= mask != torch.roll(mask, 1)
        new_seg[0] = True
        seg = _Segments(srt, new_seg, pos, mask)
        out_cols = list(srt.columns)
        for _, w in self.window_cols:
            out_cols.append(_window_column(seg, w))
        return DeviceTable(tuple(out_cols), mask, table.num_rows,
                           tuple(self.schema.names))


class _Segments:
    """The sorted batch and its partition segments: flags, each row's
    segment start and end (exclusive)."""

    def __init__(self, srt: DeviceTable, new_seg, pos, mask):
        self.srt = srt
        self.ctx = EvalContext.for_device(srt)
        self.new_seg = new_seg
        self.pos = pos
        self.mask = mask
        self.cap = srt.capacity
        self.device = srt.device
        self.start = seg_scan(torch.where(new_seg, pos,
                                          torch.zeros_like(pos)),
                              new_seg, "max")
        self._end = None
        self._peers = None

    @property
    def end(self) -> torch.Tensor:
        """Each row's segment end, on first use."""
        if self._end is None:
            self._end = _next_start(self.new_seg, self.pos)
        return self._end

    def peers(self, orders: Sequence[SortOrder]) -> torch.Tensor:
        """True where a peer group (distinct order keys) starts; the node's
        windows share one spec, so one computation serves them all."""
        if self._peers is None:
            flags = self.new_seg.clone()
            for o in orders:
                flags |= _changes(o.expr.eval(self.ctx), self.cap,
                                  self.device)
            flags[0] = True
            self._peers = flags
        return self._peers


def _window_column(seg: _Segments, w: WindowExpression) -> DeviceColumn:
    fn = w.fn
    cap, dev = seg.cap, seg.device
    pos_in_seg = seg.pos - seg.start
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    if isinstance(fn, RowNumber):
        return DeviceColumn((pos_in_seg + 1).to(torch.int32), ones, dt.INT,
                            True)
    if isinstance(fn, NTile):
        seg_len = seg.end - seg.start
        base = torch.div(seg_len, fn.n, rounding_mode="floor")
        rem = seg_len - base * fn.n
        cut = rem * (base + 1)
        tile = torch.where(
            pos_in_seg < cut,
            torch.div(pos_in_seg, torch.clamp(base + 1, min=1),
                      rounding_mode="floor"),
            rem + torch.div(pos_in_seg - cut, torch.clamp(base, min=1),
                            rounding_mode="floor"))
        return DeviceColumn((tile + 1).to(torch.int32), ones, dt.INT, True)
    if isinstance(fn, (Rank, DenseRank)):
        peers = seg.peers(w.spec.orders)
        if isinstance(fn, DenseRank):
            dr = seg_scan(peers.to(torch.int32), seg.new_seg, "add")
            return DeviceColumn(dr, ones, dt.INT, True)
        first = seg_scan(torch.where(peers, seg.pos,
                                     torch.zeros_like(seg.pos)),
                         seg.new_seg, "max")
        return DeviceColumn((first - seg.start + 1).to(torch.int32), ones,
                            dt.INT, True)
    if isinstance(fn, (Lag, Lead)):
        return _lag_lead(seg, fn)
    if isinstance(fn, AggregateFunction):
        return _agg_window(seg, w)
    raise NotImplementedError(type(fn).__name__)


def _lag_lead(seg: _Segments, fn) -> DeviceColumn:
    off = fn.offset if isinstance(fn, Lead) else -fn.offset
    c = fn.child.eval(seg.ctx)
    src = torch.clamp(seg.pos + off, 0, seg.cap - 1)
    in_seg = (seg.pos + off >= seg.start) & (seg.pos + off < seg.end)
    vals = c.values.index_select(0, src)
    valid = c.valid_mask(seg.ctx).index_select(0, src) & in_seg
    lengths = None if c.lengths is None else c.lengths.index_select(0, src)
    if fn.default is not None:
        d = Literal(fn.default, c.dtype).eval(seg.ctx)
        dv = d.values
        if vals.dim() == 2 and dv.shape[1] != vals.shape[1]:
            width = max(dv.shape[1], vals.shape[1])
            vals = torch.nn.functional.pad(vals, (0, width - vals.shape[1]))
            dv = torch.nn.functional.pad(dv, (0, width - dv.shape[1]))
        keep = in_seg.view(-1, *([1] * (vals.dim() - 1)))
        vals = torch.where(keep, vals, dv.to(vals.dtype))
        if lengths is not None:
            lengths = torch.where(in_seg, lengths, d.lengths)
        valid = valid | ~in_seg
    return DeviceColumn(vals.to(torch_dtype(c.dtype)), valid & seg.mask,
                        c.dtype, False, lengths)


def _frame(seg: _Segments, w: WindowExpression):
    """(lo, hi, kind) of every row: kind "prefix" when every frame starts at
    its segment's start (a scan's value at hi - 1 reduces it)."""
    frame = w.spec.frame
    if frame.is_unbounded_entire or (not w.spec.orders
                                     and frame.is_running):
        return seg.start, seg.end, "prefix"
    if frame.is_running:
        if frame.kind == "range" and w.spec.orders:
            hi = torch.minimum(_next_start(seg.peers(w.spec.orders), seg.pos),
                               seg.end)
        else:
            hi = seg.pos + 1
        return seg.start, hi, "prefix"
    if frame.kind == "rows":
        lo = seg.start if frame.start is None \
            else torch.maximum(seg.pos + frame.start, seg.start)
        hi = seg.end if frame.end is None \
            else torch.minimum(seg.pos + frame.end + 1, seg.end)
    elif frame.kind == "range" and len(w.spec.orders) == 1:
        sk, null_mask, scale = _range_sort_key(seg, w.spec.orders[0])

        def target(offset):
            t = sk + offset * scale
            return t if null_mask is None else torch.where(null_mask, sk, t)

        lo = seg.start if frame.start is None else frame_bounds(
            sk, target(frame.start), seg.start, seg.end, strict=False)
        hi = seg.end if frame.end is None else frame_bounds(
            sk, target(frame.end), seg.start, seg.end, strict=True)
    else:
        raise NotImplementedError(
            f"{type(w.fn).__name__} over {frame.describe()} on device")
    if frame.start is None:
        return lo, torch.maximum(hi, lo), "prefix"
    return lo, torch.maximum(hi, lo), "bounded"


def _range_sort_key(seg: _Segments, order: SortOrder):
    """A bounded RANGE frame's sort axis -> (key, null mask, scale), by the
    host engine's rules (plan/physical_window.py ``_range_sort_key``)."""
    c = order.expr.eval(seg.ctx)
    scale = 10 ** c.dtype.scale if isinstance(c.dtype, dt.DecimalType) else 1
    if c.values.is_floating_point():
        sk = c.values.to(torch.float64)
        sk = torch.where(torch.isnan(sk), torch.full_like(sk, float("inf")),
                         sk)
        lo_sent, hi_sent = float("-inf"), float("inf")
    else:
        sk = c.values.to(torch.int64)
        lo_sent, hi_sent = _I64_MIN, _I64_MAX
    if not order.ascending:
        sk = -sk
    null_mask = None
    if c.validity is not None:
        null_mask = ~c.validity
        sk = torch.where(null_mask, torch.full_like(
            sk, lo_sent if order.nulls_first else hi_sent), sk)
    return sk.contiguous(), null_mask, scale


def _agg_window(seg: _Segments, w: WindowExpression) -> DeviceColumn:
    fn = w.fn
    cap, dev, mask = seg.cap, seg.device, seg.mask
    if isinstance(fn, CountStar):
        vals = torch.ones(cap, dtype=torch.int64, device=dev)
        valid = mask
    else:
        c = fn.children[0].eval(seg.ctx)
        vals = c.values
        valid = c.valid_mask(seg.ctx) & mask
    out_dt = fn.data_type
    lo, hi, kind = _frame(seg, w)
    frame = w.spec.frame
    # a ROWS frame bounded at both ends: no frame longer than its offsets
    max_len = frame.end - frame.start + 1 if frame.kind == "rows" \
        and frame.start is not None and frame.end is not None else None

    def prefix_count() -> torch.Tensor:
        """The frames' valid rows as a difference of prefix counts (a
        bounded frame's float sum, min and max take frame_reduce's)."""
        ccnt = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(valid.to(torch.int64), 0)])
        return ccnt[hi] - ccnt[lo]
    if isinstance(fn, (Count, CountStar)):
        return DeviceColumn(prefix_count(), torch.ones(
            cap, dtype=torch.bool, device=dev), dt.LONG, True)
    if isinstance(fn, (Min, Max)):
        op = "min" if isinstance(fn, Min) else "max"
        x = (vals.to(torch.float64) if vals.is_floating_point()
             else vals.to(torch.int64)).contiguous()
        if kind == "prefix":
            ident = torch.full_like(
                x, (float("nan") if op == "min" else float("-inf"))
                if x.is_floating_point()
                else (_I64_MAX if op == "min" else _I64_MIN))
            run = seg_scan(torch.where(valid, x, ident), seg.new_seg, op)
            out = run[torch.clamp(hi - 1, 0, cap - 1)]
            cnt = prefix_count()
        else:
            out, cnt = frame_reduce(x, valid, lo, hi, op, max_len)
        return DeviceColumn(out.to(torch_dtype(out_dt)), (cnt > 0) & mask,
                            out_dt)
    if not isinstance(fn, (Sum, Average)):
        raise NotImplementedError(type(fn).__name__)
    if vals.is_floating_point():
        x = torch.where(valid, vals.to(torch.float64),
                        torch.zeros(cap, dtype=torch.float64, device=dev))
        if kind == "prefix":
            run = seg_scan(x, seg.new_seg, "add")
            s = run[torch.clamp(hi - 1, 0, cap - 1)]
            cnt = prefix_count()
        else:
            s, cnt = frame_reduce(x, valid, lo, hi, "add", max_len)
    else:
        x = torch.where(valid, vals.to(torch.int64),
                        torch.zeros(cap, dtype=torch.int64, device=dev))
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(x, 0)])
        s = csum[hi] - csum[lo]
        cnt = prefix_count()
    if isinstance(fn, Sum):
        return DeviceColumn(s.to(torch_dtype(out_dt)), (cnt > 0) & mask,
                            out_dt)
    avg = s.to(torch.float64)
    if isinstance(fn.children[0].data_type, dt.DecimalType):
        # the value's average, not the scaled integers' (the JAX package
        # divides the scaled sum)
        avg = avg / 10.0 ** fn.children[0].data_type.scale
    avg = avg / torch.clamp(cnt, min=1)
    return DeviceColumn(avg, (cnt > 0) & mask, dt.DOUBLE)
