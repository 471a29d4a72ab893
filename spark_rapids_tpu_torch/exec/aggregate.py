"""Device hash aggregate — the port of ``spark_rapids_tpu/exec/aggregate.py``
(reference: aggregate.scala, GpuHashAggregateIterator at :181,
GpuHashAggregateExec at :1319) for sum, count, min, max, first, last and the
moments of the variance family, with or without grouping keys.

Key columns become equality words (``_key_small_fields``), and
``spark.rapids.tpu.groupby.strategy`` picks the grouping, as in the JAX
package: ``hash`` (and ``auto``) hashes the words into row-count buckets
and resolves each bucket's minimum-index candidate's whole key class in
rounds until no row is left, so group ids come out in order of first
appearance; ``sort`` sorts the rows by their words (stable argsorts from
the least significant word up, a string's or a flag word's bits as
unsigned) and numbers the runs, so groups come out in key order. Per-group
reductions then run as ``index_add_`` / ``scatter_reduce_`` over the group
ids (float sums through a sort and a segmented reduction, so that on the
card they are the same in every run), and each group's key is gathered
from its first row. ``first`` and ``last`` take the group's first and last
contributing row by position, whatever the strategy. A group's moments
are its count, its mean (about its first value) and M2, the sum of squared
deviations from that mean; a merge combines them by Chan's formula.

The partial pass fuses into the whole-stage node above the upload and
emits one aggregated batch per input batch; the final pass concatenates
what it receives and merges as it goes, shrinking the running state to the
bucket of its group count. The running state is registered with the spill
catalog between chunks (``ACTIVE_ON_DECK``), each chunk aggregates under
the retry ladder (a partial pass splits: its half states merge again), and
each merge spills and retries; a terminal failure feeds the quarantine
store. The partial pass's host twin is the host engine's aggregate of one
batch (``host_batch_fn``), its runtime fallback.

Torch lacks shifts, remainders and order on unsigned integers, so the
JAX package's uint64 key words ride int64 tensors bit for bit and its
uint32 hash arithmetic rides int64 in ``[0, 2**32)`` (shuffle/manager.py).

Decimals: a decimal64 key or value is an int64 plane; a wide decimal
(p > 18) key groups by its two key words (``d128_key_words``), and its sum
runs on the ``d128_segment_sum`` kernel (count needs no values; any other
op over a wide decimal is tagged to the host). An overflowed sum is null.
Unlike the JAX package, an overflowed partial sum also makes its group's
final sum null: its null state row carries a mark in its limbs (10^38, a
value no valid state holds), and the final merge reads it, where the JAX
package skips the row as if the partition held none of the group's rows
(Spark's merge: ``bufferOverflow || inputOverflow`` gives null).
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable,
                               concat_device_tables, pack_string_key_words,
                               shrink_to_fit, torch_dtype)
from ..conf import STEP_BREADTH, not_ported
from ..expr.decimal128 import (SUM_OVERFLOW_MARK, d128_key_words,
                               d128_overflows, d128_segment_sum,
                               limbs_from_py_ints)
from ..memory.catalog import SpillPriorities, get_catalog
from ..plan.physical import (AggSpec, PhysicalPlan, aggregate_columns_ops,
                             host_aggregate, op_refs,
                             aggregate_schema, check_mode)
from ..plan.schema import Schema
from ..shuffle.manager import MASK32, fmix_device
from .base import TpuExec

__all__ = ["TpuHashAggregateExec"]

#: capacity of the one-state-row output batch
_STATE_CAPACITY = 8
#: input capacity the aggregate gathers before one reduction
_CHUNK_CAPACITY = 1 << 20
_BIG = 2**62
_COLLECT_OPS = frozenset(
    {"collect_list", "collect_set", "merge_lists", "merge_sets"})
_FIXED_WIDTH = (dt.BooleanType, dt.IntegralType, dt.FractionalType,
                dt.DateType, dt.TimestampType, dt.NullType, dt.DecimalType)
#: the limbs of ``SUM_OVERFLOW_MARK`` (see the module docstring)
_MARK_LIMBS = limbs_from_py_ints([SUM_OVERFLOW_MARK], 1)[0].tolist()
#: device -> ``_MARK_LIMBS`` on it, made once: a tensor built from a list
#: is a copy from pageable host memory, which waits for the stream
_MARK_ON: dict = {}


def _minmax_identity(dtype: torch.dtype, for_min: bool):
    """The value a non-contributing row holds in a min or max: +-inf for
    floats. (The JAX package uses the largest finite double there, so a
    group whose contributions are all +inf, beside a null or masked-off
    row, gets a min of 1.8e308 from it where Spark and both host engines
    give inf; see the grouped query test.)"""
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _normalize_float_key(v: torch.Tensor) -> torch.Tensor:
    if v.dtype.is_floating_point:
        v = torch.where(v == 0, torch.zeros_like(v), v)
    return v


def _key_code_words(kc: DeviceColumn
                    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Column -> (1-D equality words most-significant first, optional NaN
    flag). Strings pack 8 bytes per word plus the length as the last word;
    a wide decimal gives its two key words; floats map -0.0 to 0.0 and NaN
    to inf (the NaN flag keeps it apart)."""
    if isinstance(kc.dtype, dt.StringType):
        return pack_string_key_words(kc.data, kc.lengths), None
    if dt.is_d128(kc.dtype):
        return d128_key_words(kc.data), None
    if not isinstance(kc.dtype, _FIXED_WIDTH):
        raise NotImplementedError(
            f"group-by keys of type {kc.dtype!r} are not ported yet "
            + not_ported(STEP_BREADTH))
    v = _normalize_float_key(kc.data)
    if v.dtype.is_floating_point:
        nan = torch.isnan(v)
        return [torch.where(nan, torch.full_like(v, float("inf")), v)], nan
    return [v], None


def _key_small_fields(kc: DeviceColumn):
    """Column -> (value words, [(small_field, nbits), ...]): the small
    fields (null flag, string length, NaN flag) need only a few bits each,
    and the caller packs them into shared meta words. Value words are
    zeroed on null rows so null-key groups cannot split on stale plane
    contents."""
    valid = kc.validity
    smalls = [(torch.logical_not(valid).to(torch.int64), 1)]

    def z(w):
        return torch.where(valid, w, torch.zeros_like(w))

    if isinstance(kc.dtype, dt.StringType):
        width = kc.data.shape[1]
        words = [z(x) for x in
                 pack_string_key_words(kc.data, kc.lengths)[:-1]]
        smalls.append((z(kc.lengths.to(torch.int64)),
                       max(int(width).bit_length(), 1)))
        return words, smalls
    words, nan = _key_code_words(kc)
    words = [z(x) for x in words]
    if nan is not None:
        smalls.append((torch.logical_and(nan, valid).to(torch.int64), 1))
    return words, smalls


def _pack_meta_words(bit_fields) -> List[torch.Tensor]:
    """[(int64 field, nbits), ...] -> int64 words holding the JAX package's
    uint64 bit patterns, most-significant field first; a new word starts
    when 64 bits fill up. Equality over the words == equality over the
    fields."""
    words: List[torch.Tensor] = []
    acc = None
    used = 0
    for field, nbits in bit_fields:
        if acc is None or used + nbits > 64:
            if acc is not None:
                words.append(acc << (64 - used))
            acc = field
            used = nbits
        else:
            acc = (acc << nbits) | field
            used += nbits
    if acc is not None:
        words.append(acc << (64 - used))
    return words


def _word_bits_u32(w: torch.Tensor) -> torch.Tensor:
    """Equality word -> its uint32 hash contribution (bit-exact per value),
    as int64 in ``[0, 2**32)``."""
    if w.dtype == torch.float32:
        return w.view(torch.int32).to(torch.int64) & MASK32
    if w.dtype == torch.bool:
        return w.to(torch.int64)
    u = w.to(torch.float64).view(torch.int64) if w.dtype.is_floating_point \
        else w.to(torch.int64)
    # arithmetic shift, then the mask: a logical shift of the uint64 bits
    return (u & MASK32) ^ ((u >> 32) & MASK32)


def _hash_group_ids(table: DeviceTable, key_names: List[str]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free exact grouping -> (gid int32 per row, is_rep bool per row,
    num_groups 0-d int32).

    Keys hash into row-count buckets; each round, every bucket's
    minimum-index unresolved row wins, and the rows whose key words all
    equal the winner's resolve to it; the rest rehash. Rows of one key
    share a bucket in every round, so a key resolves all at once to its
    first row: ``gid`` is the rank of first appearance, whatever the hash
    or the number of rounds. The loop reads ``unresolved.any()`` on the
    host once per round."""
    cap = table.capacity
    active = table.row_mask
    device = active.device
    bit_fields = []
    words: List[torch.Tensor] = []
    for k in key_names:
        value_words, smalls = _key_small_fields(table.column(k))
        words.extend(value_words)
        bit_fields.extend(smalls)
    words += _pack_meta_words(bit_fields)

    h = torch.zeros(cap, dtype=torch.int64, device=device)
    for i, w in enumerate(words):
        h = h ^ fmix_device(_word_bits_u32(w) ^ (i + 1))
        h = (h * 5 + 0xE6546B64) & MASK32

    iota = torch.arange(cap, dtype=torch.int64, device=device)
    winner = iota
    unresolved = active
    r = 0
    while r < cap and bool(unresolved.any()):
        hr = fmix_device(h ^ ((r * 2654435761) & MASK32))
        bucket = hr % cap
        cand_src = torch.where(unresolved, iota, cap)
        cand = torch.full((cap,), cap, dtype=torch.int64, device=device) \
            .scatter_reduce_(0, bucket, cand_src, "amin", include_self=True)
        w = cand[bucket]
        w_safe = w.clamp(0, cap - 1)
        eq = torch.logical_and(unresolved, w < cap)
        for word in words:
            eq = torch.logical_and(eq, word == word[w_safe])
        winner = torch.where(eq, w_safe, winner)
        unresolved = torch.logical_and(unresolved, torch.logical_not(eq))
        r += 1
    is_rep = torch.logical_and(active, winner == iota)
    rep_rank = torch.cumsum(is_rep.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = rep_rank[winner].clamp(0, cap - 1)
    return gid, is_rep, is_rep.sum(dtype=torch.int32)


def _sorted_group_ids(table: DeviceTable, key_names: List[str]
                      ) -> Tuple[torch.Tensor, None, torch.Tensor]:
    """Sort-based exact grouping -> (gid int32 per row, None, num_groups
    0-d int32): the rows sorted by (not active, the keys' flag words, the
    value words), as the JAX package's ``_sorted_group_ids`` lexsorts
    them; a group is a run of equal words among the active rows, and group
    ids follow the sorted order. Stable argsorts from the least significant
    word up make the lexicographic order; words holding uint64 bits (a
    string's packed bytes, the flag words) sort with their sign bit
    flipped, as unsigned values."""
    cap = table.capacity
    active = table.row_mask
    device = active.device
    bit_fields = [(torch.logical_not(active).to(torch.int64), 1)]
    words: List[Tuple[torch.Tensor, bool]] = []
    for k in key_names:
        kc = table.column(k)
        value_words, smalls = _key_small_fields(kc)
        unsigned = isinstance(kc.dtype, dt.StringType)
        words.extend((w, unsigned) for w in value_words)
        bit_fields.extend(smalls)
    meta = [(w, True) for w in _pack_meta_words(bit_fields)]
    order = torch.arange(cap, dtype=torch.int64, device=device)
    # least significant first: the value words last to first, then the
    # meta words (meta word 0, the not-active flag, most significant)
    for w, unsigned in list(reversed(words)) + list(reversed(meta)):
        key = w[order]
        if unsigned:
            key = key ^ (-2**63)
        order = order[torch.argsort(key, stable=True)]
    active_s = active[order]
    same = torch.ones(cap, dtype=torch.bool, device=device)
    for w, _ in words + meta:
        ws = w[order]
        same[1:] &= ws[1:] == ws[:-1]
    same[:1] = False
    boundary = torch.logical_and(torch.logical_not(same), active_s)
    gid_s = (torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32)
             - 1).clamp(0, max(cap - 1, 0))
    gid = torch.empty_like(gid_s)
    gid[order] = gid_s
    return gid, None, boundary.sum(dtype=torch.int32)


def _seg_sum(x: torch.Tensor, gid: torch.Tensor, cap: int,
             segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """Per-group sum; one segment is a plain reduction. A float sum is
    ``_seg_sum_sorted``: ``index_add_`` on the card adds with atomics, in
    an order that changes from run to run, and two evaluations of one sum
    must agree to the last bit (TPC-H Q15 compares a group's revenue with
    the maximum of the same revenues, computed by its scalar subquery).
    ``segments``: ``sorted_segments(gid, cap)``, when the caller has it."""
    if cap == 1:
        return x.sum(0, keepdim=True, dtype=x.dtype)
    if x.is_floating_point():
        return _seg_sum_sorted(x, gid, cap, segments)
    return torch.zeros(cap, dtype=x.dtype, device=x.device) \
        .index_add_(0, gid.long(), x)


def sorted_segments(gid: torch.Tensor,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the rows' stable order by group, each group's row count): one sort
    that every float sum over the same group ids can share."""
    g = gid.long()
    order = torch.argsort(g, stable=True)
    bounds = torch.searchsorted(
        g[order], torch.arange(cap + 1, dtype=torch.int64, device=g.device))
    return order, bounds[1:] - bounds[:-1]


def _seg_sum_sorted(x: torch.Tensor, gid: torch.Tensor, cap: int,
                    segments: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Per-group sum that is the same in every run: the rows sorted by
    group (stably), then one segmented reduction over each group's run."""
    order, lengths = segments if segments is not None \
        else sorted_segments(gid, cap)
    return torch.segment_reduce(x[order], "sum", lengths=lengths,
                                unsafe=True, initial=0)


def _seg_extreme(x: torch.Tensor, gid: torch.Tensor, cap: int,
                 for_min: bool, ident=None) -> torch.Tensor:
    """Per-group min or max. Empty groups hold the identity (``ident``, by
    default ``_minmax_identity``), as the JAX package's
    segment_min/segment_max leave there."""
    if cap == 1:
        return x.amin(0, keepdim=True) if for_min \
            else x.amax(0, keepdim=True)
    if ident is None:
        ident = _minmax_identity(x.dtype, for_min)
    return torch.full((cap,), ident, dtype=x.dtype, device=x.device) \
        .scatter_reduce_(0, gid.long(), x, "amin" if for_min else "amax",
                         include_self=True)


def _float_order_key(x: torch.Tensor,
                     inverse: Optional[torch.dtype] = None) -> torch.Tensor:
    """A float tensor's bits as a signed integer whose order is the floats'
    with -0.0 below 0.0 (a negative's magnitude bits flipped); with
    ``inverse``, the integer keys back to floats of that type."""
    if inverse is None:
        x = x.view(torch.int64 if x.element_size() == 8 else torch.int32)
    bits = 8 * x.element_size()
    key = x ^ ((x >> (bits - 1)) & (2 ** (bits - 1) - 1))
    return key if inverse is None else key.view(inverse)


def _mark_limbs(device: torch.device) -> torch.Tensor:
    mark = _MARK_ON.get(device)
    if mark is None:
        mark = _MARK_ON[device] = torch.tensor(_MARK_LIMBS, dtype=torch.int64,
                                               device=device)
    return mark


def _d128_sum(vals: torch.Tensor, contrib: torch.Tensor, gid: torch.Tensor,
              cap: int, out_dt: dt.DecimalType, has: torch.Tensor,
              merge_active: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A wide-decimal sum on the kernel -> (limbs[cap], validity[cap]): an
    overflowed group is null and holds ``SUM_OVERFLOW_MARK``. ``merge_active``
    (a final merge's row mask) makes a group null whose marked null state
    row it holds."""
    limbs, over = d128_segment_sum(vals.contiguous(), contrib.contiguous(),
                                   gid.contiguous(), cap, out_dt.precision)
    if merge_active is not None:
        marked = torch.logical_and(
            torch.logical_and(merge_active, torch.logical_not(contrib)),
            d128_overflows(vals, out_dt.precision))
        over = torch.logical_or(
            over, _seg_sum(marked.to(torch.int64), gid, cap) > 0)
    limbs = torch.where(over[:, None], _mark_limbs(vals.device), limbs)
    return limbs, torch.logical_and(has, torch.logical_not(over))


def _refs(table: DeviceTable, op: str) -> List[torch.Tensor]:
    """The value planes of the sibling state columns ``op`` names."""
    return [table.column(name).data for name in op_refs(op)]


def _pick_index(contrib: torch.Tensor, gid: torch.Tensor, cap: int,
                last: bool) -> torch.Tensor:
    """Each group's first (or last) contributing row; 0 for an empty
    group."""
    pos = torch.arange(contrib.shape[0], dtype=torch.int64,
                       device=contrib.device)
    p = torch.where(contrib, -pos if last else pos, _BIG)
    best = _seg_extreme(p, gid, cap, True)
    return (-best if last else best).clamp(0, max(contrib.shape[0] - 1, 0))


def _moment_mean(x: torch.Tensor, w: torch.Tensor, contrib: torch.Tensor,
                 gid: torch.Tensor, cap: int, segments) -> torch.Tensor:
    """The w-weighted mean of x in each group, taken about the group's
    first contributing x (so equal values give it exactly); NaN for an
    empty group."""
    pivot = x[_pick_index(contrib, gid, cap, False)]
    g = gid.long()
    d = torch.where(contrib, w * (x - pivot[g]), 0.0)
    total = _seg_sum(torch.where(contrib, w, 0.0), gid, cap, segments)
    return pivot + _seg_sum(d, gid, cap, segments) / total


def _moments(op: str, x: torch.Tensor, contrib: torch.Tensor,
             gid: torch.Tensor, cap: int, refs: List[torch.Tensor],
             segments) -> torch.Tensor:
    """A group's mean or M2 from rows (``moment_mean``, ``moment_m2``) or
    from partial states (the ``_merge`` ops: ``refs`` holds the counts, and
    for M2 the means): Chan's merge."""
    name = op.split(":")[0]
    x = x.to(torch.float64)
    merge = name.endswith("_merge")
    w = refs[0].to(torch.float64) if merge else torch.ones_like(x)
    if name.startswith("moment_mean"):
        return _moment_mean(x, w, contrib, gid, cap, segments)
    # M2: the rows' (or the states' own M2 plus their means') squared
    # deviations from the group's mean
    means = refs[1].to(torch.float64) if merge else x
    mean = _moment_mean(means, w, contrib, gid, cap, segments)
    dev = means - mean[gid.long()]
    sq = _seg_sum(torch.where(contrib, w * dev * dev, 0.0), gid, cap,
                  segments)
    if merge:
        sq = _seg_sum(torch.where(contrib, x, 0.0), gid, cap, segments) + sq
    return sq


def _reduce_segment(op: str, vals: torch.Tensor, contrib: torch.Tensor,
                    gid: torch.Tensor, cap: int, out_dt: dt.DataType,
                    counts: Optional[torch.Tensor] = None,
                    segments: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    merge_active: Optional[torch.Tensor] = None,
                    refs: Optional[List[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group reduction -> (values[cap], has[cap]); ``has`` is False for
    a group no row contributed to (its value is then null). ``counts``, the
    per-group count of ``contrib``, is computed when not given: callers
    reducing many columns under one mask compute it once, and likewise
    ``segments`` (``sorted_segments``) for float sums.

    ``refs``: the value planes of the sibling state columns a moment merge
    names.

    Spark rules: NaN is the largest double; sum propagates NaN; masked-off
    rows may hold stale data (even NaN), so they are replaced with the
    identity by ``where`` and never multiplied by the mask. A wide-decimal
    sum is null where it overflows; ``merge_active``, the row mask of a
    final merge, lets it read its inputs' overflow marks."""
    if op in _COLLECT_OPS:
        raise NotImplementedError(
            f"aggregate op {op!r} is not ported yet {not_ported(STEP_BREADTH)}")
    out_dtype = torch_dtype(out_dt)
    if counts is None:
        counts = _seg_sum(contrib.to(torch.int64), gid, cap)
    has = counts > 0
    if op == "count":
        return counts.to(out_dtype), torch.ones(cap, dtype=torch.bool,
                                                device=vals.device)
    if op in ("first", "last"):
        idx = _pick_index(contrib, gid, cap, op == "last")
        return vals[idx], has
    if op.startswith("moment"):
        return _moments(op, vals, contrib, gid, cap, refs or [],
                        segments), has
    if dt.is_d128(out_dt):
        if op != "sum":
            raise TypeError(f"decimal128 aggregate op {op!r} is host-only")
        return _d128_sum(vals, contrib, gid, cap, out_dt, has, merge_active)
    if op == "sum":
        x = torch.where(contrib, vals.to(out_dtype), 0)
        return _seg_sum(x, gid, cap, segments), has
    if op not in ("min", "max"):
        raise NotImplementedError(
            f"aggregate op {op!r} is not ported yet {not_ported(STEP_BREADTH)}")
    for_min = op == "min"
    # bool as uint8: its extremes 0 and 255 cast back to the JAX package's
    # bool identities (False for max, True for min) in empty groups
    x = vals.to(torch.uint8) if vals.dtype == torch.bool else vals
    isfloat = x.dtype.is_floating_point
    if isfloat:
        # Spark total order: NaN is the largest value
        nan = torch.isnan(x)
        x = torch.where(nan, float("inf") if for_min else float("-inf"), x)
    ident = _minmax_identity(x.dtype, for_min)
    x = torch.where(contrib, x, ident)
    if not isfloat:
        return _seg_extreme(x, gid, cap, for_min).to(out_dtype), has
    # -0.0 below 0.0, as the JAX package orders them: the extremes of the
    # floats' order keys (an extreme of floats keeps either zero)
    ident_key = int(_float_order_key(torch.tensor([ident], dtype=x.dtype)))
    out = _float_order_key(_seg_extreme(_float_order_key(x), gid, cap,
                                        for_min, ident_key), inverse=x.dtype)
    if for_min:
        # NaN only when every contributing value is NaN
        nonnan = _seg_sum(torch.logical_and(
            contrib, torch.logical_not(nan)).to(torch.int64), gid, cap)
        out = torch.where(torch.logical_and(has, nonnan == 0),
                          float("nan"), out)
    else:
        nans = _seg_sum(torch.logical_and(contrib, nan).to(torch.int64),
                        gid, cap)
        out = torch.where(nans > 0, float("nan"), out)
    return out.to(out_dtype), has


class TpuHashAggregateExec(TpuExec):
    """Same pre-projected input contract as CpuHashAggregateExec."""

    def __init__(self, child: PhysicalPlan, key_names: List[str],
                 specs: List[AggSpec], mode: str, device: torch.device,
                 min_bucket: Optional[int] = None, strategy: str = "hash"):
        super().__init__()
        check_mode(mode)
        if strategy not in ("hash", "sort"):
            raise ValueError(f"group-by strategy {strategy!r}")
        #: the grouping: "hash" (bucket rounds) or "sort"
        self.strategy = strategy
        self.child = child
        self.children = (child,)
        self.key_names = list(key_names)
        self.specs = specs
        self.mode = mode
        #: where the empty-input state row is built
        self.device = device
        #: the capacity floor of the running state
        self.min_bucket = min_bucket
        self.schema = aggregate_schema(child, key_names, specs)

    @property
    def fusible(self) -> bool:
        # partial mode emits one aggregated batch per input batch (the
        # final pass merges them); final mode must merge across batches
        return self.mode == "partial"

    def batch_fn(self, mode: str = None) -> Callable[[DeviceTable], DeviceTable]:
        """One batch -> its aggregated batch. ``mode`` defaults to this
        node's; the merge of running states uses ``"final"``."""
        cols_ops = aggregate_columns_ops(self.specs, mode or self.mode)
        merging = (mode or self.mode) == "final"
        key_names = self.key_names
        out_names = tuple(self.schema.names)
        float_sums = any(
            op.startswith("moment")
            or (op == "sum" and torch_dtype(out_dt).is_floating_point)
            for _, op, _, out_dt in cols_ops)
        group_ids = _sorted_group_ids if self.strategy == "sort" \
            else _hash_group_ids

        def contributions(table: DeviceTable, gid: torch.Tensor, cap: int):
            """col -> (contributing rows, their per-group count), the count
            computed once per distinct validity plane."""
            seen = {}

            def of(col: DeviceColumn):
                key = None if col.all_valid else id(col.validity)
                if key not in seen:
                    contrib = table.row_mask if col.all_valid \
                        else torch.logical_and(col.validity, table.row_mask)
                    seen[key] = (contrib, _seg_sum(contrib.to(torch.int64),
                                                   gid, cap))
                return seen[key]
            return of

        def ungrouped(table: DeviceTable) -> DeviceTable:
            gid = torch.zeros(table.capacity, dtype=torch.int32,
                              device=table.device)
            contribution = contributions(table, gid, 1)
            out_cols = []
            for in_col, op, _, out_dt in cols_ops:
                col = table.column(in_col)
                contrib, counts = contribution(col)
                val, has = _reduce_segment(
                    op, col.data, contrib, gid, 1, out_dt, counts,
                    merge_active=table.row_mask if merging else None,
                    refs=_refs(table, op))
                # state row 0 of a fixed small capacity, built on the device
                # (no host read of the reduced values)
                vals = val.new_zeros((_STATE_CAPACITY,) + val.shape[1:])
                vals[:1] = val
                validity = torch.zeros(_STATE_CAPACITY, dtype=torch.bool,
                                       device=val.device)
                validity[:1] = has
                out_cols.append(DeviceColumn(vals, validity, out_dt))
            row_mask = torch.arange(_STATE_CAPACITY,
                                    device=table.device) < 1
            return DeviceTable(tuple(out_cols), row_mask,
                               torch.ones((), dtype=torch.int32,
                                          device=table.device), out_names)

        def grouped(table: DeviceTable) -> DeviceTable:
            cap = table.capacity
            gid, _, num_groups = group_ids(table, key_names)
            # each group's key comes from its first row
            pos = torch.arange(cap, dtype=torch.int64, device=table.device)
            rep_src = torch.where(table.row_mask, pos, _BIG)
            rep = _seg_extreme(rep_src, gid, cap, True).clamp(0, cap - 1)
            group_mask = pos < num_groups
            out_cols: List[DeviceColumn] = []
            for k in key_names:
                g = table.column(k).gather(rep)
                out_cols.append(g.with_validity(
                    torch.logical_and(g.validity, group_mask)))
            contribution = contributions(table, gid, cap)
            # one sort of the group ids for every float sum
            segments = sorted_segments(gid, cap) if float_sums else None
            for in_col, op, _, out_dt in cols_ops:
                col = table.column(in_col)
                contrib, counts = contribution(col)
                vals, has = _reduce_segment(
                    op, col.data, contrib, gid, cap, out_dt, counts,
                    segments, table.row_mask if merging else None,
                    _refs(table, op))
                validity = group_mask if op == "count" \
                    else torch.logical_and(has, group_mask)
                out_cols.append(DeviceColumn(vals, validity, out_dt))
            return DeviceTable(tuple(out_cols), group_mask, num_groups,
                               out_names)

        return grouped if key_names else ungrouped

    def _chunks(self, pidx: int) -> Iterator[DeviceTable]:
        """Child batches concatenated up to ~1M rows of capacity, so one
        aggregation covers many small batches."""
        staged: List[DeviceTable] = []
        cap = 0
        for b in self.child_device_batches(pidx):
            staged.append(b)
            cap += b.capacity
            if cap >= _CHUNK_CAPACITY:
                yield concat_device_tables(staged, self.min_bucket)
                staged, cap = [], 0
        if staged:
            yield concat_device_tables(staged, self.min_bucket)

    def host_batch_fn(self):
        """The host engine's aggregate of one batch: only the partial pass
        has one (its per-batch states merge downstream like the device
        partial's); a final pass spans batches."""
        if not self.fusible:
            return None
        key_names, specs, mode = self.key_names, self.specs, self.mode
        child_schema, schema = self.child.schema, self.schema
        return lambda table: host_aggregate(table, key_names, specs, mode,
                                            child_schema, schema)

    def runs_kernel(self) -> bool:
        # a two-limb decimal sum runs on d128_segment_sum (partial, final
        # and the merge of running states)
        return any(op == "sum" and dt.is_d128(out_dt)
                   for mode in (self.mode, "final")
                   for _, op, _, out_dt in aggregate_columns_ops(self.specs,
                                                                 mode))

    def plan_signature(self) -> str:
        return (f"HashAgg|{self.mode}|{self.strategy}|{self.key_names}|"
                f"{aggregate_columns_ops(self.specs, self.mode)!r}|"
                f"{self.children[0].schema!r}")

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from ..memory.retry import (split_device_rows, with_retry,
                                    with_retry_split, wrap_dispatch)
        from .fallback import quarantine_on_failure
        fn = wrap_dispatch(self.batch_fn(), context=self.node_desc())
        merge_fn = wrap_dispatch(self.batch_fn("final"),
                                 context=self.node_desc())
        catalog = get_catalog(None, self.device)
        pending = None  # the spill handle of the running merged state

        def agg_combine(outs):
            """The split rung's combiner: half outputs are partial states
            with overlapping keys, so their concat is merged again."""
            return merge_fn(concat_device_tables(outs, self.min_bucket))

        # only the partial pass splits: its half outputs are mergeable
        # states, where a final pass emits finished values
        splitter = split_device_rows if self.mode == "partial" else None
        try:
            for chunk in self._chunks(pidx):
                # note-only boundary: the state spans batches, so a
                # terminal failure cannot fall back mid-stream, but it
                # feeds the quarantine store
                with quarantine_on_failure(self):
                    # shrink to the group bucket: the running state must
                    # not scale with the input capacity
                    out = shrink_to_fit(with_retry_split(
                        fn, chunk, splitter=splitter, combiner=agg_combine,
                        scope="partial-agg", context=self.node_desc()),
                        self.min_bucket)
                    del chunk
                    if pending is not None:
                        # merge-as-you-go over the concatenated pair: the
                        # string key matrices may differ in width, so the
                        # pair is grouped again as one table; spill-only,
                        # the pair is at the group bucket already
                        with pending as prev:
                            both = concat_device_tables([prev, out],
                                                        self.min_bucket)
                        out = shrink_to_fit(with_retry(
                            merge_fn, both, scope="agg-merge",
                            context=self.node_desc()), self.min_bucket)
                        del both
                        pending.close()
                        pending = None
                    pending = catalog.register(
                        out, SpillPriorities.ACTIVE_ON_DECK)
                    del out
            if pending is None:
                if self.key_names:
                    return  # no input, no groups
                # no input batch at all: the grand aggregate of nothing
                self.account_batch()
                yield fn(_empty_device_table(self.child.schema,
                                             _STATE_CAPACITY, self.device))
                return
            self.account_batch()
            yield pending.get()
        finally:
            if pending is not None:
                pending.close()

    def node_desc(self):
        return (f"mode={self.mode} keys={self.key_names}"
                + (" strategy=sort" if self.strategy == "sort" else ""))


def _empty_device_table(schema: Schema, cap: int,
                        device: torch.device) -> DeviceTable:
    def empty_col(d: dt.DataType) -> DeviceColumn:
        validity = torch.zeros(cap, dtype=torch.bool, device=device)
        if isinstance(d, dt.StringType):
            return DeviceColumn(
                torch.zeros((cap, 8), dtype=torch.uint8, device=device),
                validity, d,
                lengths=torch.zeros(cap, dtype=torch.int32, device=device))
        if dt.is_d128(d):
            return DeviceColumn(torch.zeros((cap, 2), dtype=torch.int64,
                                            device=device), validity, d)
        return DeviceColumn(torch.zeros(cap, dtype=torch_dtype(d),
                                        device=device), validity, d)

    return DeviceTable(tuple(empty_col(f.dtype) for f in schema),
                       torch.zeros(cap, dtype=torch.bool, device=device),
                       torch.zeros((), dtype=torch.int32, device=device),
                       tuple(schema.names))
