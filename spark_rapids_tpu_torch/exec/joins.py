"""Device equi-joins — the port of ``spark_rapids_tpu/exec/joins.py``
(reference: GpuHashJoin.scala:507, GpuShuffledHashJoinExec /
GpuBroadcastHashJoinExec).

Join types ``inner``, ``left``, ``right``, ``full``, ``left_semi`` and
``left_anti``, on any number of equi-keys of fixed-width, float or string
type, with an optional residual condition. The build side is the right
child, the probe side the left. Per build table the decision sequence is
the JAX package's:

1. a single fixed-width key of one type on both sides, no condition, and
   an inner, left, semi or anti join: the hash prep
   (``spark.rapids.tpu.join.strategy`` hash, the default: an
   open-addressing slot table walked by double hashing over
   ``monotone_i64`` keys) or the sorted prep (``sort``), each of which says
   whether the build keys are unique. A unique build joins each probe
   batch in one pass, probe capacity in and out; so do semi and anti joins
   under the hash prep whatever the build holds (they ask existence only);
2. otherwise starts and counts per probe row: ``searchsorted`` into the
   sorted prep for that single key, or, for any other keys, dense join
   codes over both sides at once (``join_codes``: one lexsort of the
   concatenated key planes, nulls and inactive rows as unique negative
   sentinels) and a stable argsort of the build codes. Right and full
   joins carry a per-build-row ``seen`` mask across the probe batches and
   emit the build rows no probe row matched at the end, null-padded;
3. semi and anti joins without a condition keep the probe rows whose count
   is (not) zero; every other join reads the pair total on the host once
   per probe batch (a left or full join counts an unmatched row as one
   slot) and expands into a bucket of that total, or, over the batch
   budget, in windows of probe rows;
4. a residual condition filters the inner pairs; for outer, semi and anti
   joins the pairs are expanded as inner pairs (semi and anti gather only
   the columns the condition reads), and a probe row whose every pair
   failed is padded, kept or dropped by the outer/semi/anti rule, while
   passing pairs mark their build rows seen.

``lax.while_loop`` becomes a Python loop of rounds with one host read each
(at most ``T`` rounds), ``jax.ops.segment_min`` a ``scatter_reduce_``
(``amin``) into a ``cap``-filled plane, ``.at[i].max`` on bools a
``scatter_reduce_`` (``amax``) into int32, ``jnp.lexsort`` the chained
stable argsort of exec/sort.py. The JAX package's uint32 hash arithmetic
rides int64 in ``[0, 2**32)`` (shuffle/manager.py), its uint64 key words
int64 with the sign bit flipped before sorting.

The build table is held through a spill-catalog handle and pinned while
each probe batch joins it. A build side over
``spark.rapids.sql.batchSizeBytes`` takes the grace join (reference:
AbstractGpuJoinIterator's sub-partitioning): both sides are bucketed into
``n_sub = min(64, max(2, ceil(build bytes / budget)))`` parts by the
partition id of their keys (seed 9001), every part registered with the
catalog at ``INPUT`` priority so parts spill while others join, and bucket
``s`` of the probe joins bucket ``s`` of the build; right and full joins
emit each bucket's unmatched build rows after it, a bucket no probe row
reached included. Unlike the JAX package, float keys are hashed with -0.0
as 0.0 and every NaN as one NaN (and an integer key joined to a float key
as a float), so equal keys always share a bucket. A broadcast build is
registered once at ``BROADCAST`` priority and split once for every probe
partition; the plan closes its handles when its query ends.

Not ported yet: joins without equi-keys (the broadcast nested-loop join,
ROADMAP Queue 1: nested-loop and cross joins), whose planning raises; and
key types the device batch does not hold (binary, and decimal and nested
types, which the port has not yet), which are tagged and run on the host
engine (ROADMAP Queue 1: breadth, and decimal128).
"""
from __future__ import annotations

import math
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               bucket_width, concat_device_tables,
                               pack_string_key_words, shrink_to_fit,
                               slice_rows, torch_dtype)
from ..conf import STEP_BREADTH, STEP_NESTED_LOOP, RapidsConf, not_ported
from ..expr.base import EvalContext, Expression
from ..memory.catalog import SpillableDeviceTable, SpillPriorities, get_catalog
from ..plan.logical import _join_schema
from ..plan.physical import PhysicalPlan
from ..plan.schema import Schema
from ..shuffle.manager import MASK32, device_partition_ids, fmix_device
from .aggregate import _empty_device_table
from .base import TpuExec
from .sort import lexsort

__all__ = ["TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec",
           "join_unsupported_reason", "monotone_i64", "build_prep_hash",
           "pk_hash_probe", "build_prep_sorted", "pk_sorted_probe",
           "probe_count", "probe_matched", "join_codes", "count_matches",
           "build_matched", "expand_slots", "gather_columns",
           "null_device_column", "slot_hash", "SUPPORTED"]

#: the join types of the device hash join (the JAX package's ``SUPPORTED``)
SUPPORTED = ("inner", "left", "right", "full", "left_semi", "left_anti")

_I64_MAX = 2**63 - 1
_I64_MIN = -2**63
_GOLDEN = 0x9E3779B9
#: the capacity under which ``T * T`` stays inside int64 (bucket math)
_MAX_BUILD_CAPACITY = 1 << 30
#: the grace join's partition-id seed (the JAX package's ``_GRACE_SEED``)
GRACE_SEED = 9001
#: the most buckets a grace join splits into
_MAX_GRACE_PARTS = 64

def monotone_i64(v: torch.Tensor) -> torch.Tensor:
    """Order- and equality-preserving map of a key plane into int64 (Spark
    key semantics: NaN == NaN, -0.0 == 0.0). Integers, bools and dates
    widen; a float widens to float64, -0.0 becomes 0.0 and every NaN the one
    canonical NaN, and its bit pattern ``s`` maps to ``s ^ (2**63 - 1)``
    where negative: the JAX package's ``~u`` / ``u | top`` on uint64, minus
    the top bit."""
    if not v.dtype.is_floating_point:
        return v.to(torch.int64)
    v = v.to(torch.float64)
    v = torch.where(v == 0, torch.zeros_like(v), v)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    s = v.view(torch.int64)
    return torch.where(s < 0, s ^ _I64_MAX, s)


def slot_hash(keys: torch.Tensor, T: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (first slot hash h1, odd step mod T): the JAX package's
    ``_fmix_device(lo ^ _fmix_device(hi))`` double hashing on the key's
    32-bit halves. The odd step cycles through every slot of the pow2
    table; reduced mod T, ``h1 + r * step`` stays inside int64."""
    lo = keys & MASK32
    hi = (keys >> 32) & MASK32
    h1 = fmix_device(lo ^ fmix_device(hi))
    step = fmix_device(h1 ^ _GOLDEN) | 1
    return h1, step & (T - 1)


def _chain_walk(h1: torch.Tensor, step: torch.Tensor, keys: torch.Tensor,
                pending: torch.Tensor, slot_row: torch.Tensor,
                bv: torch.Tensor, miss: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk each pending row's probe chain through the slot table until an
    empty slot (absent) or a slot whose build key equals the row's key ->
    (found bool, the found build row int64, ``miss`` where none). One round
    per chain step, one host read each, at most ``T`` rounds."""
    T = slot_row.shape[0]
    cap_b = bv.shape[0]
    n = keys.shape[0]
    resolved = torch.logical_not(pending)
    found = torch.zeros(n, dtype=torch.bool, device=keys.device)
    found_row = torch.full((n,), miss, dtype=torch.int64, device=keys.device)
    r = 0
    while r < T and not bool(resolved.all()):
        bucket = (h1 + r * step) & (T - 1)
        row = slot_row[bucket]
        empty = row < 0
        row_safe = row.clamp(0, cap_b - 1)
        eq = torch.logical_and(torch.logical_not(empty), bv[row_safe] == keys)
        hit = torch.logical_and(torch.logical_not(resolved), eq)
        found = torch.logical_or(found, hit)
        found_row = torch.where(hit, row_safe, found_row)
        resolved = torch.logical_or(resolved, torch.logical_or(empty, eq))
        r += 1
    return found, found_row


def build_prep_hash(key: DeviceColumn, row_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free build prep (``_JoinKernels.build_prep_hash_fn``) ->
    (slot_row, bv, unique): a slot table of ``T`` slots (-1 = empty)
    holding build row indices, the build keys, and whether the usable build
    keys are unique (0-d bool). ``T`` is the power of two at or above
    ``2 * capacity``: ``2 * capacity`` itself for the power-of-two
    capacities of batches, as in the JAX package; the odd step reaches
    every slot only in a power-of-two table.

    Insertion rounds: every unplaced usable row looks at its chain's r-th
    slot; the rows that find it empty claim it, the minimum row index
    winning (``scatter_reduce_`` amin). Uniqueness by self-probe: a
    duplicate's chain reaches the earlier equal key first, so its walk ends
    on another row (equal keys placed in one round never see each other at
    insertion, so the insertion pass cannot tell)."""
    bmask = torch.logical_and(key.validity, row_mask)
    bv = monotone_i64(key.data)
    cap = bv.shape[0]
    if cap > _MAX_BUILD_CAPACITY:
        raise ValueError(
            f"a join build of capacity {cap} is over the slot table's "
            f"{_MAX_BUILD_CAPACITY} rows, past which the table's int64 "
            "chain-step arithmetic can overflow")
    T = 1 << (2 * cap - 1).bit_length()
    device = bv.device
    h1, step = slot_hash(bv, T)
    iota = torch.arange(cap, dtype=torch.int64, device=device)
    slot_row = torch.full((T,), -1, dtype=torch.int64, device=device)
    placed = torch.logical_not(bmask)
    r = 0
    while r < T and not bool(placed.all()):
        bucket = (h1 + r * step) & (T - 1)
        want = torch.logical_and(torch.logical_not(placed),
                                 slot_row[bucket] < 0)
        cand = torch.where(want, iota, cap)
        claim = torch.full((T,), cap, dtype=torch.int64, device=device) \
            .scatter_reduce_(0, bucket, cand, "amin", include_self=True)
        won = torch.logical_and(want, claim[bucket] == iota)
        slot_row = torch.where(
            torch.logical_and(slot_row < 0, claim < cap), claim, slot_row)
        placed = torch.logical_or(placed, won)
        r += 1
    _, found_row = _chain_walk(h1, step, bv, bmask, slot_row, bv, -1)
    unique = torch.logical_or(torch.logical_not(bmask),
                              found_row == iota).all()
    return slot_row, bv, unique


def pk_hash_probe(key: DeviceColumn, row_mask: torch.Tensor,
                  slot_row: torch.Tensor, bv: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe half of ``pk_hash_join_fn``: each usable probe row walks
    its chain -> (found, build row)."""
    pmask = torch.logical_and(key.validity, row_mask)
    pv = monotone_i64(key.data)
    h1, step = slot_hash(pv, slot_row.shape[0])
    return _chain_walk(h1, step, pv, pmask, slot_row, bv, 0)


def build_prep_sorted(key: DeviceColumn, row_mask: torch.Tensor):
    """``build_prep_fn`` -> (b_order, sv, nvalid, unique): the build keys
    sorted once (``lexsort`` with usable rows first), unusable rows as an
    int64-max tail of ``sv``, the usable count (0-d), and whether no two
    adjacent usable keys are equal (0-d bool)."""
    bmask = torch.logical_and(key.validity, row_mask)
    bv = monotone_i64(key.data)
    inv_b = torch.logical_not(bmask)
    b_order = lexsort([bv, inv_b.to(torch.uint8)])
    sv = torch.where(inv_b[b_order], _I64_MAX, bv[b_order])
    nvalid = bmask.sum(dtype=torch.int64)
    iota = torch.arange(sv.shape[0], dtype=torch.int64, device=sv.device)
    dup = torch.logical_and(sv[1:] == sv[:-1], iota[1:] < nvalid)
    return b_order, sv, nvalid, torch.logical_not(dup.any())


def pk_sorted_probe(key: DeviceColumn, row_mask: torch.Tensor,
                    b_order: torch.Tensor, sv: torch.Tensor,
                    nvalid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe half of ``pk_join_fn`` (``join.strategy=sort``): one
    ``searchsorted`` into the unique sorted build keys -> (found, build
    row)."""
    pmask = torch.logical_and(key.validity, row_mask)
    pv = monotone_i64(key.data)
    pos = torch.searchsorted(sv, pv)
    safe = pos.clamp(0, sv.shape[0] - 1)
    found = torch.logical_and(
        torch.logical_and(pos < nvalid, sv[safe] == pv), pmask)
    return found, b_order[safe]


def probe_count(key: DeviceColumn, row_mask: torch.Tensor,
                sv: torch.Tensor, nvalid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counts of ``probe_count_fn`` -> (starts, counts): each usable
    probe row's run of equal keys in ``sv``, clamped to the usable prefix
    (so a probe key equal to the int64-max tail counts only usable rows)."""
    pmask = torch.logical_and(key.validity, row_mask)
    pv = monotone_i64(key.data)
    starts = torch.minimum(torch.searchsorted(sv, pv), nvalid)
    ends = torch.minimum(torch.searchsorted(sv, pv, right=True), nvalid)
    counts = torch.where(pmask, ends - starts, 0)
    return starts, counts


def probe_matched(key: DeviceColumn, row_mask: torch.Tensor,
                  sv: torch.Tensor, nvalid: torch.Tensor,
                  b_order: torch.Tensor) -> torch.Tensor:
    """The tracking half of ``probe_count_fn(track=True)``: per build row,
    whether any usable probe row of this batch holds its key (right and
    full joins), from one sort of the probe keys."""
    pmask = torch.logical_and(key.validity, row_mask)
    pv = monotone_i64(key.data)
    ps = torch.sort(torch.where(pmask, pv, _I64_MAX)).values
    pn = pmask.sum(dtype=torch.int64)
    lo = torch.minimum(torch.searchsorted(ps, sv), pn)
    hi = torch.minimum(torch.searchsorted(ps, sv, right=True), pn)
    iota = torch.arange(sv.shape[0], dtype=torch.int64, device=sv.device)
    matched_s = torch.logical_and(hi > lo, iota < nvalid)
    return torch.zeros_like(matched_s).scatter_(0, b_order, matched_s)


# ---------------------------------------------------------------------------
# General join codes: any tuple of keys
# ---------------------------------------------------------------------------
def _concat_key_col(bc: DeviceColumn, pc: DeviceColumn) -> DeviceColumn:
    """A build/probe key column pair as one column (byte matrices padded to
    a common width so they stack)."""
    bdat, pdat = bc.data, pc.data
    lengths = None
    if bc.lengths is not None:
        w = max(bdat.shape[1], pdat.shape[1])
        bdat = torch.nn.functional.pad(bdat, (0, w - bdat.shape[1]))
        pdat = torch.nn.functional.pad(pdat, (0, w - pdat.shape[1]))
        lengths = torch.cat([bc.lengths, pc.lengths])
    elif bdat.dtype != pdat.dtype:
        common = torch.promote_types(bdat.dtype, pdat.dtype)
        bdat, pdat = bdat.to(common), pdat.to(common)
    return DeviceColumn(torch.cat([bdat, pdat]),
                        torch.cat([bc.validity, pc.validity]), bc.dtype,
                        False, lengths)


def _column_code_arrays(col: DeviceColumn) -> List[torch.Tensor]:
    """1-D planes whose tuple equality is Spark key equality for this
    column (NaN == NaN, -0.0 == 0.0, strings by bytes and length), in an
    order that sorting by them (least significant last) groups equal keys:
    a string's int64 words with the sign bit flipped (the JAX package's
    uint64 order), a float as ``[v with -0 -> 0 and NaN -> +inf, nan
    flag]``."""
    v = col.data
    if col.lengths is not None:
        return [w ^ _I64_MIN for w in pack_string_key_words(v, col.lengths)]
    if not _key_type_ok(col.dtype):
        raise NotImplementedError(
            f"a join key of {col.dtype!r} is not ported to the device yet "
            + not_ported(STEP_BREADTH))
    if v.dtype.is_floating_point:
        nan = torch.isnan(v)
        v = torch.where(v == 0, torch.zeros_like(v), v)
        # NaN -> +inf for a total order; the nan flag keeps real +inf apart
        v = torch.where(nan, torch.full_like(v, float("inf")), v)
        return [v, nan.to(torch.uint8)]
    if v.dtype == torch.bool:
        return [v.to(torch.uint8)]
    return [v]


def join_codes(bcols: Sequence[DeviceColumn], bactive: torch.Tensor,
               pcols: Sequence[DeviceColumn], pactive: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_join_codes`` -> (build codes, probe codes): dense int64 codes,
    equal exactly where the key tuples are equal across both sides; a row
    that is inactive or has a null key gets the unique sentinel
    ``-(row + 2)``, so it never matches."""
    nb = bactive.shape[0]
    n = nb + pactive.shape[0]
    device = bactive.device
    code_arrays: List[torch.Tensor] = []     # major..minor
    anynull = torch.zeros(n, dtype=torch.bool, device=device)
    for bc, pc in zip(bcols, pcols):
        cat = _concat_key_col(bc, pc)
        code_arrays.extend(_column_code_arrays(cat))
        anynull = torch.logical_or(anynull, torch.logical_not(cat.validity))
    usable = torch.logical_and(torch.cat([bactive, pactive]),
                               torch.logical_not(anynull))
    # lexsort takes minor..major: the codes reversed, usable rows first
    order = lexsort(list(reversed(code_arrays))
                    + [torch.logical_not(usable).to(torch.uint8)])
    usable_s = usable[order]
    # a boundary among the sorted usable rows starts a new code
    same = torch.ones(n, dtype=torch.bool, device=device)
    for arr in code_arrays:
        s = arr[order]
        eq = s == torch.roll(s, 1)
        eq[0] = False
        same = torch.logical_and(same, eq)
    boundary = torch.logical_and(torch.logical_not(same), usable_s)
    boundary[0] = usable_s[0]
    gid_sorted = torch.cumsum(boundary.to(torch.int64), 0) - 1
    gid = torch.empty(n, dtype=torch.int64, device=device) \
        .scatter_(0, order, gid_sorted)
    iota = torch.arange(n, dtype=torch.int64, device=device)
    gid = torch.where(usable, gid, -(iota + 2))
    return gid[:nb], gid[nb:]


def count_matches(bgid: torch.Tensor, pgid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_count_matches`` -> (b_order, starts, counts): the build codes in
    a stable order (ties keep row order, so each probe row's matches come
    in build-row order), and each probe row's run of equal codes."""
    b_order = torch.argsort(bgid, stable=True)
    b_sorted = bgid[b_order]
    # a probe sentinel looks for -1, which no build code holds
    p = torch.where(pgid < 0, -1, pgid)
    starts = torch.searchsorted(b_sorted, p)
    ends = torch.searchsorted(b_sorted, p, right=True)
    counts = torch.where(pgid < 0, 0, ends - starts)
    return b_order, starts, counts


def build_matched(bgid: torch.Tensor, pgid: torch.Tensor) -> torch.Tensor:
    """``_build_matched``: per build row, whether a probe row of this batch
    shares its code (right and full joins)."""
    p_sorted = torch.sort(torch.where(pgid < 0, -1, pgid)).values
    b = torch.where(bgid < 0, -2, bgid)
    lo = torch.searchsorted(p_sorted, b)
    hi = torch.searchsorted(p_sorted, b, right=True)
    return torch.logical_and(hi > lo, bgid >= 0)


# ---------------------------------------------------------------------------
# Slots, gathers and padding
# ---------------------------------------------------------------------------
def expand_slots(probe_mask: torch.Tensor, build_capacity: int,
                 b_order: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, out_cap: int, outer: bool = False):
    """``_JoinKernels._slots`` -> (probe row, build row, valid slot, build
    matched, total) per output slot: slot ``j`` belongs to the probe row
    whose run of slots covers it, and takes the ``k``-th build row of that
    row's run in ``b_order``. ``outer`` gives an unmatched probe row one
    slot (``max(counts, 1)``), whose build side is not matched."""
    slot_counts = torch.maximum(counts, torch.ones_like(counts)) if outer \
        else counts
    slot_counts = torch.where(probe_mask, slot_counts, 0)
    cum = torch.cumsum(slot_counts, 0)
    total = cum[-1]
    offsets = cum - slot_counts
    j = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
    pi = torch.searchsorted(cum, j, right=True) \
        .clamp(0, probe_mask.shape[0] - 1)
    k = j - offsets[pi]
    has_match = counts[pi] > 0
    b_sorted_pos = (starts[pi] + k).clamp(0, build_capacity - 1)
    bi = b_order[b_sorted_pos]
    valid_slot = j < total
    return pi, bi, valid_slot, torch.logical_and(valid_slot, has_match), \
        total


def gather_columns(table: DeviceTable, idx: torch.Tensor,
                   matched: torch.Tensor, keep_all_valid: bool = True
                   ) -> List[DeviceColumn]:
    """Every column gathered at ``idx``, null where not ``matched``.
    ``keep_all_valid`` carries each column's null-freedom promise over,
    which holds where the output exposes only ``matched`` rows (each a real
    source row); an outer side exposes rows it pads, and passes False."""
    out = []
    for c in table.columns:
        g = c.gather(idx)
        out.append(g.with_validity(torch.logical_and(g.validity, matched),
                                   all_valid=keep_all_valid and c.all_valid))
    return out


def null_device_column(dtype: dt.DataType, capacity: int,
                       device: torch.device) -> DeviceColumn:
    """``_null_device_column``: an all-null column of ``dtype`` (the padded
    side of an outer join's unmatched rows)."""
    validity = torch.zeros(capacity, dtype=torch.bool, device=device)
    if isinstance(dtype, dt.StringType):
        return DeviceColumn(
            torch.zeros((capacity, bucket_width(1)), dtype=torch.uint8,
                        device=device), validity, dtype, False,
            torch.zeros(capacity, dtype=torch.int32, device=device))
    return DeviceColumn(torch.zeros(capacity, dtype=torch_dtype(dtype),
                                    device=device), validity, dtype, False)


def _scatter_any(keep: torch.Tensor, idx: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """``zeros(size, bool).at[idx].max(keep)``: whether any slot at each
    index keeps (``idx`` is clamped in range; slots past the total keep
    nothing)."""
    return torch.zeros(size, dtype=torch.int32, device=keep.device) \
        .scatter_reduce_(0, idx, keep.to(torch.int32), "amax",
                         include_self=True) > 0


def condition_mask(condition: Expression, table: DeviceTable
                   ) -> torch.Tensor:
    """``_condition_mask``: the rows of ``table`` whose residual condition
    is true (null counts as false)."""
    c = condition.eval(EvalContext.for_device(table))
    keep = c.values
    if c.validity is not None:
        keep = torch.logical_and(keep, c.validity)
    return torch.logical_and(keep, table.row_mask)


def _key_type_ok(d: dt.DataType) -> bool:
    """A key type whose device plane the join codes read: every type of the
    port but binary (fixed-width planes, and the string byte matrix)."""
    return not isinstance(d, dt.BinaryType)


def join_unsupported_reason(how: str, left_keys: Sequence[str],
                            right_keys: Sequence[str], left_schema: Schema,
                            right_schema: Schema) -> Optional[str]:
    """Why the device cannot run this hash join yet (naming the ROADMAP
    step), or None."""
    if how not in SUPPORTED:
        return (f"{how} joins (the broadcast nested-loop join) are not "
                f"ported to the device yet {not_ported(STEP_NESTED_LOOP)}")
    if not left_keys:
        return ("joins without equi-keys (the broadcast nested-loop join) "
                "are not ported to the device yet "
                + not_ported(STEP_NESTED_LOOP))
    for lk, rk in zip(left_keys, right_keys):
        lt = left_schema.field(lk).dtype
        rt = right_schema.field(rk).dtype
        for t in (lt, rt):
            if not _key_type_ok(t):
                return (f"a join key of {t!r} is not ported to the device "
                        f"yet {not_ported(STEP_BREADTH)}")
        if isinstance(lt, dt.StringType) != isinstance(rt, dt.StringType):
            return f"a join key of {lt!r} against {rt!r} is not comparable"
    return None


class TpuShuffledHashJoinExec(TpuExec):
    """Equi-join of co-partitioned children: partition p of the left
    (probe) joins partition p of the right (build). Right and full joins
    track a per-build-row ``seen`` mask across probe batches and emit the
    never-matched build rows null-padded at the end, sound per partition
    because the hash exchange gives each partition disjoint keys
    (reference: GpuHashJoin.scala:507 buildSideTrackerOpt)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str, condition: Optional[Expression],
                 merge_keys: bool, device: torch.device,
                 strategy: str = "hash", min_bucket: Optional[int] = None,
                 batch_bytes: int = 512 * 1024 * 1024,
                 conf: Optional[RapidsConf] = None):
        super().__init__()
        reason = join_unsupported_reason(how, left_keys, right_keys,
                                         left.schema, right.schema)
        if reason is not None:
            raise NotImplementedError(reason)
        self.left, self.right = left, right
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.condition = condition
        self.merge_keys = merge_keys
        self.device = device
        self.strategy = "hash" if strategy == "auto" else strategy
        self.min_bucket = min_bucket
        self.batch_bytes = batch_bytes
        self.conf = conf
        on = self.left_keys if merge_keys else None
        self.schema = _join_schema(left.schema, right.schema, on, how)
        #: strategy -> (the build table's row mask, its prep)
        self._preps = {}

    @property
    def num_partitions(self) -> int:
        return self.left.num_partitions

    def node_desc(self):
        return f"{self.how} lkeys={self.left_keys} rkeys={self.right_keys}"

    def assemble(self, pcols: List[DeviceColumn], bcols: List[DeviceColumn],
                 key_from_build: bool = False
                 ) -> Tuple[List[DeviceColumn], List[str]]:
        """Output columns in schema order: ``on`` keys once, then the probe
        columns, then the build columns. The keys come from the probe side,
        or with ``key_from_build`` from the build side (right and full
        leftover rows, whose probe side is null)."""
        lnames = list(self.left.schema.names)
        rnames = list(self.right.schema.names)
        names: List[str] = []
        cols: List[DeviceColumn] = []
        skip_l, skip_r = set(), set()
        if self.merge_keys:
            for lk, rk in zip(self.left_keys, self.right_keys):
                cols.append(bcols[rnames.index(rk)] if key_from_build
                            else pcols[lnames.index(lk)])
                names.append(lk)
            skip_l, skip_r = set(self.left_keys), set(self.right_keys)
        for n, c in zip(lnames, pcols):
            if n not in skip_l:
                names.append(n)
                cols.append(c)
        for n, c in zip(rnames, bcols):
            if n not in skip_r:
                names.append(n)
                cols.append(c)
        return cols, names

    def _table(self, cols, names, mask: torch.Tensor) -> DeviceTable:
        return DeviceTable(tuple(cols), mask, mask.sum(dtype=torch.int32),
                           tuple(names))

    def pad_probe(self, probe: DeviceTable, emit: torch.Tensor
                  ) -> DeviceTable:
        """Probe rows with an all-null build side (left/full unmatched)."""
        bcols = [null_device_column(f.dtype, probe.capacity, probe.device)
                 for f in self.right.schema]
        pcols = [c.with_validity(torch.logical_and(c.validity, emit),
                                 all_valid=c.all_valid)
                 for c in probe.columns]
        return self._table(*self.assemble(pcols, bcols), emit)

    def pad_build(self, build: DeviceTable, emit: torch.Tensor
                  ) -> DeviceTable:
        """Build rows with an all-null probe side (right/full leftover)."""
        pcols = [null_device_column(f.dtype, build.capacity, build.device)
                 for f in self.left.schema]
        bcols = [c.with_validity(torch.logical_and(c.validity, emit),
                                 all_valid=c.all_valid)
                 for c in build.columns]
        return self._table(*self.assemble(pcols, bcols, key_from_build=True),
                           emit)

    # -- execution ------------------------------------------------------------
    def _concat_build(self, batches: List[DeviceTable]) -> DeviceTable:
        if not batches:
            return _empty_device_table(self.right.schema,
                                       bucket_rows(1, self.min_bucket),
                                       self.device)
        if len(batches) == 1:
            return batches[0]
        return concat_device_tables(batches)

    def _build_table(self, pidx: int) -> DeviceTable:
        return self._concat_build(
            list(self.right.execute_columnar(pidx)))

    def _catalog(self):
        return get_catalog(self.conf, self.device)

    def _register_build(self, build: DeviceTable
                        ) -> Tuple[SpillableDeviceTable, bool]:
        """-> (the build's spill handle, whether to close it after this
        partition)."""
        return self._catalog().register(build,
                                        SpillPriorities.ACTIVE_ON_DECK), True

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        build = self._build_table(pidx)
        if build.nbytes() > self.batch_bytes:
            for out in self._grace_join(build, pidx):
                self.account_batch()
                yield out
            return
        handle, own = self._register_build(build)
        del build  # the catalog handle owns it from here on
        try:
            for out in self._join_parts(handle,
                                        self.child_device_batches(pidx)):
                self.account_batch()
                yield out
        finally:
            if own:
                handle.close()

    def _join_parts(self, handle: SpillableDeviceTable, probes
                    ) -> Iterator[DeviceTable]:
        """Join the probe batches against one build handle; a right or full
        join then emits the build rows no probe row matched (a build no
        probe batch reached emits all of them)."""
        track = self.how in ("right", "full")
        seen_box = None
        if track:
            with handle as build:
                seen_box = [torch.zeros(build.capacity, dtype=torch.bool,
                                        device=build.device)]
        yield from self._probe_pinned(handle, probes, seen_box)
        if track:
            with handle as build:
                yield self.pad_build(build, torch.logical_and(
                    build.row_mask, torch.logical_not(seen_box[0])))

    # -- the grace join (a build side over the batch budget) -----------------
    def _float_key_pairs(self) -> List[bool]:
        """Per key pair, whether either side is a float (the pair is then
        hashed as float64 on both sides)."""
        return [any(isinstance(s.field(k).dtype, dt.FractionalType)
                    for s, k in ((self.left.schema, lk),
                                 (self.right.schema, rk)))
                for lk, rk in zip(self.left_keys, self.right_keys)]

    def _grace_keys(self, table: DeviceTable, keys: Sequence[str]
                    ) -> DeviceTable:
        """The key columns as they are hashed into buckets: a pair with a
        float side as float64, -0.0 made 0.0 and every NaN the one
        canonical NaN, so that keys the join holds equal share a bucket."""
        cols = []
        for k, as_float in zip(keys, self._float_key_pairs()):
            c = table.column(k)
            if as_float:
                v = c.data.to(torch.float64)
                v = torch.where(v == 0, torch.zeros_like(v), v)
                v = torch.where(torch.isnan(v), torch.full_like(v, math.nan),
                                v)
                c = DeviceColumn(v, c.validity, dt.DOUBLE, c.all_valid)
            cols.append(c)
        return DeviceTable(tuple(cols), table.row_mask, table.num_rows,
                           tuple(keys))

    def _grace_split(self, table: DeviceTable, keys: Sequence[str],
                     n_sub: int) -> Tuple[List[DeviceTable], List[int]]:
        """-> (bucket ``s`` of ``table`` for each ``s < n_sub``, each
        bucket's row count). A bucket holds the active rows whose partition
        id is ``s``, in their order in ``table``, compacted into the bucket
        of its row count (the JAX package's ``shrink_to_fit(filter_mask(pid
        == s))``, capacities included): one stable sort by id, then one
        gather a bucket; the counts cross to the host in one copy."""
        pid = device_partition_ids(self._grace_keys(table, keys), keys,
                                   n_sub, seed=GRACE_SEED)
        pid = torch.where(table.row_mask, pid, n_sub)  # inactive rows last
        order = torch.argsort(pid, stable=True)
        counts = torch.bincount(pid, minlength=n_sub + 1)[:n_sub].tolist()
        floor = self.min_bucket if self.min_bucket is not None \
            else bucket_rows(1)
        parts = []
        start = 0
        for n in counts:
            cap = table.capacity if table.capacity <= floor \
                else min(bucket_rows(max(n, 1), self.min_bucket),
                         table.capacity)
            idx = torch.zeros(cap, dtype=torch.int64, device=table.device)
            idx[:n] = order[start:start + n]
            start += n
            mask = torch.arange(cap, device=table.device) < n
            cols = tuple(g.with_validity(torch.logical_and(g.validity, mask),
                                         all_valid=g.all_valid)
                         for g in (c.gather(idx) for c in table.columns))
            parts.append(DeviceTable(cols, mask, torch.tensor(
                n, dtype=torch.int32, device=table.device), table.names))
        return parts, counts

    def _grace_build_parts(self, build: DeviceTable, n_sub: int
                           ) -> Tuple[List[SpillableDeviceTable], bool]:
        """-> (the build buckets' spill handles, whether to close them after
        this partition)."""
        catalog = self._catalog()
        parts, _ = self._grace_split(build, self.right_keys, n_sub)
        return [catalog.register(t, SpillPriorities.INPUT)
                for t in parts], True

    def _grace_join(self, build: DeviceTable, pidx: int
                    ) -> Iterator[DeviceTable]:
        """``_grace_join``: bucket both sides by key, then join bucket by
        bucket (every part held by the spill catalog)."""
        catalog = self._catalog()
        n_sub = min(_MAX_GRACE_PARTS,
                    max(2, math.ceil(build.nbytes() / self.batch_bytes)))
        build_parts, own_build = self._grace_build_parts(build, n_sub)
        del build
        track = self.how in ("right", "full")
        probe_parts: List[List[SpillableDeviceTable]] = \
            [[] for _ in range(n_sub)]
        try:
            for probe in self.child_device_batches(pidx):
                parts, counts = self._grace_split(probe, self.left_keys,
                                                  n_sub)
                for s, (t, n) in enumerate(zip(parts, counts)):
                    if n:
                        probe_parts[s].append(
                            catalog.register(t, SpillPriorities.INPUT))
            for s in range(n_sub):
                if probe_parts[s] or track:
                    yield from self._join_parts(
                        build_parts[s], _pinned(probe_parts[s]))
        finally:
            if own_build:
                for h in build_parts:
                    h.close()
            for hs in probe_parts:
                for h in hs:
                    h.close()

    def _direct_key_ok(self) -> bool:
        """One key of one fixed-width type on both sides: the
        ``monotone_i64`` preps (hash slot table, sorted keys) serve it."""
        if len(self.left_keys) != 1:
            return False
        lt = self.left.schema.field(self.left_keys[0]).dtype
        rt = self.right.schema.field(self.right_keys[0]).dtype
        return lt == rt and not isinstance(lt, dt.StringType)

    def _prep(self, build: DeviceTable, strategy: str):
        """The build table's prep, computed once per build table (a
        broadcast build serves every probe partition); ``unique`` is read
        on the host here, once."""
        hit = self._preps.get(strategy)
        if hit is None or hit[0] is not build.row_mask:
            key = build.column(self.right_keys[0])
            if strategy == "hash":
                slot_row, bv, unique = build_prep_hash(key, build.row_mask)
                prep = (slot_row, bv, bool(unique))
            else:
                b_order, sv, nvalid, unique = build_prep_sorted(
                    key, build.row_mask)
                prep = (b_order, sv, nvalid, bool(unique))
            hit = (build.row_mask, prep)
            self._preps[strategy] = hit
        return hit[1]

    def _pk_join(self, build: DeviceTable, probe: DeviceTable
                 ) -> Optional[DeviceTable]:
        """One pass, probe capacity in and out, for a unique build (FK->PK:
        at most one match a probe row) or, under the hash prep, a semi or
        anti join whatever the build holds (the chain walk finds any equal
        key); None otherwise."""
        key = probe.column(self.left_keys[0])
        how = self.how
        if self.strategy == "hash":
            slot_row, bv, unique = self._prep(build, "hash")
            if not (unique or how in ("left_semi", "left_anti")):
                return None
            found, bi = pk_hash_probe(key, probe.row_mask, slot_row, bv)
        else:
            b_order, sv, nvalid, unique = self._prep(build, "sort")
            if not unique:
                return None
            found, bi = pk_sorted_probe(key, probe.row_mask, b_order, sv,
                                        nvalid)
        if how == "left_semi":
            return probe.filter_mask(found)
        if how == "left_anti":
            return probe.filter_mask(torch.logical_not(found))
        keep = found if how == "inner" else probe.row_mask
        pcols = [c.with_validity(torch.logical_and(c.validity, keep),
                                 all_valid=c.all_valid)
                 for c in probe.columns]
        bcols = gather_columns(build, bi, found,
                               keep_all_valid=how == "inner")
        return self._table(*self.assemble(pcols, bcols),
                           torch.logical_and(keep, probe.row_mask))

    def _counts(self, build: DeviceTable, probe: DeviceTable, track: bool):
        """-> (b_order, starts, counts, this batch's build-row matches or
        None): ``searchsorted`` into the sorted prep for a direct key, else
        the join codes of both sides."""
        if self._direct_key_ok():
            b_order, sv, nvalid, _ = self._prep(build, "sort")
            key = probe.column(self.left_keys[0])
            starts, counts = probe_count(key, probe.row_mask, sv, nvalid)
            matched = probe_matched(key, probe.row_mask, sv, nvalid,
                                    b_order) if track else None
            return b_order, starts, counts, matched
        bgid, pgid = join_codes(
            [build.column(k) for k in self.right_keys], build.row_mask,
            [probe.column(k) for k in self.left_keys], probe.row_mask)
        b_order, starts, counts = count_matches(bgid, pgid)
        return b_order, starts, counts, \
            build_matched(bgid, pgid) if track else None

    def _slot_total(self, probe: DeviceTable, counts: torch.Tensor) -> int:
        """The output slots of a probe batch, read on the host (the one
        device wait of the count path): a left or full join without a
        condition gives an unmatched row one slot."""
        if self.how in ("left", "full") and self.condition is None:
            counts = torch.maximum(counts, torch.ones_like(counts))
        return int(torch.where(probe.row_mask, counts, 0).sum())

    def _max_out_rows(self) -> int:
        """Gather-output row budget derived from the byte budget."""
        row_bytes = 0
        for f in self.schema:
            row_bytes += 32 if isinstance(f.dtype, dt.StringType) \
                else f.dtype.np_dtype().itemsize
            row_bytes += 1  # validity
        return max(self.min_bucket or 1,
                   self.batch_bytes // max(row_bytes, 1))

    def _probe_pinned(self, build_handle: SpillableDeviceTable, probes,
                      seen_box=None) -> Iterator[DeviceTable]:
        """``_probe_join`` over a build held by the spill catalog: the
        build is pinned while each probe batch joins it."""
        for probe in probes:
            with build_handle as build:
                yield from self._probe_join(build, [probe], seen_box)

    def _probe_join(self, build: DeviceTable, probes, seen_box=None
                    ) -> Iterator[DeviceTable]:
        """``_probe_join``: join each probe batch against one build table.
        ``seen_box`` (right/full) holds the running per-build-row matched
        mask, updated in place across batches."""
        has_cond = self.condition is not None
        track = seen_box is not None and not has_cond
        pk_eligible = (not has_cond and self._direct_key_ok()
                       and self.how in ("inner", "left", "left_semi",
                                        "left_anti"))
        for probe in probes:
            if pk_eligible:
                out = self._pk_join(build, probe)
                if out is not None:
                    if self.how != "left":
                        # a selective join keeps the probe capacity under
                        # a mask: shrink (one host read) so later
                        # operators skip the dead rows
                        out = shrink_to_fit(out, self.min_bucket)
                    yield out
                    continue
            b_order, starts, counts, matched = self._counts(build, probe,
                                                            track)
            if matched is not None:
                seen_box[0] = torch.logical_or(seen_box[0], matched)
            if self.how in ("left_semi", "left_anti") and not has_cond:
                yield probe.filter_mask(counts == 0 if self.how == "left_anti"
                                        else counts > 0)
                continue
            total = self._slot_total(probe, counts)
            max_out = self._max_out_rows()
            if total > max_out:
                # an output over the budget comes in windows of probe rows
                # (reference: AbstractGpuJoinIterator's split gather)
                yield from self._windowed_expand(build, probe, total,
                                                 max_out, seen_box)
                continue
            out_cap = bucket_rows(max(total, 1), self.min_bucket)
            yield from self._expand_one(build, probe, b_order, starts,
                                        counts, out_cap, seen_box)

    def _windowed_expand(self, build: DeviceTable, probe: DeviceTable,
                         total: int, max_out: int, seen_box=None
                         ) -> Iterator[DeviceTable]:
        """Expand in windows of probe rows sized by the average matches a
        row, a skewed window over twice the budget split again."""
        floor = self.min_bucket if self.min_bucket is not None \
            else bucket_rows(1)
        probe = probe.compact()
        nrows = max(1, int(probe.num_rows))
        avg_mult = max(1.0, total / nrows)
        wsize = bucket_rows(max(floor, int(max_out / avg_mult)),
                            self.min_bucket)
        skip_empty = self.condition is None and self.how in ("inner",
                                                             "right")
        start = 0
        while start < nrows:
            window = slice_rows(probe, start, wsize)
            start += wsize
            b_order, starts, counts, _ = self._counts(build, window, False)
            wtotal = self._slot_total(window, counts)
            if wtotal == 0 and skip_empty:
                continue
            if wtotal > 2 * max_out and wsize > floor:
                yield from self._windowed_expand(build, window, wtotal,
                                                 max_out, seen_box)
                continue
            out_cap = bucket_rows(max(wtotal, 1), self.min_bucket)
            yield from self._expand_one(build, window, b_order, starts,
                                        counts, out_cap, seen_box)

    def _expand_one(self, build: DeviceTable, probe: DeviceTable,
                    b_order, starts, counts, out_cap: int, seen_box
                    ) -> Iterator[DeviceTable]:
        """One expand of a probe batch or window, after its counts."""
        if self.condition is None:
            # right runs as inner here (its leftover rows come at the end),
            # full as left
            eff = {"right": "inner", "full": "left"}.get(self.how, self.how)
            yield self._expand(build, probe, b_order, starts, counts,
                               out_cap, eff)
            return
        if self.how == "inner":
            out = self._expand(build, probe, b_order, starts, counts,
                               out_cap, "inner")
            yield out.filter_mask(condition_mask(self.condition, out))
            return
        yield from self._expand_cond(build, probe, b_order, starts, counts,
                                     out_cap, seen_box)

    def _expand(self, build: DeviceTable, probe: DeviceTable, b_order,
                starts, counts, out_cap: int, how: str) -> DeviceTable:
        """``expand_fn`` for ``inner`` and ``left`` (a left join keeps an
        unmatched probe row inline, its build side null)."""
        outer = how == "left"
        pi, bi, valid, matched, total = expand_slots(
            probe.row_mask, build.capacity, b_order, starts, counts,
            out_cap, outer)
        cols, names = self.assemble(
            gather_columns(probe, pi, valid),
            gather_columns(build, bi, matched, keep_all_valid=not outer))
        return DeviceTable(tuple(cols), valid, total.to(torch.int32),
                           tuple(names))

    def _expand_cond(self, build: DeviceTable, probe: DeviceTable, b_order,
                     starts, counts, out_cap: int, seen_box
                     ) -> Iterator[DeviceTable]:
        """``expand_cond_fn``: the candidate pairs expanded as inner pairs
        and filtered by the condition; a probe row none of whose pairs
        passed is kept (anti), dropped (semi) or padded with nulls
        (left/full), and passing pairs mark their build rows seen
        (right/full)."""
        how = self.how
        pi, bi, valid, _, total = expand_slots(
            probe.row_mask, build.capacity, b_order, starts, counts,
            out_cap)
        if how in ("left_semi", "left_anti"):
            # the pairs carry only the columns the condition reads
            refs = self.condition.references()
            lnames = [n for n in self.left.schema.names if n in refs]
            rnames = [n for n in self.right.schema.names if n in refs]
            pairs = DeviceTable(
                tuple(gather_columns(_select(probe, lnames), pi, valid)
                      + gather_columns(_select(build, rnames), bi, valid)),
                valid, total.to(torch.int32), tuple(lnames + rnames))
            any_pass = _scatter_any(condition_mask(self.condition, pairs),
                                    pi, probe.capacity)
            yield probe.filter_mask(torch.logical_not(any_pass)
                                    if how == "left_anti" else any_pass)
            return
        cols, names = self.assemble(gather_columns(probe, pi, valid),
                                    gather_columns(build, bi, valid))
        pairs = DeviceTable(tuple(cols), valid, total.to(torch.int32),
                            tuple(names))
        keep = condition_mask(self.condition, pairs)
        yield pairs.filter_mask(keep)
        if how in ("left", "full"):
            any_pass = _scatter_any(keep, pi, probe.capacity)
            yield self.pad_probe(probe, torch.logical_and(
                probe.row_mask, torch.logical_not(any_pass)))
        if how in ("right", "full"):
            seen_box[0] = torch.logical_or(
                seen_box[0], _scatter_any(keep, bi, build.capacity))


def _select(table: DeviceTable, names: Sequence[str]) -> DeviceTable:
    return DeviceTable(tuple(table.column(n) for n in names), table.row_mask,
                       table.num_rows, tuple(names))


def _pinned(handles: Sequence[SpillableDeviceTable]
            ) -> Iterator[DeviceTable]:
    """Each handle's table, pinned while the consumer holds it."""
    for h in handles:
        with h as t:
            yield t


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """The build side read whole, once, and joined to every probe partition
    (reference: GpuBroadcastHashJoinExec). Right and full joins never
    broadcast their build side: its unmatched rows would repeat per probe
    partition. The build table is registered once with the spill catalog
    at ``BROADCAST`` priority, and a build over the batch budget is split
    for the grace join once, for every partition; the plan closes both
    when its query ends (``release_spill_handles``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.how in ("right", "full"):
            raise ValueError(f"a {self.how} join cannot broadcast its right "
                             "side")
        self._bc_handle: Optional[SpillableDeviceTable] = None
        self._bc_grace_parts: Optional[List[SpillableDeviceTable]] = None
        self._bc_lock = threading.Lock()

    def _broadcast_handle(self) -> SpillableDeviceTable:
        """The broadcast build's spill handle, built on first use."""
        with self._bc_lock:
            if self._bc_handle is None:
                table = self._concat_build(
                    [b for p in range(self.right.num_partitions)
                     for b in self.right.execute_columnar(p)])
                self._bc_handle = self._catalog().register(
                    table, SpillPriorities.BROADCAST)
                self._own_spill_handle(self._bc_handle)
            return self._bc_handle

    def _build_table(self, pidx: int) -> DeviceTable:
        return self._broadcast_handle().get()

    def _register_build(self, build: DeviceTable
                        ) -> Tuple[SpillableDeviceTable, bool]:
        return self._broadcast_handle(), False

    def _grace_build_parts(self, build: DeviceTable, n_sub: int
                           ) -> Tuple[List[SpillableDeviceTable], bool]:
        """Split the broadcast once; the parts serve every partition."""
        with self._bc_lock:
            if self._bc_grace_parts is None:
                parts, _ = super()._grace_build_parts(build, n_sub)
                for h in parts:
                    self._own_spill_handle(h)
                self._bc_grace_parts = parts
            return self._bc_grace_parts, False
