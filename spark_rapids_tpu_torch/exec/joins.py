"""Device equi-joins — the port of ``spark_rapids_tpu/exec/joins.py`` for inner
joins on one fixed-width key (reference: GpuHashJoin.scala:507,
GpuShuffledHashJoinExec / GpuBroadcastHashJoinExec).

The build side is the right child, the probe side the left. Every build key
maps into int64 by ``monotone_i64`` (order and Spark equality kept: NaN ==
NaN, -0.0 == 0.0). Per build table the decision sequence is the JAX
package's:

1. the hash prep (``spark.rapids.tpu.join.strategy`` hash, the default) or
   the sorted prep (``sort``), each of which says whether the build keys
   are unique;
2. a unique build joins each probe batch in one pass, probe capacity in and
   out: an open-addressing slot table walked by double hashing, or a
   ``searchsorted`` into the sorted keys; the output shrinks to its bucket;
3. otherwise the sorted prep, ``searchsorted`` start/count per probe row,
   one host read of the total pairs, and an expand into a bucket of that
   total.

``lax.while_loop`` becomes a Python loop of rounds with one host read each
(at most ``T`` rounds), ``jax.ops.segment_min`` a ``scatter_reduce_``
(``amin``) into a ``cap``-filled plane, ``jnp.lexsort`` the chained stable
argsort of exec/sort.py. The JAX package's uint32 hash arithmetic rides
int64 in ``[0, 2**32)`` (shuffle/manager.py), its uint64 bit tricks int64.

Not ported yet, each raising and naming its ROADMAP Queue 1 step: outer,
semi, anti and cross joins, residual conditions, and multi-key or
string-key joins (step 6); the windowed expand of an output over the batch
budget (step 9); the grace join of a build side over it (steps 8 and 9).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               concat_device_tables, shrink_to_fit)
from ..plan.logical import _join_schema
from ..plan.physical import PhysicalPlan
from ..plan.schema import Schema
from ..shuffle.manager import MASK32, fmix_device
from .aggregate import _empty_device_table
from .base import TpuExec
from .sort import lexsort

__all__ = ["TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec",
           "join_unsupported_reason", "monotone_i64", "build_prep_hash",
           "pk_hash_probe", "build_prep_sorted", "pk_sorted_probe",
           "probe_count", "expand_slots", "gather_columns", "slot_hash"]

_I64_MAX = 2**63 - 1
_GOLDEN = 0x9E3779B9
#: the capacity under which ``T * T`` stays inside int64 (bucket math)
_MAX_BUILD_CAPACITY = 1 << 30


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
        raise NotImplementedError(
            f"a join build of capacity {cap} is over the slot table's "
            f"{_MAX_BUILD_CAPACITY} rows: the grace join is not ported yet "
            "(ROADMAP Queue 1 steps 8 and 9)")
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
    """``probe_count_fn`` without tracking -> (starts, counts): each usable
    probe row's run of equal keys in ``sv``, clamped to the usable prefix
    (so a probe key equal to the int64-max tail counts only usable rows)."""
    pmask = torch.logical_and(key.validity, row_mask)
    pv = monotone_i64(key.data)
    starts = torch.minimum(torch.searchsorted(sv, pv), nvalid)
    ends = torch.minimum(torch.searchsorted(sv, pv, right=True), nvalid)
    counts = torch.where(pmask, ends - starts, 0)
    return starts, counts


def expand_slots(probe_mask: torch.Tensor, build_capacity: int,
                 b_order: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, out_cap: int):
    """``_JoinKernels._slots`` for an inner join -> (probe row, build row,
    valid slot, build matched, total) per output slot: slot ``j`` belongs to
    the probe row whose run of ``counts`` covers it, and takes the ``k``-th
    build row of that row's run in ``b_order``."""
    slot_counts = torch.where(probe_mask, counts, 0)
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
                    matched: torch.Tensor) -> List[DeviceColumn]:
    """Every column gathered at ``idx``, null where not ``matched``. The
    output row mask of an inner join exposes only matched rows, each a
    real source row, so ``all_valid`` carries over."""
    out = []
    for c in table.columns:
        g = c.gather(idx)
        out.append(g.with_validity(torch.logical_and(g.validity, matched),
                                   all_valid=c.all_valid))
    return out


def join_unsupported_reason(how: str, condition, left_keys: Sequence[str],
                            right_keys: Sequence[str], left_schema: Schema,
                            right_schema: Schema) -> Optional[str]:
    """Why the device cannot run this hash join yet (naming the ROADMAP
    step), or None."""
    if how != "inner":
        return (f"{how} joins on the device are not ported yet (ROADMAP "
                "Queue 1 step 6)")
    if condition is not None:
        return ("join conditions beyond the equi-keys are not ported to the "
                "device yet (ROADMAP Queue 1 step 6)")
    if len(left_keys) != 1:
        return (f"joins on {len(left_keys)} keys are not ported to the "
                "device yet (ROADMAP Queue 1 step 6)")
    lt = left_schema.field(left_keys[0]).dtype
    rt = right_schema.field(right_keys[0]).dtype
    if lt != rt or isinstance(lt, (dt.StringType, dt.BinaryType)):
        return (f"a join key of {lt!r} against {rt!r} is not ported to the "
                "device yet (ROADMAP Queue 1 step 6)")
    return None


class TpuShuffledHashJoinExec(TpuExec):
    """Inner equi-join of co-partitioned children: partition p of the left
    (probe) joins partition p of the right (build)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str, condition, merge_keys: bool,
                 device: torch.device, strategy: str = "hash",
                 min_bucket: Optional[int] = None,
                 batch_bytes: int = 512 * 1024 * 1024):
        super().__init__()
        reason = join_unsupported_reason(how, condition, left_keys,
                                         right_keys, left.schema,
                                         right.schema)
        if reason is not None:
            raise NotImplementedError(reason)
        self.left, self.right = left, right
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.merge_keys = merge_keys
        self.device = device
        self.strategy = "hash" if strategy == "auto" else strategy
        self.min_bucket = min_bucket
        self.batch_bytes = batch_bytes
        on = self.left_keys if merge_keys else None
        self.schema = _join_schema(left.schema, right.schema, on, how)
        #: strategy -> (the build table's row mask, its prep)
        self._preps = {}

    @property
    def num_partitions(self) -> int:
        return self.left.num_partitions

    def node_desc(self):
        return f"{self.how} lkeys={self.left_keys} rkeys={self.right_keys}"

    def assemble(self, pcols: List[DeviceColumn], bcols: List[DeviceColumn]
                 ) -> Tuple[List[DeviceColumn], List[str]]:
        """Output columns in schema order: ``on`` keys once (from the probe
        side), then the probe columns, then the build columns."""
        lnames = list(self.left.schema.names)
        rnames = list(self.right.schema.names)
        names: List[str] = []
        cols: List[DeviceColumn] = []
        skip_l, skip_r = set(), set()
        if self.merge_keys:
            for lk in self.left_keys:
                cols.append(pcols[lnames.index(lk)])
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

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        build = self._build_table(pidx)
        if build.nbytes() > self.batch_bytes:
            raise NotImplementedError(
                f"a join build side of {build.nbytes()} bytes is over "
                f"spark.rapids.sql.batchSizeBytes={self.batch_bytes}: the "
                "grace join is not ported yet (ROADMAP Queue 1 steps 8 and "
                "9)")
        for probe in self.child_device_batches(pidx):
            out = self._pk_join(build, probe)
            if out is None:
                out = self._expand_join(build, probe)
            else:
                # an inner join keeps the probe capacity under a mask: shrink
                # (one host read) so later operators skip the dead rows
                out = shrink_to_fit(out, self.min_bucket)
            self.account_batch()
            yield out

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
        """One pass for a unique build (FK->PK: at most one match a probe
        row, so the output fits the probe capacity); None when the build
        keys repeat."""
        key = probe.column(self.left_keys[0])
        if self.strategy == "hash":
            slot_row, bv, unique = self._prep(build, "hash")
            if not unique:
                return None
            found, bi = pk_hash_probe(key, probe.row_mask, slot_row, bv)
        else:
            b_order, sv, nvalid, unique = self._prep(build, "sort")
            if not unique:
                return None
            found, bi = pk_sorted_probe(key, probe.row_mask, b_order, sv,
                                        nvalid)
        pcols = [c.with_validity(torch.logical_and(c.validity, found),
                                 all_valid=c.all_valid)
                 for c in probe.columns]
        cols, names = self.assemble(pcols, gather_columns(build, bi, found))
        mask = torch.logical_and(found, probe.row_mask)
        return DeviceTable(tuple(cols), mask, mask.sum(dtype=torch.int32),
                           tuple(names))

    def _max_out_rows(self) -> int:
        """Gather-output row budget derived from the byte budget."""
        row_bytes = 0
        for f in self.schema:
            row_bytes += 32 if isinstance(f.dtype, dt.StringType) \
                else f.dtype.np_dtype().itemsize
            row_bytes += 1  # validity
        return max(self.min_bucket or 1,
                   self.batch_bytes // max(row_bytes, 1))

    def _expand_join(self, build: DeviceTable, probe: DeviceTable
                     ) -> DeviceTable:
        """Repeated build keys: starts/counts by ``searchsorted`` into the
        sorted prep, one host read of the pair total, then the expand into a
        bucket of that total."""
        b_order, sv, nvalid, _ = self._prep(build, "sort")
        starts, counts = probe_count(probe.column(self.left_keys[0]),
                                     probe.row_mask, sv, nvalid)
        total = int(torch.where(probe.row_mask, counts, 0).sum())
        if total > self._max_out_rows():
            raise NotImplementedError(
                f"a join output of {total} rows is over the batch budget: "
                "the windowed expand is not ported yet (ROADMAP Queue 1 "
                "step 9)")
        out_cap = bucket_rows(max(total, 1), self.min_bucket)
        pi, bi, valid_slot, build_matched, total_t = expand_slots(
            probe.row_mask, build.capacity, b_order, starts, counts, out_cap)
        cols, names = self.assemble(
            gather_columns(probe, pi, valid_slot),
            gather_columns(build, bi, build_matched))
        return DeviceTable(tuple(cols), valid_slot, total_t.to(torch.int32),
                           tuple(names))


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """The build side read whole, once, and joined to every probe partition
    (reference: GpuBroadcastHashJoinExec). The build table stays on the node
    for the plan's life (the spill catalog is ROADMAP Queue 1 step 9)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._broadcast: Optional[DeviceTable] = None

    def _build_table(self, pidx: int) -> DeviceTable:
        if self._broadcast is None:
            self._broadcast = self._concat_build(
                [b for p in range(self.right.num_partitions)
                 for b in self.right.execute_columnar(p)])
        return self._broadcast
