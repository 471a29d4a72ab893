"""Host-side (host engine) group-by with Spark semantics — the port's copy
of ``spark_rapids_tpu/plan/host_groupby.py`` for sum, count, min, max,
first, last and the moments of the variance family.

numpy and Arrow rather than pandas: pandas nullable floats conflate NaN
with NA, but Spark distinguishes them (NaN is a *value*, the largest double;
null is absence). Semantics implemented here and mirrored by the device
path (exec/aggregate.py):

- null keys form their own group; NaN keys group together; -0.0 == 0.0
- sum propagates NaN; all-null group -> null sum, 0 count
- a wide decimal sums exactly on Python ints and is null past its
  precision, also when a partial state it merges overflowed
- min ignores NaN unless all values are NaN; max returns NaN if any NaN
  (total order: -inf < ... < inf < NaN)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable
from ..conf import STEP_BREADTH, not_ported

__all__ = ["group_codes", "host_group_reduce", "object_codes"]

_COLLECT_OPS = frozenset(
    {"collect_list", "collect_set", "merge_lists", "merge_sets"})


def _dense(v: np.ndarray) -> Tuple[np.ndarray, int]:
    """-> (codes 0..k-1 in the order of ``v``'s values, k)."""
    _, inv = np.unique(v, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return inv, int(inv.max(initial=-1)) + 1


def unique_rows(mat: np.ndarray):
    """np.unique(axis=0) of an int64 matrix -> (unique rows, index of each
    one's first row, flat inverse), the rows in lexicographic order.

    The columns are folded into one int64 code, most significant first, so
    one 1-D sort finds the rows: a column spans ``max - min + 1`` values, and
    a column (or the code so far) is made dense first where the product of
    the spans would not fit in 62 bits. The fold keeps the order of rows."""
    n = mat.shape[0]
    code = np.zeros(n, dtype=np.int64)
    radix = 1
    for j in range(mat.shape[1]):
        plane = mat[:, j]
        lo = int(plane.min(initial=0))
        span = int(plane.max(initial=0)) - lo + 1
        if span > 2**31:
            plane, span = _dense(plane)
            lo = 0
        if radix * span >= 2**62:
            code, radix = _dense(code)
        code = code * span + (plane - lo)
        radix *= span
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    return mat[first], first, inv.reshape(-1)


def object_codes(vals: np.ndarray) -> np.ndarray:
    """Codes for an object array of str (or bytes), or of Python ints (a
    wide decimal): equal values share a code, strings in first-seen order,
    ints in value order. Arrow's hash table compares lengths as well as
    bytes, so values that differ only by an embedded NUL byte ("ab" vs
    "ab\\x00") stay apart."""
    if len(vals) == 0:
        return np.zeros(0, dtype=np.int64)
    if isinstance(vals[0], (int, np.integer)):
        from ..expr.decimal128 import limbs_from_py_ints
        return unique_rows(limbs_from_py_ints(vals, len(vals)))[2] \
            .astype(np.int64)
    arr = pa.array(vals, type=pa.binary() if isinstance(vals[0], bytes)
                   else pa.string())
    return arr.dictionary_encode().indices.to_numpy().astype(np.int64)


def _float_codes(v: np.ndarray) -> np.ndarray:
    """Codes for floats: equal values share a code, NaNs share one."""
    nan = np.isnan(v)
    _, inv = np.unique(np.where(nan, np.inf, v), return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return np.where(nan, inv.max(initial=0) + 1, inv)


def _key_codes(col: HostColumn) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column (null flag, int64 code) planes: equal values (Spark
    grouping semantics) get equal codes; nulls get flag 1 and code 0. The
    flag is a plane of its own, so no code value can collide with null
    (the int64 extremes included)."""
    vals = col.values
    if vals.dtype.kind == "f":
        v = vals.copy()
        v[v == 0] = 0.0  # -0.0 == 0.0
        codes = _float_codes(v)
    elif vals.dtype == object:
        codes = object_codes(vals)
    else:
        codes = vals.astype(np.int64)
    valid = col.valid_mask()
    return (~valid).astype(np.int64), np.where(valid, codes, 0)


def group_codes(table: HostTable, key_names: Sequence[str]
                ) -> Tuple[np.ndarray, int, np.ndarray]:
    """-> (group_id per row, num_groups, representative row index per
    group). Groups are numbered by first appearance."""
    n = table.num_rows
    if not key_names:
        return np.zeros(n, dtype=np.int64), 1, np.zeros(1, dtype=np.int64)
    mats = np.stack([plane for k in key_names
                     for plane in _key_codes(table.column(k))], axis=1)
    _, first_idx, gid = unique_rows(mats)
    # renumber groups by first appearance for deterministic output order
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    gid = remap[gid]
    rep = first_idx[order]
    return gid, len(rep), rep


def _d128_sum(vals: np.ndarray, valid: np.ndarray, gid: np.ndarray,
              ngroups: int, out_dtype: "dt.DecimalType", has: np.ndarray,
              merging: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Python-int sums; a group past the precision is null and holds
    ``SUM_OVERFLOW_MARK``, and a final merge (``merging``) makes a group null
    whose marked null state row it holds (the JAX package's host engine
    skips that row as empty)."""
    bound = 10 ** out_dtype.precision
    accs = [0] * ngroups
    for i in np.nonzero(valid)[0]:
        accs[gid[i]] += int(vals[i])
    over = np.array([abs(a) >= bound for a in accs], dtype=bool)
    if merging:
        for i in np.nonzero(~valid)[0]:
            if abs(int(vals[i])) >= bound:
                over[gid[i]] = True
    out = np.empty(ngroups, dtype=object)
    from ..expr.decimal128 import SUM_OVERFLOW_MARK
    out[:] = [SUM_OVERFLOW_MARK if o else a for a, o in zip(accs, over)]
    return out, np.logical_and(has, np.logical_not(over))


def _pick_index(valid: np.ndarray, gid: np.ndarray, ngroups: int,
                last: bool) -> np.ndarray:
    """Each group's first (or last) valid row; 0 for an empty group."""
    n = len(valid)
    pos = np.arange(n, dtype=np.int64)
    if last:
        acc = np.full(ngroups, -1, dtype=np.int64)
        np.maximum.at(acc, gid[valid], pos[valid])
    else:
        acc = np.full(ngroups, n, dtype=np.int64)
        np.minimum.at(acc, gid[valid], pos[valid])
    return np.clip(acc, 0, max(n - 1, 0))


def _group_sum(x: np.ndarray, valid: np.ndarray, gid: np.ndarray,
               ngroups: int) -> np.ndarray:
    acc = np.zeros(ngroups, dtype=np.float64)
    np.add.at(acc, gid[valid], x[valid])
    return acc


def _moment_mean(x, w, valid, gid, ngroups):
    """The w-weighted group mean about each group's first valid x."""
    pivot = x[_pick_index(valid, gid, ngroups, False)] if len(x) \
        else np.zeros(ngroups)
    with np.errstate(invalid="ignore", divide="ignore"):
        return pivot + _group_sum(w * (x - pivot[gid]), valid, gid,
                                  ngroups) / _group_sum(w, valid, gid,
                                                        ngroups)


def _moments(op: str, x: np.ndarray, valid: np.ndarray, gid: np.ndarray,
             ngroups: int, refs: Sequence[np.ndarray]) -> np.ndarray:
    """The device's ``_moments`` (exec/aggregate.py) on numpy."""
    name = op.split(":")[0]
    x = x.astype(np.float64)
    merge = name.endswith("_merge")
    w = refs[0].astype(np.float64) if merge else np.ones_like(x)
    if name.startswith("moment_mean"):
        return _moment_mean(x, w, valid, gid, ngroups)
    means = refs[1].astype(np.float64) if merge else x
    mean = _moment_mean(means, w, valid, gid, ngroups)
    with np.errstate(invalid="ignore"):
        dev = means - mean[gid]
        sq = _group_sum(w * dev * dev, valid, gid, ngroups)
    if merge:
        sq = _group_sum(x, valid, gid, ngroups) + sq
    return sq


def _tdigest(op: str, col: HostColumn, valid: np.ndarray, gid: np.ndarray,
             ngroups: int) -> np.ndarray:
    """approx_percentile's sketch ops: ``tdigest:<accuracy>`` sketches each
    group's values, ``tdigest_merge:<accuracy>`` merges its partial
    sketches (utils/tdigest.py); a group with none gets the empty
    sketch."""
    from ..utils.tdigest import build_digest, merge_digests
    kind, _, acc = op.partition(":")
    delta = int(acc) if acc else 10000
    out = np.empty(ngroups, dtype=object)
    out[:] = [[] for _ in range(ngroups)]
    idx = np.nonzero(valid)[0]
    vals = col.values
    if kind == "tdigest":
        if len(idx):
            order = idx[np.argsort(gid[idx], kind="stable")]
            gs = gid[order]
            bounds = np.nonzero(np.diff(gs))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(order)]])
            for a, b in zip(starts, ends):
                out[gs[a]] = build_digest(
                    np.asarray(vals[order[a:b]], dtype=np.float64), delta)
        return out
    parts: list = [[] for _ in range(ngroups)]
    for i in idx:
        parts[gid[i]].append(vals[i])
    for g in range(ngroups):
        if parts[g]:
            out[g] = merge_digests(parts[g], delta)
    return out


def host_group_reduce(op: str, col: HostColumn, gid: np.ndarray, ngroups: int,
                      out_dtype: dt.DataType, merging: bool = False,
                      refs: Sequence[np.ndarray] = ()
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """-> (values[ngroups], validity[ngroups] or None). ``merging``: the op
    merges partial states (a final aggregate), so a wide-decimal sum reads
    its inputs' overflow marks. ``refs``: the values of the sibling state
    columns a moment merge names."""
    if op in _COLLECT_OPS:
        raise NotImplementedError(
            f"aggregate op {op!r} is not ported yet {not_ported(STEP_BREADTH)}")
    valid = col.valid_mask()
    vals = col.values
    if op.startswith("tdigest"):
        return _tdigest(op, col, col.valid_mask(), gid, ngroups), None
    np_out = object if isinstance(out_dtype, (dt.StringType, dt.BinaryType)) \
        else out_dtype.np_dtype()
    vcount = np.zeros(ngroups, dtype=np.int64)
    np.add.at(vcount, gid[valid], 1)
    has = vcount > 0

    if op == "count":
        return vcount.astype(np.int64), None
    if op == "sum" and dt.is_d128(out_dtype):
        return _d128_sum(vals, valid, gid, ngroups, out_dtype, has, merging)
    if op == "sum":
        acc = np.zeros(ngroups, dtype=np_out)
        with np.errstate(over="ignore", invalid="ignore"):
            np.add.at(acc, gid[valid], vals[valid].astype(np_out))
        return acc, has.copy()
    if op in ("min", "max"):
        return _host_minmax(op, vals, valid, gid, ngroups, has)
    if op in ("first", "last"):
        if not len(vals):
            return np.zeros(ngroups, dtype=vals.dtype), has.copy()
        return vals[_pick_index(valid, gid, ngroups, op == "last")], \
            has.copy()
    if op.startswith("moment"):
        return _moments(op, vals, valid, gid, ngroups, refs), has.copy()
    raise ValueError(op)


def _float_order_key(x: np.ndarray) -> np.ndarray:
    """Floats -> signed integers of the same width whose order is the
    floats' with -0.0 below 0.0 (a negative's magnitude bits flipped);
    applied to the integers (viewed back as floats by the caller), the
    inverse."""
    if x.dtype.kind == "f":
        x = x.view(np.int64 if x.itemsize == 8 else np.int32)
    return x ^ ((x >> (8 * x.itemsize - 1)) & np.iinfo(x.dtype).max)


def _host_minmax(op: str, vals: np.ndarray, valid: np.ndarray,
                 gid: np.ndarray, ngroups: int, has: np.ndarray):
    if vals.dtype == object:  # strings: order via sorted codes
        uniques, codes = np.unique(vals, return_inverse=True)
        red, rhas = _host_minmax(op, codes.reshape(-1).astype(np.int64),
                                 valid, gid, ngroups, has)
        idx = np.clip(red, 0, max(len(uniques) - 1, 0)).astype(np.int64)
        out = uniques.astype(object)[idx] if len(uniques) \
            else np.full(ngroups, "", dtype=object)
        return out, rhas
    isfloat = vals.dtype.kind == "f"
    work = vals.copy()
    nan_mask = np.zeros(len(vals), dtype=bool)
    if isfloat:
        nan_mask = np.isnan(vals)
        # NaN is the largest value in Spark's total order
        work = np.where(nan_mask, np.inf if op == "min" else -np.inf, vals)
        # -0.0 below 0.0, as the JAX package orders them: reduce the
        # floats' order keys (np.minimum keeps either zero)
        work = _float_order_key(work)
    if op == "min":
        ident = np.inf if isfloat else np.iinfo(vals.dtype).max \
            if vals.dtype != np.bool_ else True
        if isfloat:
            ident = _float_order_key(np.array([ident], vals.dtype))[0]
        acc = np.full(ngroups, ident, dtype=work.dtype)
        np.minimum.at(acc, gid[valid], work[valid])
        if isfloat:
            acc = _float_order_key(acc).view(vals.dtype)
            nonnan = np.zeros(ngroups, dtype=np.int64)
            np.add.at(nonnan, gid[valid], (~nan_mask[valid]).astype(np.int64))
            acc = np.where(has & (nonnan == 0), np.nan, acc)
    else:
        ident = -np.inf if isfloat else np.iinfo(vals.dtype).min \
            if vals.dtype != np.bool_ else False
        if isfloat:
            ident = _float_order_key(np.array([ident], vals.dtype))[0]
        acc = np.full(ngroups, ident, dtype=work.dtype)
        np.maximum.at(acc, gid[valid], work[valid])
        if isfloat:
            acc = _float_order_key(acc).view(vals.dtype)
            anynan = np.zeros(ngroups, dtype=np.int64)
            np.add.at(anynan, gid[valid], nan_mask[valid].astype(np.int64))
            acc = np.where(anynan > 0, np.nan, acc)
    return acc, has.copy()
