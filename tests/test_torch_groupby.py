"""The port's keyed aggregate and sort units against the JAX package's, on
the same numpy batch handed to both engines: the murmur finaliser, the
packed string key words, the hash grouping planes, the grouped reductions
and the sort permutation. Each unit sits on torch's missing unsigned
integer ops or its missing ``lexsort``, so inputs with the top bit set and
heavy ties are part of every case."""
import dataclasses

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import device as jdev
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.host import HostTable as JHostTable
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import sort as jsort
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.shuffle.manager import _fmix_device

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.device import (DeviceColumn,
                                                    DeviceTable,
                                                    pack_string_key_words)
from spark_rapids_tpu_torch.columnar.host import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.interop import device_table_from_numpy
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import sort as tsort
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.plan.host_groupby import (group_codes,
                                                      host_group_reduce,
                                                      unique_rows)
from spark_rapids_tpu_torch.shuffle.manager import fmix_device

from harness import assert_tables_equal

_WORDS = ["", "a", "ab", "ab\x00", "tpu", "Spark", "RAPIDS", "ünïcode",
          "longer string value", "xyzzy-xyzzy", "日本語", "zz"]


def _string_planes(rng, n, cap, width=None):
    """(cap, width) byte matrix + lengths of random words; rows past ``n``
    and a few rows inside hold stale bytes, as masked-off rows do."""
    raw = [_WORDS[i].encode() for i in rng.integers(0, len(_WORDS), n)]
    width = width or jdev.bucket_width(max(len(b) for b in raw))
    mat = rng.integers(0, 256, (cap, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, cap).astype(np.int32)
    for i, b in enumerate(raw):
        mat[i, :] = 0
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return mat, lengths


def _double_plane(rng, n, cap):
    vals = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf,
                                -np.inf, 3.0]), cap)
    vals[n:] = rng.normal(size=cap - n)  # stale slack
    return vals


def _batch(rng, n, cap, spec, null_prob=0.2, width=None):
    """One numpy batch -> (port DeviceTable, JAX DeviceTable), built from
    the same planes. ``spec``: column name -> "string" | "double" |
    "int32" | "int64" | "bool" | "float32"."""
    names, port_cols, jax_cols = [], [], []
    for name, kind in spec.items():
        validity = rng.random(cap) >= null_prob
        lengths = None
        if kind == "string":
            data, lengths = _string_planes(rng, n, cap, width)
        elif kind == "double":
            data = _double_plane(rng, n, cap)
        elif kind == "float32":
            data = _double_plane(rng, n, cap).astype(np.float32)
        elif kind == "int32":
            data = rng.choice(np.array([-2**31, -7, 0, 3, 2**31 - 1],
                                       np.int32), cap)
        elif kind == "int64":
            data = rng.choice(np.array([-2**63, -1, 0, 5, 2**63 - 1]), cap)
        else:
            data = rng.random(cap) < 0.5
        d = {"string": "string", "double": "double", "float32": "float",
             "int32": "int", "int64": "bigint", "bool": "boolean"}[kind]
        names.append(name)
        col = {"data": data, "validity": validity, "dtype": d,
               "all_valid": False}
        if lengths is not None:
            col["lengths"] = lengths
        port_cols.append(col)
        jax_cols.append(jdev.DeviceColumn(
            jnp.asarray(data), jnp.asarray(validity), _jax_dtype(d),
            None if lengths is None else jnp.asarray(lengths)))
    row_mask = np.zeros(cap, dtype=bool)
    row_mask[:n] = rng.random(n) < 0.9
    port = device_table_from_numpy(names, port_cols, row_mask,
                                   row_mask.sum(), "cpu")
    jax_table = jdev.DeviceTable(tuple(jax_cols), jnp.asarray(row_mask),
                                 jnp.asarray(row_mask.sum(), jnp.int32),
                                 tuple(names))
    return port, jax_table


def _jax_dtype(name):
    return {"string": jdt.STRING, "double": jdt.DOUBLE, "float": jdt.FLOAT,
            "int": jdt.INT, "bigint": jdt.LONG, "boolean": jdt.BOOLEAN}[name]


def test_fmix_device_bit_equal_to_jax():
    vals = np.random.default_rng(0).integers(0, 2**32, 100_000,
                                             dtype=np.uint64)
    vals[:4] = [0, 1, 2**31, 2**32 - 1]
    vals = vals.astype(np.uint32)
    assert (vals >= 2**31).sum() > 40_000
    want = np.asarray(_fmix_device(jnp.asarray(vals))).astype(np.int64)
    got = fmix_device(torch.from_numpy(vals.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 planes carry the same bits: top-bit values arrive negative
    got32 = fmix_device(torch.from_numpy(vals.view(np.int32)))
    np.testing.assert_array_equal(got32.numpy(), want)


@pytest.mark.parametrize("width", [8, 13, 16, 40])
def test_pack_string_key_words_equal_to_jax(width):
    rng = np.random.default_rng(width)
    cap = 512
    mat = rng.integers(0, 256, (cap, width)).astype(np.uint8)
    mat[:64, 0] = 0xFF  # top bit of the first word set
    lengths = rng.integers(0, width + 1, cap).astype(np.int32)
    want = jdev.pack_string_key_words(jnp.asarray(mat), jnp.asarray(lengths))
    got = pack_string_key_words(torch.from_numpy(mat),
                                torch.from_numpy(lengths))
    assert len(got) == len(want) == -(-width // 8) + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))


_KEY_SPECS = {
    "string": {"k0": "string"},
    "double": {"k0": "double"},
    "float32": {"k0": "float32"},
    "int_string": {"k0": "int32", "k1": "string"},
    "mixed": {"k0": "string", "k1": "double", "k2": "int64", "k3": "bool"},
}


@pytest.mark.parametrize("spec", sorted(_KEY_SPECS))
@pytest.mark.parametrize("n,cap", [(1, 8), (300, 512), (3000, 4096)])
def test_hash_group_ids_planes_equal_jax(spec, n, cap):
    rng = np.random.default_rng(n)
    keys = _KEY_SPECS[spec]
    port, jax_table = _batch(rng, n, cap, keys)
    gid, is_rep, num_groups = tagg._hash_group_ids(port, list(keys))
    _, _, jgid, jrep, jnum = jagg._hash_group_ids(jax_table, list(keys))
    assert gid.dtype == torch.int32 and num_groups.dtype == torch.int32
    assert int(num_groups) == int(jnum)
    np.testing.assert_array_equal(is_rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    # the ids are the host engine's: groups numbered by first appearance
    host = port.to_host()
    hgid, hn, _ = group_codes(host, list(keys))
    assert hn == int(num_groups)
    np.testing.assert_array_equal(gid.numpy()[port.row_mask.numpy()], hgid)


def test_hash_group_ids_on_many_groups_match_host_engine():
    """3,000 rows, a string key and an int key making 200 groups."""
    rng = np.random.default_rng(11)
    n, cap = 3000, 4096
    strs = np.array([f"key-{i % 20:02d}" for i in range(n)], dtype=object)
    ints = (np.arange(n) // 20 % 10).astype(np.int32)
    perm = rng.permutation(n)
    host = HostTable(["s", "i"], [HostColumn(dt.STRING, strs[perm]),
                                  HostColumn(dt.INT, ints[perm])])
    port = DeviceTable.from_host(host, 1024, "cpu")
    jtable = jdev.DeviceTable.from_host(
        JHostTable.from_arrow(host.to_arrow()), 1024)
    gid, is_rep, num_groups = tagg._hash_group_ids(port, ["s", "i"])
    _, _, jgid, jrep, jnum = jagg._hash_group_ids(jtable, ["s", "i"])
    assert int(num_groups) == int(jnum) == 200
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(is_rep.numpy(), np.asarray(jrep))
    hgid, _, _ = group_codes(host, ["s", "i"])
    np.testing.assert_array_equal(gid.numpy()[:n], hgid)


_OPS_DTYPES = [("sum", "double", "double"), ("sum", "int64", "bigint"),
               ("count", "double", "bigint"), ("count", "string", "bigint"),
               ("min", "double", "double"), ("max", "double", "double"),
               ("min", "float32", "float"), ("max", "float32", "float"),
               ("min", "int32", "int"), ("max", "int64", "bigint"),
               ("min", "bool", "boolean"), ("max", "bool", "boolean")]


@pytest.mark.parametrize("op,kind,out", _OPS_DTYPES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("cap", [1, 256])
def test_grouped_reduce_segment_equal_jax(op, kind, out, cap):
    rng = np.random.default_rng(cap)
    port, jax_table = _batch(rng, cap, cap, {"v": kind}, null_prob=0.3)
    groups = 1 if cap == 1 else 37
    gid = rng.integers(0, groups, cap).astype(np.int32)
    pc, jc = port.column("v"), jax_table.column("v")
    contrib = np.logical_and(pc.validity.numpy(), port.row_mask.numpy())
    if kind == "double" and cap > 1:
        # a group whose only contributions are NaN, one with none at all
        pc.data[gid == 3] = float("nan")
        jc = jc.__class__(jnp.asarray(pc.data.numpy()), jc.validity,
                          jc.dtype, jc.lengths)
        contrib[gid == 5] = False
    got_v, got_has = tagg._reduce_segment(
        op, pc.data, torch.from_numpy(contrib), torch.from_numpy(gid), cap,
        dt.from_simple_name(out))
    want_v, want_has = jagg._reduce_segment(
        op, jc.data, jnp.asarray(contrib), jnp.asarray(gid), cap,
        jnp.arange(cap, dtype=jnp.int64), _jax_dtype(out))
    want_v, want_has = np.asarray(want_v), np.asarray(want_has)
    got_v, got_has = got_v.numpy(), got_has.numpy()
    assert got_v.dtype == want_v.dtype
    np.testing.assert_array_equal(got_has, want_has)
    # a null group's value is not compared: the JAX package leaves the
    # largest finite double in an empty float min, the port leaves inf
    live = want_has if op != "count" else np.ones(cap, dtype=bool)
    if op == "sum" and kind == "double":
        np.testing.assert_allclose(got_v[live], want_v[live], rtol=1e-12)
    else:
        defect = _jax_extreme_defect(op, got_v, want_v)
        np.testing.assert_array_equal(got_v[live & ~defect],
                                      want_v[live & ~defect])
    # and the host engine's reduction over the same rows
    if op in ("sum", "count", "min", "max") and kind != "string":
        valid = contrib[:cap]
        host_v, host_valid = host_group_reduce(
            op, HostColumn(dt.from_simple_name(out), pc.data.numpy(), valid),
            gid.astype(np.int64), groups, dt.from_simple_name(out))
        h = host_valid if host_valid is not None \
            else np.ones(groups, dtype=bool)
        np.testing.assert_array_equal(got_has[:groups] | (op == "count"), h)
        np.testing.assert_allclose(got_v[:groups][h],
                                   host_v[h].astype(got_v.dtype), rtol=1e-12)


def _jax_extreme_defect(op, got, want):
    """Where the JAX package's float min (max) holds the largest (least)
    finite double for a group whose contributions were all +inf (-inf)
    beside a non-contributing row, and the port holds the infinity that
    Spark and both host engines give."""
    if op not in ("min", "max") or got.dtype.kind != "f":
        return np.zeros(got.shape, dtype=bool)
    info = np.finfo(got.dtype)
    edge, inf = (info.max, np.inf) if op == "min" else (info.min, -np.inf)
    return (want == edge) & (got == inf)


def test_min_max_of_infinities_beside_nulls_follow_spark():
    """min over {+inf, null} is +inf and max over {-inf, null} is -inf, as
    in Spark and the host engine; the JAX package's device engine gives
    +-1.8e308 there (its identity for a non-contributing row)."""
    vals = np.array([np.inf, 7.0, -np.inf, 7.0])
    contrib = np.array([True, False, True, False])
    gid = np.array([0, 0, 1, 1], dtype=np.int32)
    for op, group, want in (("min", 0, np.inf), ("max", 1, -np.inf)):
        got, has = tagg._reduce_segment(
            op, torch.from_numpy(vals), torch.from_numpy(contrib),
            torch.from_numpy(gid), 4, dt.DOUBLE)
        assert bool(has[group]) and got[group].item() == want
        host, _ = host_group_reduce(op, HostColumn(dt.DOUBLE, vals, contrib),
                                    gid.astype(np.int64), 2, dt.DOUBLE)
        assert host[group] == want
        jax_v, _ = jagg._reduce_segment(
            op, jnp.asarray(vals), jnp.asarray(contrib), jnp.asarray(gid), 4,
            jnp.arange(4, dtype=jnp.int64), jdt.DOUBLE)
        assert _jax_extreme_defect(op, got.numpy(), np.asarray(jax_v))[group]


def _orders(fns, spec):
    """The sort orders of one case, built from an engine's functions
    module ``fns``."""
    col = fns.col
    return {
        "s_asc": [col("s").asc()],
        "s_desc_nulls_first": [fns.SortOrder(col("s").expr, False, True)],
        "d_asc": [col("d").asc()],
        "d_desc": [col("d").desc()],
        "i_desc_nulls_first_s": [fns.SortOrder(col("i").expr, False, True),
                                 col("s").asc()],
        "b_d_desc_nulls_last": [col("b").asc(),
                                fns.SortOrder(col("d").expr, False, False)],
        "all": [col("b").desc(), col("s").desc(), col("d").asc(),
                fns.SortOrder(col("i").expr, True, False)],
    }[spec]


_JAX_STAND_IN = -2**62   # for -2**63; no batch value lies between them


def _avoid_jax_sort_defects(jax_table):
    """The JAX package's ``_order_keys`` has two order defects (ROADMAP
    Queue 3): an ascending bool key puts true before false (descending:
    false before true), and a descending integer key is negated, so -2**63
    stays least and sorts first. The port follows Spark: false < true, and
    -2**63 is last in a descending order. The JAX side is handed the bool
    column inverted and -2**63 replaced by -2**62, which keep the order
    Spark wants and meet neither defect; ``_undo_jax_sort_workaround``
    restores its sorted output."""
    cols = []
    for name, c in zip(jax_table.names, jax_table.columns):
        if name == "b":
            c = dataclasses.replace(c, data=jnp.logical_not(c.data))
        elif name == "i":
            c = dataclasses.replace(c, data=jnp.where(
                c.data == -2**63, _JAX_STAND_IN, c.data))
        cols.append(c)
    return dataclasses.replace(jax_table, columns=tuple(cols))


def _undo_jax_sort_workaround(t: pa.Table) -> pa.Table:
    b, i = t.column("b"), t.column("i")
    t = t.set_column(t.schema.get_field_index("b"), "b", pc.invert(b))
    return t.set_column(t.schema.get_field_index("i"), "i", pc.if_else(
        pc.equal(i, _JAX_STAND_IN), pa.scalar(-2**63, pa.int64()), i))


@pytest.mark.parametrize("case", ["s_asc", "s_desc_nulls_first", "d_asc",
                                  "d_desc", "i_desc_nulls_first_s",
                                  "b_d_desc_nulls_last", "all"])
@pytest.mark.parametrize("n,cap", [(5, 8), (700, 1024)])
def test_sort_permutation_equal_jax_lexsort(case, n, cap):
    rng = np.random.default_rng(len(case) + n)
    spec = {"s": "string", "d": "double", "i": "int64", "b": "bool"}
    port, jax_table = _batch(rng, n, cap, spec)
    jax_table = _avoid_jax_sort_defects(jax_table)
    keys = tsort._order_keys(port, _orders(F, case))
    got = tsort.lexsort(keys)
    want = np.asarray(jnp.lexsort(tuple(jsort._order_keys(
        jax_table, _orders(JF, case)))))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the sorted batch holds the same rows in that order
    out = tsort.device_sort_table(port, _orders(F, case)).to_host()
    jout = jsort.device_sort_table(jax_table, _orders(JF, case)).to_host()
    assert_tables_equal(out.to_arrow(), _undo_jax_sort_workaround(
        jout.to_arrow()), ignore_order=False)


@pytest.mark.parametrize("kind,data,ascending,want_first", [
    ("bool", [True, False], True, False),
    ("bool", [False, True], False, True),
    ("int64", [-2**63, 5], False, 5)])
def test_port_sort_follows_spark_where_jax_order_keys_does_not(
        kind, data, ascending, want_first):
    """The defects ``_avoid_jax_sort_defects`` works round: on two valid
    rows the port puts Spark's first value first, the JAX package the
    other."""
    d = {"bool": "boolean", "int64": "bigint"}[kind]
    vals = np.array(data, dtype=bool if kind == "bool" else np.int64)
    port = device_table_from_numpy(
        ["x"], [{"data": vals, "validity": np.ones(2, bool), "dtype": d,
                 "all_valid": True}], np.ones(2, bool), 2, "cpu")
    jax_table = jdev.DeviceTable(
        (jdev.DeviceColumn(jnp.asarray(vals), jnp.ones(2, bool),
                           _jax_dtype(d)),), jnp.ones(2, bool),
        jnp.asarray(2, jnp.int32), ("x",))
    got = tsort.lexsort(tsort._order_keys(
        port, [F.SortOrder(F.col("x").expr, ascending, True)]))
    jgot = jnp.lexsort(tuple(jsort._order_keys(
        jax_table, [JF.SortOrder(JF.col("x").expr, ascending, True)])))
    assert vals[int(got[0])] == want_first
    assert vals[int(jgot[0])] != want_first


def test_unique_rows_equals_numpy_unique_rows():
    """The folded one-code ``unique_rows`` of the host engine gives
    np.unique(axis=0)'s rows, first indices and inverse, the int64
    extremes and wide spans included."""
    rng = np.random.default_rng(11)
    for n in (0, 1, 500):
        mat = np.stack([
            rng.integers(0, 2, n),
            rng.choice(np.array([-2**63, -1, 0, 5, 2**63 - 1]), n),
            rng.integers(-2**40, 2**40, n) // 2**10,
            rng.integers(-2**62, 2**62, n) // 2**32], axis=1)
        got = unique_rows(mat)
        want = np.unique(mat, axis=0, return_index=True, return_inverse=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(g.shape))


def test_lexsort_equals_numpy_lexsort_with_top_bit_words():
    """The sign flip makes torch's signed order the words' unsigned one."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**64, (3, 4000), dtype=np.uint64)
    # ties in the two most significant keys, so every key decides somewhere
    words[1] = rng.choice(words[1][:7], 4000)
    words[2] = rng.choice(words[2][:5], 4000)
    got = tsort.lexsort([torch.from_numpy(w.view(np.int64)) ^ tsort._SIGN
                         for w in words])
    np.testing.assert_array_equal(got.numpy(), np.lexsort(tuple(words)))


def test_struct_and_decimal_keys_raise_naming_roadmap():
    """Struct (and binary) keys still raise, naming their ROADMAP step; a
    wide decimal key, which raised until decimals were ported, now groups
    as the JAX package groups it: its key words and the group ids of a
    two-limb key (with a decimal64 key beside it) equal JAX's, and the
    host engine's."""
    class StructType(dt.DataType):
        simple_name = "struct<a:int>"

    for d in (StructType(), dt.BINARY):
        col = DeviceColumn(torch.zeros(8, dtype=torch.uint8),
                           torch.ones(8, dtype=torch.bool), d)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            tagg._key_code_words(col)
    from decimal import Decimal
    rng = np.random.default_rng(8)
    n = 900
    wide = pa.array([None if i % 11 == 0 else Decimal(
        int(rng.integers(-40, 40)) * 10 ** 20 + int(rng.integers(0, 3)))
        .scaleb(-2) for i in range(n)], type=pa.decimal128(25, 2))
    narrow = pa.array([Decimal(int(v)).scaleb(-1)
                       for v in rng.integers(-3, 3, n)],
                      type=pa.decimal128(10, 1))
    table = pa.table({"w": wide, "d": narrow})
    host = HostTable.from_arrow(table)
    port = DeviceTable.from_host(host, 1024, "cpu")
    jtable = jdev.DeviceTable.from_host(JHostTable.from_arrow(table), 1024)
    words, _ = tagg._key_code_words(port.column("w"))
    jwords, _ = jagg._key_code_words(jtable.column("w"))
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jw).view(np.int64))
    for keys in (["w"], ["w", "d"]):
        gid, is_rep, num_groups = tagg._hash_group_ids(port, keys)
        _, _, jgid, jrep, jnum = jagg._hash_group_ids(jtable, keys)
        assert int(num_groups) == int(jnum) > 1
        np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
        np.testing.assert_array_equal(is_rep.numpy(), np.asarray(jrep))
        hgid, hn, _ = group_codes(host, keys)
        assert hn == int(num_groups)
        np.testing.assert_array_equal(gid.numpy()[:n], hgid)


@pytest.mark.parametrize("op", ["collect_list", "collect_set",
                                "merge_lists", "merge_sets"])
def test_collect_ops_raise_naming_roadmap(op):
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tagg._reduce_segment(op, x, torch.ones(8, dtype=torch.bool),
                             torch.zeros(8, dtype=torch.int32), 8, dt.DOUBLE)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        host_group_reduce(op, HostColumn(dt.DOUBLE, np.zeros(8)),
                          np.zeros(8, dtype=np.int64), 1, dt.DOUBLE)


def _partial_aggregate(package, keys, spec):
    """A partial keyed aggregate of ``package`` ("port" or "jax") over the
    columns of ``spec``: sum, count and average of a double, min and max of
    an int64 and of a double."""
    if package == "port":
        from spark_rapids_tpu_torch.expr import aggregates as A
        from spark_rapids_tpu_torch.expr.base import AttributeReference as R
        from spark_rapids_tpu_torch.plan.physical import AggSpec
        from spark_rapids_tpu_torch.plan.schema import Field, Schema
        types = {"string": dt.STRING, "double": dt.DOUBLE, "int64": dt.LONG,
                 "int32": dt.INT, "bool": dt.BOOLEAN}
    else:
        from spark_rapids_tpu.expr import aggregates as A
        from spark_rapids_tpu.expr.base import AttributeReference as R
        from spark_rapids_tpu.plan.physical import AggSpec
        from spark_rapids_tpu.plan.schema import Field, Schema
        types = {"string": jdt.STRING, "double": jdt.DOUBLE,
                 "int64": jdt.LONG, "int32": jdt.INT, "bool": jdt.BOOLEAN}
    fns = [A.Sum(R("v", types["double"])), A.Count(R("v", types["double"])),
           A.Average(R("v", types["double"])), A.Min(R("w", types["int64"])),
           A.Max(R("v", types["double"]))]
    specs = [AggSpec(f"_agg{i}", fn) for i, fn in enumerate(fns)]
    child = type("Child", (), {})()
    child.schema = Schema([Field(name, types[kind])
                           for name, kind in spec.items()])
    if package == "port":
        return tagg.TpuHashAggregateExec(child, keys, specs, "partial",
                                         torch.device("cpu"))
    return jagg.TpuHashAggregateExec(child, keys, specs, "partial")


@pytest.mark.parametrize("keys", [["k0"], ["k0", "k1"], ["k1", "k2"]])
@pytest.mark.parametrize("n,cap", [(1, 8), (700, 1024)])
def test_grouped_partial_aggregate_batch_equals_jax(keys, n, cap):
    """The whole grouped batch function, plane by plane: the group mask,
    each group's key gathered from its first row (the string matrix and its
    lengths too) and every state column."""
    spec = {"k0": "string", "k1": "double", "k2": "int32",
            "_agg0_in0": "double", "_agg1_in0": "double",
            "_agg2_in0": "double", "_agg2_in1": "double",
            "_agg3_in0": "int64", "_agg4_in0": "double"}
    port_t, jax_t = _batch(np.random.default_rng(n + len(keys)), n, cap,
                           spec)
    got = _partial_aggregate("port", keys, spec).batch_fn()(port_t)
    want = _partial_aggregate("jax", keys, spec).batch_fn()(jax_t)
    assert got.names == tuple(want.names)
    assert int(got.num_rows) == int(want.num_rows)
    np.testing.assert_array_equal(got.row_mask.numpy(),
                                  np.asarray(want.row_mask))
    for name, gc, wc in zip(got.names, got.columns, want.columns):
        valid = np.asarray(wc.validity)
        np.testing.assert_array_equal(gc.validity.numpy(), valid, name)
        g, w = gc.data.numpy()[valid], np.asarray(wc.data)[valid]
        if g.dtype.kind == "f" and name.startswith("_agg") \
                and name.endswith("_sum"):
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=name)
        else:
            keep = ~_jax_extreme_defect(name[-3:], g, w)
            np.testing.assert_array_equal(g[keep], w[keep], name)
        if wc.lengths is not None:
            np.testing.assert_array_equal(gc.lengths.numpy()[valid],
                                          np.asarray(wc.lengths)[valid])
