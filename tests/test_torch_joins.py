"""The port's join units against the JAX package's, on the same numpy batch
handed to both engines: ``_monotone_i64``, the hash prep's slot table and
uniqueness flag, the sorted prep, the probe counts, and the outputs of the
unique-build (PK) joins and the count/expand join, plane for plane. Then
the port's numpy host join against the JAX package's pandas host join.

Each unit sits on something torch lacks (uint64 bit tricks, uint32 hash
arithmetic, ``segment_min``, ``while_loop``, ``lexsort``), so keys with
the top bit set, NaN, -0.0, nulls, masked-off rows and heavy duplication
are part of every case."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import device as jdev
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.host import HostTable as JHostTable
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.plan import physical_joins as jpj
from spark_rapids_tpu.plan.schema import Field as JField
from spark_rapids_tpu.plan.schema import Schema as JSchema

from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.columnar.interop import device_table_from_numpy
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.plan.physical_joins import join_host_tables
from spark_rapids_tpu_torch.plan.schema import Field, Schema

from harness import assert_tables_equal

_NAMES = {"int64": "bigint", "int32": "int", "double": "double",
          "float32": "float", "bool": "boolean", "date": "date",
          "string": "string"}
_JAX_DT = {"bigint": jdt.LONG, "int": jdt.INT, "double": jdt.DOUBLE,
           "float": jdt.FLOAT, "boolean": jdt.BOOLEAN, "date": jdt.DATE,
           "string": jdt.STRING}
_WORDS = [b"", b"a", b"ab", b"BUILDING", b"longer string value", b"zz"]


def _key_plane(rng, kind: str, cap: int, distinct: int) -> np.ndarray:
    """``cap`` keys drawn from ``distinct`` values of ``kind``, among them
    the type's edges (the top bit set, NaN, -0.0, +-inf). The values come
    from a generator of their own, so two sides share them."""
    pool_rng = np.random.default_rng(distinct)
    if kind in ("int64", "int32", "date"):
        np_t = np.int64 if kind == "int64" else np.int32
        info = np.iinfo(np_t)
        pool = np.concatenate([
            np.array([info.min, info.max, -1, 0, 1], dtype=np_t),
            pool_rng.integers(info.min, info.max, distinct, dtype=np_t)])
    elif kind in ("double", "float32"):
        np_t = np.float64 if kind == "double" else np.float32
        pool = np.concatenate([
            np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.5,
                      2.0**62, -2.0**62], dtype=np_t),
            pool_rng.normal(size=distinct).astype(np_t)])
    else:
        pool = np.array([False, True])
    return rng.choice(pool[:max(distinct, 1)], cap)


def _payload(rng, cap: int):
    """A double, an int32 with nulls and a string column (port dicts)."""
    mat = np.zeros((cap, 32), dtype=np.uint8)
    lengths = np.zeros(cap, dtype=np.int32)
    for i, w in enumerate(rng.integers(0, len(_WORDS), cap)):
        b = _WORDS[w]
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return [
        {"data": rng.normal(size=cap), "validity": np.ones(cap, bool),
         "dtype": "double", "all_valid": True},
        {"data": rng.integers(-9, 9, cap).astype(np.int32),
         "validity": rng.random(cap) > 0.2, "dtype": "int",
         "all_valid": False},
        {"data": mat, "validity": rng.random(cap) > 0.1, "dtype": "string",
         "all_valid": False, "lengths": lengths}]


def _tables(names, cols, row_mask):
    """The same planes as (port DeviceTable, JAX DeviceTable)."""
    port = device_table_from_numpy(names, cols, row_mask, row_mask.sum(),
                                   "cpu")
    jcols = tuple(jdev.DeviceColumn(
        jnp.asarray(c["data"]), jnp.asarray(c["validity"]),
        _JAX_DT[c["dtype"]],
        None if "lengths" not in c else jnp.asarray(c["lengths"]))
        for c in cols)
    return port, jdev.DeviceTable(jcols, jnp.asarray(row_mask),
                                  jnp.asarray(row_mask.sum(), jnp.int32),
                                  tuple(names))


def _side(rng, prefix: str, n: int, cap: int, kind: str, distinct: int,
          null_prob: float = 0.1):
    """A join side: key column ``<prefix>k`` plus the payload columns; rows
    past ``n`` and some inside are masked off."""
    key = {"data": _key_plane(rng, kind, cap, distinct),
           "validity": rng.random(cap) >= null_prob, "dtype": _NAMES[kind],
           "all_valid": False}
    cols = [key] + _payload(rng, cap)
    names = [f"{prefix}k", f"{prefix}d", f"{prefix}i", f"{prefix}s"]
    row_mask = np.zeros(cap, dtype=bool)
    row_mask[:n] = rng.random(n) < 0.9
    return _tables(names, cols, row_mask)


def _unique_build(rng, n: int, cap: int, kind: str = "int64"):
    """A build side whose usable keys are unique."""
    port, jax_table = _side(rng, "b", n, cap, kind, 4 * cap)
    key = port.columns[0].data.numpy().copy()
    if kind == "int64":
        key[:] = rng.permutation(np.arange(-cap, cap) * 7 + 2**62)[:cap]
    elif kind == "int32":
        key[:] = rng.permutation(np.arange(-cap, cap) * 7)[:cap]
    else:
        key[:] = rng.permutation(np.linspace(-1e3, 1e3, 2 * cap))[:cap]
    port.columns[0].data.copy_(torch.from_numpy(key))
    cols = list(jax_table.columns)
    cols[0] = jdev.DeviceColumn(jnp.asarray(key), cols[0].validity,
                                cols[0].dtype, None)
    return port, jdev.DeviceTable(tuple(cols), jax_table.row_mask,
                                  jax_table.num_rows, jax_table.names)


def _key_col(table, name):
    """The JAX package's key view: a table of the key column alone."""
    c = table.column(name)
    return jdev.DeviceTable((c,), table.row_mask, table.num_rows, ("c0",))


def _nodes(port_probe, port_build, jprobe, jbuild, strategy="hash"):
    """A port join node and a JAX one over schema-only children."""
    def schema(t):
        return Schema([Field(n, c.dtype) for n, c in zip(t.names, t.columns)])

    def jschema(t):
        return JSchema([JField(n, c.dtype) for n, c in zip(t.names,
                                                            t.columns)])

    class Side:
        def __init__(self, s):
            self.schema = s

    port = tjoins.TpuShuffledHashJoinExec(
        Side(schema(port_probe)), Side(schema(port_build)), ["pk"], ["bk"],
        "inner", None, False, torch.device("cpu"), strategy, 8)
    jnode = jjoins.TpuShuffledHashJoinExec(
        jjoins._JoinSchemaOnly(jschema(jprobe)),
        jjoins._JoinSchemaOnly(jschema(jbuild)), ["pk"], ["bk"], "inner",
        None, False, min_bucket=8)
    return port, jnode


def _assert_planes_equal(port, jax_table):
    assert port.names == tuple(jax_table.names)
    np.testing.assert_array_equal(port.row_mask.numpy(),
                                  np.asarray(jax_table.row_mask))
    assert int(port.num_rows) == int(jax_table.num_rows)
    for name, c, jc in zip(port.names, port.columns, jax_table.columns):
        np.testing.assert_array_equal(c.validity.numpy(),
                                      np.asarray(jc.validity), err_msg=name)
        got, want = c.data.numpy(), np.asarray(jc.data)
        if got.dtype.kind == "f":
            got, want = got.view(np.int64 if got.itemsize == 8
                                 else np.int32), \
                want.view(np.int64 if want.itemsize == 8 else np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)
        if c.lengths is not None:
            np.testing.assert_array_equal(c.lengths.numpy(),
                                          np.asarray(jc.lengths))


# ---------------------------------------------------------------------------
# _monotone_i64
# ---------------------------------------------------------------------------
_MONO_EDGES = {
    "int32": np.array([-2**31, -7, -1, 0, 1, 2**31 - 1], np.int32),
    "int64": np.array([-2**63, -2**63 + 1, -1, 0, 1, 2**62, 2**63 - 1],
                      np.int64),
    "date": np.array([-719162, -1, 0, 8035, 2932896], np.int32),
    "bool": np.array([False, True]),
    "float32": np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0,
                         -1.0, 2.0**63, -2.0**63, 3.4e38, -3.4e38,
                         1.17549435e-38, -1.17549435e-38], np.float32),
    "double": np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0,
                        -1.0, 2.0**63, -2.0**63, 1.7e308, -1.7e308,
                        2.2250738585072014e-308, -2.2250738585072014e-308],
                       np.float64),
}


@pytest.mark.parametrize("kind", sorted(_MONO_EDGES))
def test_monotone_i64_bit_equal_to_jax(kind):
    rng = np.random.default_rng(len(kind))
    edges = _MONO_EDGES[kind]
    if kind == "bool":
        vals = rng.random(1000) < 0.5
    elif edges.dtype.kind == "f":
        vals = np.concatenate([rng.normal(size=1000) * 1e6,
                               rng.normal(size=1000)]).astype(edges.dtype)
    else:
        info = np.iinfo(edges.dtype)
        vals = rng.integers(info.min, info.max, 2000, dtype=edges.dtype)
    vals = np.concatenate([edges, vals])
    if edges.dtype.kind == "f":
        # NaNs with other payloads fold into the one canonical NaN
        bits = vals.view(np.int64 if vals.itemsize == 8 else np.int32)
        odd = bits[:2].copy() | (0x7FF0000000000001 if vals.itemsize == 8
                                 else 0x7F800001)
        vals = np.concatenate([vals, odd.view(vals.dtype)])
    want = np.asarray(jjoins._monotone_i64(jnp.asarray(vals)))
    got = tjoins.monotone_i64(torch.from_numpy(vals))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # order and Spark equality: sorting by the codes sorts by the values
    uniq = np.unique(got.numpy())
    if edges.dtype.kind != "f":
        assert len(uniq) == len(np.unique(vals))


@pytest.mark.parametrize("np_t", [np.float32, np.float64])
def test_monotone_i64_keeps_subnormals_apart_from_zero(np_t):
    """Subnormal keys are values of their own in Spark: the port maps them
    between -0.0/0.0 and the smallest normals, in order. (The JAX package
    on the CPU maps them to 0.0, as XLA treats denormals as zero, so its
    join matches a subnormal key to a zero key; this is its fault, not the
    port's.)"""
    tiny = np.finfo(np_t).tiny
    sub = np.array([tiny / 2, tiny / 1024, -tiny / 2], np_t)
    assert (np.abs(sub) < tiny).all() and (sub != 0).all()
    vals = np.concatenate([np.array([-tiny, -0.0, 0.0, tiny], np_t), sub])
    got = tjoins.monotone_i64(torch.from_numpy(vals)).numpy()
    order = np.argsort(got, kind="stable")
    assert list(vals[order]) == sorted(vals.tolist())
    assert got[1] == got[2] == 0 and len(np.unique(got)) == 6
    jax_codes = np.asarray(jjoins._monotone_i64(jnp.asarray(sub)))
    assert (jax_codes == 0).all()


# ---------------------------------------------------------------------------
# The hash prep: slot table and uniqueness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["int64", "double", "int32"])
@pytest.mark.parametrize("case", ["unique", "dups", "few_keys", "nulls"])
@pytest.mark.parametrize("n,cap", [(5, 8), (50, 64), (900, 1024),
                                   (3000, 4096)])
def test_build_prep_hash_slot_table_equal_to_jax(kind, case, n, cap):
    rng = np.random.default_rng(n + len(case))
    if case == "unique":
        port, jax_table = _unique_build(rng, n, cap, kind)
    else:
        distinct = {"dups": cap // 2, "few_keys": 3, "nulls": cap}[case]
        port, jax_table = _side(rng, "b", n, cap, kind, distinct,
                                null_prob=0.5 if case == "nulls" else 0.1)
    key = port.column("bk")
    slot_row, bv, unique = tjoins.build_prep_hash(key, port.row_mask)
    jslot, jbv, junique = jjoins._JoinKernels(None).build_prep_hash_fn()(
        _key_col(jax_table, "bk"))
    assert slot_row.shape[0] == 2 * cap
    np.testing.assert_array_equal(slot_row.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jbv))
    assert bool(unique) == bool(junique)
    usable = (port.row_mask & key.validity).numpy()
    keys = bv.numpy()[usable]
    assert bool(unique) == (len(np.unique(keys)) == len(keys))
    if case == "unique":
        assert bool(unique)
    # every usable row holds exactly one slot
    held = slot_row.numpy()[slot_row.numpy() >= 0]
    assert sorted(held) == list(np.nonzero(usable)[0])


def test_build_prep_hash_detects_duplicates_inserted_in_one_round():
    """Equal keys that claim slots in the same round never see each other
    at insertion; the self-probe must still report them. Keys repeated
    densely, with a row mask that drops the earlier copies of some."""
    rng = np.random.default_rng(7)
    cap = 256
    port, jax_table = _side(rng, "b", cap, cap, "int64", cap, null_prob=0.0)
    key = port.column("bk")
    vals = np.repeat(rng.integers(-2**63, 2**63 - 1, cap // 2), 2)
    key.data.copy_(torch.from_numpy(vals))
    cols = list(jax_table.columns)
    cols[0] = jdev.DeviceColumn(jnp.asarray(vals), cols[0].validity,
                                cols[0].dtype, None)
    jax_table = jdev.DeviceTable(tuple(cols), jax_table.row_mask,
                                 jax_table.num_rows, jax_table.names)
    slot_row, _, unique = tjoins.build_prep_hash(key, port.row_mask)
    jslot, _, junique = jjoins._JoinKernels(None).build_prep_hash_fn()(
        _key_col(jax_table, "bk"))
    np.testing.assert_array_equal(slot_row.numpy(), np.asarray(jslot))
    assert not bool(unique) and not bool(junique)


@pytest.mark.parametrize("case", ["unique", "dups"])
@pytest.mark.parametrize("cap", [1000, 1500])
def test_build_prep_hash_on_a_capacity_not_a_power_of_two(case, cap):
    """A capacity that is not a power of two (a ``batchRowsMinBucket`` such
    as 1000) still gets a power-of-two slot table, whose chains reach every
    slot: every usable row is placed, the uniqueness flag is right and
    each usable build row finds itself."""
    rng = np.random.default_rng(cap)
    if case == "unique":
        port, _ = _unique_build(rng, cap - 10, cap)
    else:
        port, _ = _side(rng, "b", cap - 10, cap, "int64", cap // 3)
    key = port.column("bk")
    slot_row, bv, unique = tjoins.build_prep_hash(key, port.row_mask)
    assert slot_row.shape[0] == 1 << (2 * cap - 1).bit_length()
    usable = (port.row_mask & key.validity).numpy()
    keys = bv.numpy()[usable]
    assert bool(unique) == (len(np.unique(keys)) == len(keys)) \
        == (case == "unique")
    held = slot_row.numpy()[slot_row.numpy() >= 0]
    assert sorted(held) == list(np.nonzero(usable)[0])
    found, row = tjoins.pk_hash_probe(key, port.row_mask, slot_row, bv)
    assert found.numpy()[usable].all()
    assert (bv.numpy()[row.numpy()[usable]] == keys).all()


# ---------------------------------------------------------------------------
# The sorted prep, probe counts, and the join outputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["int64", "double"])
@pytest.mark.parametrize("distinct", [3, 40, 5000])
def test_sorted_prep_and_probe_counts_equal_to_jax(kind, distinct):
    rng = np.random.default_rng(distinct)
    build, jbuild = _side(rng, "b", 900, 1024, kind, distinct)
    probe, jprobe = _side(rng, "p", 1500, 2048, kind, distinct)
    b_order, sv, nvalid, unique = tjoins.build_prep_sorted(
        build.column("bk"), build.row_mask)
    kern = jjoins._JoinKernels(None)
    jb_order, jsv, jnvalid, junique = kern.build_prep_fn()(
        _key_col(jbuild, "bk"))
    np.testing.assert_array_equal(b_order.numpy(), np.asarray(jb_order))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    assert int(nvalid) == int(jnvalid) and bool(unique) == bool(junique)
    starts, counts = tjoins.probe_count(probe.column("pk"), probe.row_mask,
                                        sv, nvalid)
    jstarts, jcounts, _ = kern.probe_count_fn(False)(
        jb_order, jsv, jnvalid, _key_col(jprobe, "pk"))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("strategy", ["hash", "sort"])
@pytest.mark.parametrize("kind", ["int64", "double"])
@pytest.mark.parametrize("n_build,cap_build,n_probe,cap_probe",
                         [(6, 8, 40, 64), (700, 1024, 3000, 4096)])
def test_pk_join_output_equals_jax(strategy, kind, n_build, cap_build,
                                   n_probe, cap_probe):
    rng = np.random.default_rng(n_probe + len(strategy))
    build, jbuild = _unique_build(rng, n_build, cap_build, kind)
    probe, jprobe = _side(rng, "p", n_probe, cap_probe, kind, 8)
    # half the probe keys come from the build side
    pick = rng.integers(0, cap_build, cap_probe)
    hit = rng.random(cap_probe) < 0.5
    keys = np.where(hit, build.column("bk").data.numpy()[pick],
                    probe.column("pk").data.numpy())
    probe.column("pk").data.copy_(torch.from_numpy(keys))
    jcols = list(jprobe.columns)
    jcols[0] = jdev.DeviceColumn(jnp.asarray(keys), jcols[0].validity,
                                 jcols[0].dtype, None)
    jprobe = jdev.DeviceTable(tuple(jcols), jprobe.row_mask,
                              jprobe.num_rows, jprobe.names)
    node, jnode = _nodes(probe, build, jprobe, jbuild, strategy)
    got = node._pk_join(build, probe)
    kern = jnode._kernels
    if strategy == "hash":
        slot_row, bv, unique = kern.build_prep_hash_fn()(
            _key_col(jbuild, "bk"))
        want = kern.pk_hash_join_fn("inner")(
            jbuild, jprobe, _key_col(jprobe, "pk"), slot_row, bv)
    else:
        b_order, sv, nvalid, unique = kern.build_prep_fn()(
            _key_col(jbuild, "bk"))
        want = kern.pk_join_fn("inner")(
            jbuild, jprobe, _key_col(jprobe, "pk"), b_order, sv, nvalid)
    assert bool(unique) and got is not None
    _assert_planes_equal(got, want)
    assert int(got.num_rows) > 0


def test_pk_join_declines_a_build_with_repeated_keys():
    rng = np.random.default_rng(3)
    build, jbuild = _side(rng, "b", 500, 512, "int64", 20)
    probe, jprobe = _side(rng, "p", 500, 512, "int64", 20)
    for strategy in ("hash", "sort"):
        node, _ = _nodes(probe, build, jprobe, jbuild, strategy)
        assert node._pk_join(build, probe) is None


@pytest.mark.parametrize("kind", ["int64", "double"])
@pytest.mark.parametrize("distinct", [3, 30, 400])
def test_count_expand_join_output_equals_jax(kind, distinct):
    rng = np.random.default_rng(distinct + 1)
    build, jbuild = _side(rng, "b", 400, 512, kind, distinct)
    probe, jprobe = _side(rng, "p", 700, 1024, kind, distinct)
    node, jnode = _nodes(probe, build, jprobe, jbuild)
    # the hash prep finds the build keys repeat: the count path, one expand
    (got,) = node._probe_join(build, [probe])
    kern = jnode._kernels
    b_order, sv, nvalid, _ = kern.build_prep_fn()(_key_col(jbuild, "bk"))
    starts, counts, _ = kern.probe_count_fn(False)(
        b_order, sv, nvalid, _key_col(jprobe, "pk"))
    total = int(jnp.sum(jnp.where(jprobe.row_mask, counts, 0)))
    out_cap = jdev.bucket_rows(max(total, 1), 8)
    want = kern.expand_fn(out_cap, "inner")(jbuild, jprobe, b_order, starts,
                                            counts)
    assert got.capacity == out_cap and int(got.num_rows) == total > 0
    _assert_planes_equal(got, want)


def test_out_of_slice_joins_raise_naming_the_roadmap_step():
    """Every hash join type builds on the device, on multi-key, string,
    mixed-type keys and with a residual condition; what is still out of the
    slice raises naming its ROADMAP step: joins without equi-keys (the
    nested-loop join, step 6) and binary keys (step 8)."""
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    rng = np.random.default_rng(0)
    build, jbuild = _side(rng, "b", 6, 8, "int64", 4)
    probe, jprobe = _side(rng, "p", 6, 8, "int64", 4)
    node, _ = _nodes(probe, build, jprobe, jbuild)
    left, right = node.left, node.right
    for how in tjoins.SUPPORTED:
        for cond, lk, rk in [(None, ["pk"], ["bk"]),
                             (F.col("pd").expr, ["pk"], ["bk"]),
                             (None, ["pk", "pi"], ["bk", "bi"]),
                             (None, ["ps"], ["bs"]),
                             (None, ["pk"], ["bd"])]:
            tjoins.TpuShuffledHashJoinExec(
                left, right, lk, rk, how, cond, False, torch.device("cpu"))
    for how, lk, rk in [("cross", [], []), ("inner", [], [])]:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 step 6"):
            tjoins.TpuShuffledHashJoinExec(
                left, right, lk, rk, how, None, False, torch.device("cpu"))
    binary = type(left)(Schema([Field("pb", tdt.BINARY)]))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 step 8"):
        tjoins.TpuShuffledHashJoinExec(binary, binary, ["pb"], ["pb"],
                                       "inner", None, False,
                                       torch.device("cpu"))


# ---------------------------------------------------------------------------
# The host engine's numpy join against the JAX package's pandas join
# ---------------------------------------------------------------------------
def _host_sides(seed: int):
    rng = np.random.default_rng(seed)

    def side(n, prefix):
        words = np.array(["", "a", "ab", "BUILDING", "ünï", "zz"],
                         dtype=object)
        f = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.0, np.inf]), n)
        return pa.table({
            # negative keys (-1 among them) are keys, not nulls
            f"{prefix}k": pa.array(rng.integers(-6, 6, n),
                                   mask=rng.random(n) < 0.1),
            # dates before and after 1970-01-01
            f"{prefix}d": pa.array(rng.integers(-5, 3, n).astype(np.int32),
                                   type=pa.date32(),
                                   mask=rng.random(n) < 0.1),
            f"{prefix}s": pa.array(rng.choice(words, n).tolist(),
                                   mask=rng.random(n) < 0.1),
            f"{prefix}f": pa.array(f, mask=rng.random(n) < 0.05),
            f"{prefix}v": pa.array(rng.normal(size=n))})
    return side(300, "l"), side(200, "r")


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
@pytest.mark.parametrize("keys", [["k"], ["d"], ["s"], ["f"], ["k", "s"]])
@pytest.mark.parametrize("with_condition", [False, True])
def test_host_join_equals_jax_host_engine(how, keys, with_condition):
    lt, rt = _host_sides(len(keys) + len(how))
    lkeys = [f"l{k}" for k in keys]
    rkeys = [f"r{k}" for k in keys]
    cond = (F.col("lv") < F.col("rv")).expr if with_condition else None
    jcond = (JF.col("lv") < JF.col("rv")).expr if with_condition else None
    port_l, port_r = HostTable.from_arrow(lt), HostTable.from_arrow(rt)
    if cond is not None:
        from spark_rapids_tpu_torch.expr.base import resolve_expression
        from spark_rapids_tpu.expr.base import \
            resolve_expression as jresolve
        types = {**{n: c.dtype for n, c in zip(port_l.names,
                                               port_l.columns)},
                 **{n: c.dtype for n, c in zip(port_r.names,
                                               port_r.columns)}}
        cond = resolve_expression(cond, types)
        jcond = jresolve(jcond, {n: jdt.DOUBLE for n in ("lv", "rv")})
    got = join_host_tables(port_l, port_r, lkeys, rkeys, how, cond,
                           False).to_arrow()
    want = jpj.join_host_tables(JHostTable.from_arrow(lt),
                                JHostTable.from_arrow(rt), lkeys, rkeys, how,
                                jcond, False).to_arrow()
    assert got.num_rows > 0
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_host_using_join_merges_keys_like_jax(how):
    lt, rt = _host_sides(9)
    lt = lt.rename_columns(["k", "ld", "ls", "lf", "lv"])
    rt = rt.rename_columns(["k", "rd", "rs", "rf", "rv"])
    got = join_host_tables(HostTable.from_arrow(lt), HostTable.from_arrow(rt),
                           ["k"], ["k"], how, None, True).to_arrow()
    want = jpj.join_host_tables(JHostTable.from_arrow(lt),
                                JHostTable.from_arrow(rt), ["k"], ["k"], how,
                                None, True).to_arrow()
    assert got.column_names == want.column_names
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("kind", ["bigint", "date"])
@pytest.mark.parametrize("shape", ["broadcast", "shuffled", "side_swap"])
def test_device_join_equals_host_engine_on_negative_and_pre_1970_keys(
        kind, shape):
    """Negative integer keys (-1 among them) and dates before 1970 match
    like any other key on the device join and in the host engine, through
    the PK hash path (unique build), the count/expand path (repeated build
    keys) and AQE's side swap; both equal the JAX package."""
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(11)
    typ = pa.int64() if kind == "bigint" else pa.date32()

    def keys(v):
        v = np.asarray(v)
        return pa.array(v if kind == "bigint" else v.astype(np.int32),
                        type=typ)
    dim = pa.table({"dk": keys(rng.permutation(np.arange(-40, 10))),
                    "dv": pa.array(rng.normal(size=50))})
    fact = pa.table({"fk": pa.array(keys(rng.integers(-45, 12, 600)),
                                    mask=rng.random(600) < 0.05),
                     "fv": pa.array(rng.integers(0, 100, 600))})
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 8,
            "spark.rapids.sql.test.enabled": True}
    if shape != "broadcast":
        conf["spark.rapids.tpu.autoBroadcastJoinThreshold"] = -1
    if shape == "shuffled":
        conf["spark.rapids.tpu.aqe.enabled"] = False
    if shape == "side_swap":
        conf["spark.rapids.tpu.aqe.autoBroadcastJoinThreshold"] = 1000
    outs = []
    for sess, fns in ((TorchSession(conf, device="cpu"), F),
                      (TpuSession(conf), JF)):
        d = sess.create_dataframe(dim, num_partitions=2)
        f = sess.create_dataframe(fact, num_partitions=2)
        col = fns.col
        # fact x dim builds on the unique dim keys; dim x fact on the
        # repeated fact keys (unless AQE swaps the sides back)
        outs.append([
            a.join(b, condition=col(ak) == col(bk))
            .select(col(ak), col("dv"), col("fv"))
            for a, b, ak, bk in ((f, d, "fk", "dk"), (d, f, "dk", "fk"))])
    for q, jq in zip(*outs):
        got = q.collect()
        assert got.num_rows > 0
        storage = pa.int64() if kind == "bigint" else pa.int32()
        assert (np.asarray(got.column(0).cast(storage)) < 0).any()
        assert_tables_equal(got, q.collect(device=False), ignore_order=True)
        assert_tables_equal(got, jq.collect(device=True), ignore_order=True)
