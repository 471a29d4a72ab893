"""Every join type of the port's device hash join against the JAX package's,
on the same numpy-seeded inputs: first the units plane for plane (the join
codes over any tuple of keys, the counts, the per-build-row matches, the
expands of inner/left/full joins, the semi/anti masks, the null-padded
leftovers, the residual-condition expands, the single-pass semi/anti/left
joins, the row window), then whole joins through ``TorchSession`` on the
CPU against the port's host engine and the JAX package, in the cases of the
JAX package's ``tests/test_device_joins.py``: every join type, multi-key,
null keys, NaN and -0.0 keys, duplicate expansion, empty sides, residual
conditions on inner and outer joins, string keys, right outer joins over
partitions, mixed-type keys, the hash and sort strategies, and an output
over the batch budget (the windowed expand)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import device as jdev
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.expr.base import resolve_expression as jresolve
from spark_rapids_tpu.plan.schema import Field as JField
from spark_rapids_tpu.plan.schema import Schema as JSchema
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.columnar import device as tdev
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.expr.base import resolve_expression
from spark_rapids_tpu_torch.plan.schema import Field, Schema
from spark_rapids_tpu_torch.session import TorchSession

from harness import assert_tables_equal, data_gen
from test_torch_joins import _assert_planes_equal, _key_col, _side

_HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
#: key column sets: a direct key (one fixed-width type) and general ones
_KEYS = {"int64": ("int64", ["k"]), "double": ("double", ["k"]),
         "string": ("int64", ["s"]), "int64+string": ("int64", ["k", "s"]),
         "double+int32": ("double", ["k", "i"])}


_JAX_TYPES = {"bigint": jdt.LONG, "int": jdt.INT, "double": jdt.DOUBLE,
              "float": jdt.FLOAT, "boolean": jdt.BOOLEAN, "date": jdt.DATE,
              "string": jdt.STRING}


class _Side:
    def __init__(self, schema):
        self.schema = schema


def _schemas(t):
    return Schema([Field(n, c.dtype) for n, c in zip(t.names, t.columns)])


def _jschema(t):
    return JSchema([JField(n, c.dtype) for n, c in zip(t.names, t.columns)])


def _sides(seed: int, kind: str, distinct: int, n_build=150, cap_build=256,
           n_probe=300, cap_probe=512):
    rng = np.random.default_rng(seed)
    build, jbuild = _side(rng, "b", n_build, cap_build, kind, distinct)
    probe, jprobe = _side(rng, "p", n_probe, cap_probe, kind, distinct)
    return build, jbuild, probe, jprobe


def _condition(probe, build, text: str):
    """A residual condition over the pair schema, resolved in both
    engines: ``lt`` = ``pd < bd + pi``, ``ne`` = ``pi != bi``."""
    def expr(fns):
        col = fns.col
        if text == "lt":
            return (col("pd") < col("bd") + col("pi")).expr
        return (col("pi") != col("bi")).expr
    types = {**{n: c.dtype for n, c in zip(probe.names, probe.columns)},
             **{n: c.dtype for n, c in zip(build.names, build.columns)}}
    jtypes = {n: _JAX_TYPES[repr(d)] for n, d in types.items()}
    return resolve_expression(expr(F), types), jresolve(expr(JF), jtypes)


def _nodes(probe, build, jprobe, jbuild, how, keys, cond=None,
           strategy="hash"):
    lkeys = [f"p{k}" for k in keys]
    rkeys = [f"b{k}" for k in keys]
    pcond = jcond = None
    if cond is not None:
        pcond, jcond = _condition(probe, build, cond)
    node = tjoins.TpuShuffledHashJoinExec(
        _Side(_schemas(probe)), _Side(_schemas(build)), lkeys, rkeys, how,
        pcond, False, torch.device("cpu"), strategy, 8)
    jnode = jjoins.TpuShuffledHashJoinExec(
        jjoins._JoinSchemaOnly(_jschema(jprobe)),
        jjoins._JoinSchemaOnly(_jschema(jbuild)), lkeys, rkeys, how, jcond,
        False, min_bucket=8)
    return node, jnode


def _jax_counts(jnode, jbuild, jprobe, track: bool):
    """The JAX package's counts for this node: the direct probe counts over
    the sorted prep, or the general join codes."""
    kern = jnode._kernels
    if jnode._direct_key_ok():
        b_order, sv, nvalid, _ = kern.build_prep_fn()(
            _key_col(jbuild, jnode.right_keys[0]))
        starts, counts, matched = kern.probe_count_fn(track)(
            b_order, sv, nvalid, _key_col(jprobe, jnode.left_keys[0]))
        return b_order, starts, counts, matched if track else None
    b_order, starts, counts, bgid, pgid = kern.counts_fn()(
        jjoins._key_view(jbuild, jnode.right_keys),
        jjoins._key_view(jprobe, jnode.left_keys))
    return b_order, starts, counts, \
        kern.matched_fn()(bgid, pgid) if track else None


def _eq(port: torch.Tensor, jax_arr) -> None:
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_arr))


# ---------------------------------------------------------------------------
# Units, plane for plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("keys", sorted(_KEYS))
@pytest.mark.parametrize("distinct", [3, 60])
def test_join_codes_and_counts_equal_jax(keys, distinct):
    """``join_codes`` (strings, floats with NaN/-0.0/+-inf, nulls, masked
    rows), ``count_matches`` and ``build_matched`` against ``_join_codes``,
    ``_count_matches`` and ``_build_matched``."""
    kind, names = _KEYS[keys]
    build, jbuild, probe, jprobe = _sides(distinct, kind, distinct)
    bgid, pgid = tjoins.join_codes(
        [build.column(f"b{k}") for k in names], build.row_mask,
        [probe.column(f"p{k}") for k in names], probe.row_mask)
    jbgid, jpgid = jjoins._join_codes(
        [jbuild.column(f"b{k}") for k in names], jbuild.row_mask,
        [jprobe.column(f"p{k}") for k in names], jprobe.row_mask)
    _eq(bgid, jbgid)
    _eq(pgid, jpgid)
    for got, want in zip(tjoins.count_matches(bgid, pgid),
                         jjoins._count_matches(jbgid, jpgid)):
        _eq(got, want)
    matched = tjoins.build_matched(bgid, pgid)
    _eq(matched, jjoins._build_matched(jbgid, jpgid))
    assert bool(matched.any()) and int(tjoins.count_matches(
        bgid, pgid)[2].sum()) > 0


@pytest.mark.parametrize("kind", ["int64", "double"])
def test_probe_counts_with_tracking_equal_jax(kind):
    """The direct path's per-build-row matches (``probe_count_fn(True)``)."""
    build, jbuild, probe, jprobe = _sides(7, kind, 40)
    node, jnode = _nodes(probe, build, jprobe, jbuild, "full", ["k"])
    got = node._counts(build, probe, True)
    want = _jax_counts(jnode, jbuild, jprobe, True)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("how", _HOWS)
@pytest.mark.parametrize("keys", ["int64", "string", "double+int32"])
def test_count_path_outputs_equal_jax(how, keys):
    """The count path without a condition: the semi/anti masks, the expands
    (``right`` as inner, ``full`` as left, unmatched probe rows inline) and
    the right/full leftovers, against ``semi_mask_fn``, ``expand_fn`` and
    ``leftover_fn``."""
    kind, names = _KEYS[keys]
    build, jbuild, probe, jprobe = _sides(len(how), kind, 30)
    node, jnode = _nodes(probe, build, jprobe, jbuild, how, names)
    track = how in ("right", "full")
    b_order, starts, counts, matched = node._counts(build, probe, track)
    jb_order, jstarts, jcounts, jmatched = _jax_counts(jnode, jbuild, jprobe,
                                                       track)
    kern = jnode._kernels
    if how in ("left_semi", "left_anti"):
        got = next(node._probe_join(build, [probe]))
        if node._direct_key_ok():
            # the hash prep answers semi/anti in one pass: the JAX one too
            slot_row, bv, _ = kern.build_prep_hash_fn()(_key_col(jbuild,
                                                                 "bk"))
            want = kern.pk_hash_join_fn(how)(jbuild, jprobe,
                                             _key_col(jprobe, "pk"),
                                             slot_row, bv)
            got, want = tdev.shrink_to_fit(got, 8), jdev.shrink_to_fit(
                want, 8)
        else:
            want = kern.semi_mask_fn(how == "left_anti")(jprobe, jcounts)
        _assert_planes_equal(got, want)
        return
    eff = {"right": "inner", "full": "left"}.get(how, how)
    total = node._slot_total(probe, counts)
    out_cap = tdev.bucket_rows(total, 8)
    got = node._expand(build, probe, b_order, starts, counts, out_cap, eff)
    want = kern.expand_fn(out_cap, eff)(jbuild, jprobe, jb_order, jstarts,
                                        jcounts)
    _assert_planes_equal(got, want)
    assert int(got.num_rows) == total
    if track:
        _eq(matched, jmatched)
        _assert_planes_equal(
            node.pad_build(build, build.row_mask & ~matched),
            kern.leftover_fn()(jbuild, jmatched))


@pytest.mark.parametrize("how", _HOWS)
@pytest.mark.parametrize("cond", ["lt", "ne"])
def test_residual_condition_outputs_equal_jax(how, cond):
    """``expand_cond_fn`` (outer-correct: pairs, the null-padded probe rows
    none of whose pairs passed, the seen update; semi/anti pairs of only
    the referenced columns) and the inner join's condition filter."""
    build, jbuild, probe, jprobe = _sides(len(how) + len(cond), "int64", 12)
    node, jnode = _nodes(probe, build, jprobe, jbuild, how, ["k"], cond)
    b_order, starts, counts, _ = node._counts(build, probe, False)
    jb_order, jstarts, jcounts, _ = _jax_counts(jnode, jbuild, jprobe, False)
    out_cap = tdev.bucket_rows(node._slot_total(probe, counts), 8)
    seen = [torch.zeros(build.capacity, dtype=torch.bool)]
    got = list(node._expand_one(build, probe, b_order, starts, counts,
                                out_cap, seen))
    kern = jnode._kernels
    if how == "inner":
        out = kern.expand_fn(out_cap, "inner")(jbuild, jprobe, jb_order,
                                               jstarts, jcounts)
        want = [jjoins._condition_filter_fn(jnode.condition)(out)]
    else:
        res = kern.expand_cond_fn(out_cap, how)(jbuild, jprobe, jb_order,
                                                jstarts, jcounts)
        want = list(res) if isinstance(res, tuple) else [res]
        if how in ("right", "full"):
            _eq(seen[0], want.pop())
            assert bool(seen[0].any())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_planes_equal(g, w)
    assert int(got[0].num_rows) > 0


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
@pytest.mark.parametrize("strategy", ["hash", "sort"])
def test_single_pass_joins_equal_jax(how, strategy):
    """``pk_hash_join_fn`` / ``pk_join_fn`` for every type they serve, on a
    unique build, and under the hash prep on a build of repeated keys
    (semi and anti only; the others decline it)."""
    rng = np.random.default_rng(len(how))
    from test_torch_joins import _unique_build
    build, jbuild = _unique_build(rng, 200, 256)
    probe, jprobe = _side(rng, "p", 400, 512, "int64", 4 * 256)
    pkey = probe.columns[0].data.numpy()
    pkey[::2] = build.columns[0].data.numpy()[:256][
        rng.integers(0, 200, 256)]
    probe.columns[0].data.copy_(torch.from_numpy(pkey))
    cols = list(jprobe.columns)
    cols[0] = jdev.DeviceColumn(jnp.asarray(pkey), cols[0].validity,
                                cols[0].dtype, None)
    jprobe = jdev.DeviceTable(tuple(cols), jprobe.row_mask, jprobe.num_rows,
                              jprobe.names)
    dups, jdups, _, _ = _sides(3, "int64", 40, 300, 512)
    for b, jb, unique in ((build, jbuild, True), (dups, jdups, False)):
        node, jnode = _nodes(probe, b, jprobe, jb, how, ["k"],
                             strategy=strategy)
        got = node._pk_join(b, probe)
        if not unique and (strategy == "sort" or how in ("inner", "left")):
            assert got is None
            continue
        kern = jnode._kernels
        if strategy == "hash":
            slot_row, bv, _ = kern.build_prep_hash_fn()(_key_col(jb, "bk"))
            want = kern.pk_hash_join_fn(how)(jb, jprobe,
                                             _key_col(jprobe, "pk"),
                                             slot_row, bv)
        else:
            b_order, sv, nvalid, _ = kern.build_prep_fn()(_key_col(jb,
                                                                   "bk"))
            want = kern.pk_join_fn(how)(jb, jprobe, _key_col(jprobe, "pk"),
                                        b_order, sv, nvalid)
        _assert_planes_equal(got, want)
        assert 0 < int(got.num_rows)


@pytest.mark.parametrize("start,length", [(0, 64), (64, 64), (448, 64),
                                          (500, 64), (0, 1024), (96, 128)])
def test_slice_rows_equals_jax(start, length):
    build, jbuild, _, _ = _sides(5, "int64", 30, 300, 512)
    _assert_planes_equal(tdev.slice_rows(build.compact(), start, length),
                         jdev.slice_rows(jbuild.compact(), start, length))


def test_null_padding_columns_equal_jax():
    for name in ("bigint", "int", "double", "float", "boolean", "date",
                 "string"):
        got = tjoins.null_device_column(tdt.from_simple_name(name), 16,
                                        torch.device("cpu"))
        want = jjoins._null_device_column(_JAX_TYPES[name], 16)
        _eq(got.data, want.data)
        _eq(got.validity, want.validity)
        assert (got.lengths is None) == (want.lengths is None)


# ---------------------------------------------------------------------------
# Whole joins through the sessions (the cases of test_device_joins.py)
# ---------------------------------------------------------------------------
def _join_nodes(plan):
    """The device join nodes of a plan that ran (through AQE's stages)."""
    stack, found = [plan], []
    while stack:
        node = stack.pop()
        if "HashJoinExec" in type(node).__name__:
            found.append(node)
        stage = getattr(node, "stage", None)
        stack.extend([stage.inner] if stage is not None else node.children)
    return found


def _check(query, tables, conf=None, parts=2, ordered=True, event=None):
    """Run ``query(fns, dataframes)`` through the port on the CPU (with
    ``test.enabled``, so nothing may leave the device), the port's host
    engine and the JAX package: the port's device join ran and its rows
    equal the JAX package's in order (``ordered``) and the host engine's
    as a multiset; ``event`` begins one of the AQE events. Returns the
    port's result."""
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 8, **(conf or {})}
    sess = TorchSession({**conf, "spark.rapids.sql.test.enabled": True},
                        device="cpu")
    jsess = TpuSession(conf)
    q, jq = (query(fns, {k: s.create_dataframe(v, num_partitions=parts)
                         for k, v in tables.items()})
             for s, fns in ((sess, F), (jsess, JF)))
    plan = sess._physical(q.logical, True)
    got = plan.collect().to_arrow()
    assert _join_nodes(plan), plan.tree_string()
    if event is not None:
        assert any(e.startswith(event) for e in plan.events), plan.events
    assert_tables_equal(got, jq.collect(device=True),
                        ignore_order=not ordered)
    assert_tables_equal(got, q.collect(device=False), ignore_order=True)
    return got


@pytest.fixture(scope="module")
def gen_sides():
    rng = np.random.default_rng(17)
    return {"l": data_gen(rng, 200, {"k": ("int32", 0, 30),
                                     "k2": ("int64", 0, 4), "a": "int64",
                                     "fa": "float64"}),
            "r": data_gen(rng, 150, {"k": ("int32", 0, 30),
                                     "k2": ("int64", 0, 4),
                                     "b": "float64"})}


@pytest.mark.parametrize("how", _HOWS)
@pytest.mark.parametrize("on", [["k"], ["k", "k2"]])
def test_join_types_and_multi_key_match_jax(gen_sides, how, on):
    _check(lambda fns, t: t["l"].join(
        t["r"] if len(on) > 1 else t["r"].select("k", "b"), on=on, how=how),
        gen_sides)


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_padded_side_reads_as_null_downstream(gen_sides, how):
    """The columns an outer join pads are null to the expressions above
    it (the padded side gives up its null-free promise): counts, sums and
    an IS NULL filter over them equal the JAX package's."""
    def query(fns, t):
        col = fns.col
        j = t["l"].join(t["r"].select(col("k").alias("rk"), col("b"),
                                      col("k2").alias("rk2")),
                        how=how, condition=col("k") == col("rk"))
        return (j.filter(col("rk2").is_null() | (col("a") > fns.lit(0)))
                .group_by("k2")
                .agg(fns.count(col("rk")).alias("n_rk"),
                     fns.count(col("a")).alias("n_a"),
                     fns.sum(col("rk2")).alias("s_rk2"),
                     fns.count_star().alias("n"))
                .sort("k2"))
    nulls_free = {k: pa.table({c: pa.array(v.column(c).to_numpy(
        zero_copy_only=False)) for c in v.column_names})
        for k, v in gen_sides.items()}
    got = _check(query, nulls_free)
    assert got.num_rows > 0


@pytest.mark.parametrize("how", _HOWS)
def test_null_keys_never_match(how):
    tables = {"l": pa.table({"k": [1, None, 2, None, 3],
                             "a": [1, 2, 3, 4, 5]}),
              "r": pa.table({"k": [1, None, 3, 4],
                             "b": [10.0, 20.0, 30.0, 40.0]})}
    got = _check(lambda fns, t: t["l"].join(t["r"], on="k", how=how),
                 tables, parts=1)
    # 2 matches (1, 3); full adds 3 unmatched left rows and 2 right ones
    assert got.num_rows == {"inner": 2, "left": 5, "right": 4, "full": 7,
                            "left_semi": 2, "left_anti": 3}[how]


@pytest.mark.parametrize("how", ["inner", "full", "left_semi"])
def test_nan_and_negative_zero_keys_match(how):
    tables = {"l": pa.table({"k": [1.0, float("nan"), -0.0, 2.5],
                             "a": [1, 2, 3, 4]}),
              "r": pa.table({"k": [float("nan"), 0.0, 2.5],
                             "b": [10, 20, 30]})}
    got = _check(lambda fns, t: t["l"].join(t["r"], on="k", how=how),
                 tables, parts=1)
    assert got.num_rows == {"inner": 3, "full": 4, "left_semi": 3}[how]


def test_duplicate_expansion():
    tables = {"l": pa.table({"k": np.repeat([1, 2], 50),
                             "a": np.arange(100)}),
              "r": pa.table({"k": np.repeat([1, 2, 3], 40),
                             "b": np.arange(120)})}
    got = _check(lambda fns, t: t["l"].join(t["r"], on="k"), tables)
    assert got.num_rows == 2 * 50 * 40


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_anti"])
def test_empty_sides(how):
    tables = {"e": pa.table({"k": pa.array([], type=pa.int64()),
                             "a": pa.array([], type=pa.int64())}),
              "r": pa.table({"k": [1, 2], "b": [1.0, 2.0]})}
    _check(lambda fns, t: t["e"].join(t["r"], on="k", how=how), tables)
    _check(lambda fns, t: t["r"].join(t["e"], on="k", how=how), tables)


@pytest.mark.parametrize("how", _HOWS)
def test_residual_conditions_on_every_join_type(how):
    """A probe row whose every candidate fails the condition is padded
    (left/full), dropped (semi) or kept (anti); build rows only failing
    pairs touched come back in right/full (GpuHashJoin.scala:507)."""
    rng = np.random.default_rng(len(how))
    tables = {"l": data_gen(rng, 120, {"lk": ("int32", 0, 12),
                                       "a": "int64"}),
              "r": data_gen(rng, 90, {"rk": ("int32", 0, 12),
                                      "b": "float64"})}

    def query(fns, t):
        col = fns.col
        dbl = (jdt if fns is JF else tdt).DOUBLE
        return t["l"].join(t["r"], how=how, condition=(
            col("lk") == col("rk")) & (col("a").cast(dbl) > col("b")))
    _check(query, tables)


@pytest.mark.parametrize("how", _HOWS)
def test_string_keys(how):
    tables = {"l": pa.table({"k": ["a", "b", None, "longer-key-aaaa", "b",
                                   ""],
                             "v": [1, 2, 3, 4, 5, 6]}),
              "r": pa.table({"k": ["b", "c", None, "longer-key-aaaa", ""],
                             "w": [3, 4, 5, 6, 7]})}
    got = _check(lambda fns, t: t["l"].join(t["r"], on="k", how=how),
                 tables)
    if how == "inner":
        assert sorted(got.column("k").to_pylist()) == [
            "", "b", "b", "longer-key-aaaa"]


@pytest.mark.parametrize("how", ["right", "full"])
def test_right_outer_over_partitions_emits_unmatched_build_rows_once(how):
    rng = np.random.default_rng(3)
    tables = {"l": data_gen(rng, 40, {"k": ("int32", 0, 5), "a": "int64"}),
              "r": pa.table({"k": pa.array([1, 99], type=pa.int32()),
                             "b": [1.0, 2.0]})}
    got = _check(lambda fns, t: t["l"].join(t["r"].select("k", "b"),
                                            on="k", how=how), tables,
                 parts=3)
    assert got.column("k").to_pylist().count(99) == 1
    if how == "right":
        # AQE swaps the sides of a right join whose left side is small: a
        # broadcast left join
        _check(lambda fns, t: t["r"].join(t["l"], on="k", how=how), tables,
               parts=3, event="demoted right join to broadcast via side swap")


@pytest.mark.parametrize("how", ["inner", "full", "left_semi",
                                 "left_anti"])
def test_mixed_type_keys_coerce(how):
    tables = {"f": pa.table({"k": pa.array(np.arange(40) % 10),
                             "v": pa.array(np.ones(40))}),
              "d": pa.table({"k": pa.array(np.arange(0, 10, 2,
                                                     dtype=np.float64)),
                             "w": pa.array(np.arange(5, dtype=np.float64))})}
    got = _check(lambda fns, t: t["f"].join(t["d"], on="k", how=how),
                 tables, {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1},
                 parts=3)
    assert got.num_rows == {"inner": 20, "full": 40, "left_semi": 20,
                            "left_anti": 20}[how]
    assert str(got.schema.field("k").type) == (
        "double" if how in ("inner", "full") else "int64")


@pytest.mark.parametrize("strategy", ["hash", "sort"])
@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_hash_and_sort_strategies_on_unique_and_repeated_builds(strategy,
                                                                how):
    rng = np.random.default_rng(13)
    n = 3000
    kv = rng.integers(0, 500, n)
    kmask = np.zeros(n, bool)
    kmask[::37] = True
    tables = {"fact": pa.table({"k": pa.array(kv, mask=kmask),
                                "v": rng.normal(size=n)}),
              "dim": pa.table({"k": np.arange(500, dtype=np.int64),
                               "w": rng.normal(size=500)}),
              "dup": pa.table({"k": np.repeat(np.arange(50, dtype=np.int64),
                                              2),
                               "w": rng.normal(size=100)})}
    conf = {"spark.rapids.tpu.join.strategy": strategy,
            "spark.rapids.tpu.autoBroadcastJoinThreshold": -1}
    for build in ("dim", "dup"):
        _check(lambda fns, t: t["fact"].join(
            t[build].filter(fns.col("k") < fns.lit(300)), on="k", how=how),
            tables, conf)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi"])
def test_output_over_the_batch_budget_comes_in_windows(how, monkeypatch):
    """An output over ``batchSizeBytes`` is expanded in windows of probe
    rows (``_windowed_expand``), a skewed window split again; the rows
    equal the JAX package's, which windows the same way."""
    rng = np.random.default_rng(5)
    tables = {"l": pa.table({"k": rng.integers(0, 8, 600),
                             "a": np.arange(600)}),
              "r": pa.table({"k": np.concatenate([rng.integers(0, 6, 200),
                                                  np.zeros(300, np.int64)]),
                             "b": np.arange(500) * 0.5})}

    def query(fns, t):
        col = fns.col
        return t["l"].join(t["r"].select(col("k").alias("rk"), col("b")),
                           how=how, condition=(col("k") == col("rk"))
                           & (col("b") > fns.lit(1.0)))
    budget = {"spark.rapids.sql.batchSizeBytes": 32 * 1024,
              "spark.rapids.tpu.autoBroadcastJoinThreshold": -1}
    depth, nested = [0], []
    real = tjoins.TpuShuffledHashJoinExec._windowed_expand

    def spy(self, *args):
        nested.append(depth[0] > 0)
        depth[0] += 1
        try:
            yield from real(self, *args)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(tjoins.TpuShuffledHashJoinExec, "_windowed_expand",
                        spy)
    _check(query, tables, budget)
    assert False in nested
    if how in ("inner", "left", "full"):
        # a window of key-0 rows (each matching 300+ rows) splits again
        assert True in nested


@pytest.mark.parametrize("how", ["left_anti", "left_semi", "inner"])
def test_build_side_over_the_batch_budget_takes_the_grace_join(
        monkeypatch, how):
    """A build side over ``batchSizeBytes`` takes the grace join (both
    sides bucketed by key, joined bucket by bucket): the port's device
    rows equal its host engine's and the JAX package's, which takes its
    grace join too."""
    t = pa.table({"k": np.arange(5000), "v": np.arange(5000) * 0.5})
    conf = {"spark.rapids.sql.batchSizeBytes": 32 * 1024,
            "spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.aqe.enabled": False}
    builds = []
    real = tjoins.TpuShuffledHashJoinExec._grace_join

    def spy(self, build, pidx):
        builds.append(build.nbytes())
        yield from real(self, build, pidx)
    monkeypatch.setattr(tjoins.TpuShuffledHashJoinExec, "_grace_join", spy)

    def query(fns, tables):
        df = tables["t"]
        return df.join(df.select(fns.col("k").alias("k2")),
                       condition=fns.col("k") == fns.col("k2"), how=how)
    got = _check(query, {"t": t}, conf)
    assert builds and all(b > 32 * 1024 for b in builds)
    assert got.num_rows == (0 if how == "left_anti" else 5000)


def test_join_codes_keep_subnormals_apart_from_zero():
    """Spark keys a subnormal double apart from 0.0 and from other
    subnormals. The port's join codes do; on the CPU the JAX package's
    ``_join_codes`` flushes them to zero (ROADMAP Queue 3), so this pins
    the port against Python's equality instead."""
    b = np.array([0.0, 5e-324, 1e-310, 1.0, -1e-310])
    p = np.array([5e-324, 0.0, -0.0, 1e-310, 2e-310])

    def col(a):
        return tdev.DeviceColumn(torch.from_numpy(a),
                                 torch.ones(len(a), dtype=torch.bool),
                                 tdt.DOUBLE, True)
    ones = torch.ones(len(b), dtype=torch.bool)
    bgid, pgid = tjoins.join_codes([col(b)], ones, [col(p)], ones)
    for i, x in enumerate(b):
        for j, y in enumerate(p):
            assert (bgid[i] == pgid[j]) == (x == y), (x, y)
