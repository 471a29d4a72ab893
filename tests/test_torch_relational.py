"""The relational surface through the port (``TorchSession(device="cpu")``),
its host engine and the JAX package: union, range, sample, cache,
rollup/cube/grouping_sets, ``DataFrame.count``, ``GroupedData.count``,
``to_device_batches``, ``num_partitions`` and ``to_torch`` (the JAX
package's ``to_jax``). Results are equal (doubles at rel 1e-9), and so are
plans (``tree_string()`` after the run) and AQE's events; a sample keeps
the JAX package's rows bit for bit (the splitmix64 position hash, which
the port computes in int64 with masked shifts)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.expr.base import EvalContext as JEvalContext
from spark_rapids_tpu.expr.hashing import SampleMask as JSampleMask
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.exec.cache import CACHE_HITS
from spark_rapids_tpu_torch.exec.transitions import UPLOAD_BYTES
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.expr.base import EvalContext
from spark_rapids_tpu_torch.expr.hashing import SampleMask
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession

from harness import assert_tables_equal, data_gen

_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 64}


@pytest.fixture(scope="module")
def jax_sessions():
    return {aqe: TpuSession(dict(_CONF, **{
        "spark.rapids.tpu.aqe.enabled": aqe})) for aqe in (True, False)}


@pytest.fixture(scope="module")
def gdata():
    """tests/test_exec_nodes.py's grouping frame."""
    rng = np.random.default_rng(0)
    return data_gen(rng, 300, {"a": ("int32", 0, 4), "b": ("int64", 0, 3),
                               "v": "float64", "s": "string"})


def _three(build, tables, jax_sessions, parts=2, aqe=True,
           ignore_order=True):
    """``build(F, session, dataframes)`` through the port's device path,
    its host engine and the JAX package: equal results, plans and events
    -> (port result, port plan)."""
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe,
                          "spark.rapids.sql.test.enabled": True})
    sess = TorchSession(conf, device="cpu")
    q = build(F, sess, {k: sess.create_dataframe(v, num_partitions=parts)
                        for k, v in tables.items()})
    plan = sess._physical(q.logical, True)
    out = plan.collect().to_arrow()
    host = q.collect(device=False)
    js = jax_sessions[aqe]
    jq = build(JF, js, {k: js.create_dataframe(v, num_partitions=parts)
                        for k, v in tables.items()})
    jplan = js._physical(jq.logical, True)
    jout = jplan.collect().to_arrow()
    assert out.schema == host.schema == jout.schema
    assert_tables_equal(out, host, ignore_order)
    assert_tables_equal(out, jout, ignore_order)
    text = plan.tree_string()
    assert text == jplan.tree_string()
    assert "Cpu" not in text.replace("CpuScanExec", "")
    if isinstance(plan, AdaptiveExec):
        assert plan.events == jplan.events
    return out, plan


# -- rollup, cube, grouping sets ---------------------------------------------
@pytest.mark.parametrize("aqe", [True, False])
@pytest.mark.parametrize("kind", ["rollup", "cube", "sets", "string",
                                  "grouping column"])
def test_grouping_sets(gdata, jax_sessions, aqe, kind):
    def build(f, s, t):
        d, col = t["g"], f.col
        if kind == "rollup":
            return d.rollup("a", "b").agg(f.sum(col("v")).alias("s"),
                                          f.count_star().alias("c"))
        if kind == "cube":
            return d.cube("a", "b").agg(f.avg(col("v")).alias("m"))
        if kind == "sets":
            return d.grouping_sets([["a"], ["b"], []], "a", "b").agg(
                f.min(col("v")).alias("lo"), f.max(col("v")).alias("hi"))
        if kind == "string":
            return d.rollup("s", "a").agg(f.count_star().alias("c"))
        # Spark: an aggregate of a grouping column reads its real values
        return d.rollup("a").agg(f.sum(col("a")).alias("s"),
                                 f.count(col("a")).alias("c"))
    out, plan = _three(build, {"g": gdata}, jax_sessions, aqe=aqe)
    assert "Expand" in plan.tree_string()
    if kind == "sets":
        import pyarrow.compute as pc
        assert out.num_rows == len(pc.unique(gdata.column("a"))) \
            + len(pc.unique(gdata.column("b"))) + 1


def test_rollup_aggregates_grouping_column(jax_sessions):
    """Spark: rollup('a').agg(sum('a')) sums the real values in the row
    where 'a' is aggregated away."""
    out, _ = _three(lambda f, s, d: d["t"].rollup("a").agg(
        f.sum(f.col("a")).alias("s"), f.count(f.col("a")).alias("c")),
        {"t": pa.table({"a": [1, 2, 3]})}, jax_sessions, parts=1)
    rows = sorted(out.to_pylist(), key=lambda r: (r["a"] is None, r["a"]))
    assert rows[-1] == {"a": None, "s": 6, "c": 3}


def test_rollup_distinguishes_real_nulls(jax_sessions):
    t = pa.table({"a": [1, None, 1, None], "v": [1.0, 2.0, 3.0, 4.0]})
    out, _ = _three(lambda f, s, d: d["t"].rollup("a").agg(
        f.sum(f.col("v")).alias("s")), {"t": t}, jax_sessions, parts=1)
    rows = sorted(out.to_pylist(), key=lambda r: (r["a"] is None, r["s"]))
    assert [r["s"] for r in rows] == [4.0, 6.0, 10.0]


def test_grouping_sets_reject_unknown_columns_and_expressions():
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(pa.table({"a": [1], "b": [2]}))
    with pytest.raises(ValueError):
        df.grouping_sets([["c"]], "a", "b")
    with pytest.raises(TypeError):
        df.rollup(F.col("a") + F.lit(1))


# -- union -------------------------------------------------------------------
@pytest.mark.parametrize("aqe", [True, False])
def test_union(gdata, jax_sessions, aqe):
    """A union of 2 + 2 partitions is 4; grouped over, it exchanges to one
    (the partition count and the plans are the JAX package's)."""
    def plain(f, s, t):
        d = t["g"]
        return d.union(d.filter(f.col("a") > f.lit(1)))

    def grouped(f, s, t):
        return plain(f, s, t).group_by("a").agg(f.sum(f.col("v")).alias("s"))
    out, plan = _three(plain, {"g": gdata}, jax_sessions, aqe=aqe)
    assert plan.num_partitions == 4 and "TpuUnionExec" in plan.tree_string()
    _three(grouped, {"g": gdata}, jax_sessions, aqe=aqe)


def test_union_schema_mismatch_raises():
    sess = TorchSession(_CONF, device="cpu")
    a = sess.create_dataframe(pa.table({"x": [1]}))
    b = sess.create_dataframe(pa.table({"y": [1]}))
    with pytest.raises(TypeError):
        a.union(b)


# -- range and sample --------------------------------------------------------
@pytest.mark.parametrize("args", [(0, 1000, 3, 3), (5, None, 1, 1),
                                  (100, -7, -9, 2)])
def test_range(jax_sessions, args):
    start, end, step, parts = args

    def build(f, s, t):
        return s.range(start, end, step, num_partitions=parts)
    out, plan = _three(build, {}, jax_sessions, ignore_order=False)
    want = list(range(start, end, step)) if end is not None \
        else list(range(start))
    assert out.column("id").to_pylist() == want
    assert "TpuRangeExec" in plan.tree_string()


@pytest.mark.parametrize("seed", [7, -3, 2**40 + 1])
def test_sample_mask_bits_equal_jax(seed):
    """The position hash's decisions on both port paths equal the JAX
    package's, row for row, at partition ids and offsets past 2^32."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.device import DeviceTable as JDT
    from spark_rapids_tpu.columnar.host import HostTable as JHT
    from spark_rapids_tpu_torch.columnar.device import DeviceTable
    from spark_rapids_tpu_torch.columnar.host import HostTable
    n = 5000
    t = pa.table({"x": np.zeros(n)})
    for pid, offset in ((0, 0), (3, 12345), (1, 2**33 + 5)):
        for frac in (0.1, 0.5):
            want = np.asarray(JSampleMask(frac, seed).eval(
                JEvalContext.for_host(JHT.from_arrow(t), partition_id=pid,
                                      batch_row_offset=offset)).values)
            jdev = JDT.from_host(JHT.from_arrow(t), 64)
            jwant = np.asarray(JSampleMask(frac, seed).eval(
                JEvalContext.for_device(jdev, partition_id=pid,
                                        batch_row_offset=jnp.int64(offset)))
                .values)[:n]
            host = SampleMask(frac, seed).eval(EvalContext.for_host(
                HostTable.from_arrow(t), pid, offset)).values
            dev = DeviceTable.from_host(HostTable.from_arrow(t), 64,
                                        torch.device("cpu"))
            got = SampleMask(frac, seed).eval(EvalContext.for_device(
                dev, pid, torch.tensor(offset))).values[:n].numpy()
            assert np.array_equal(want, jwant)
            assert np.array_equal(host, want)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("aqe", [True, False])
def test_sample(jax_sessions, aqe):
    """The JAX package's rows bit for bit, after a filter too (positions
    count the rows the filter kept); a seed gives the same rows again."""
    rng = np.random.default_rng(1)
    t = pa.table({"k": np.arange(1500, dtype=np.int64),
                  "v": rng.standard_normal(1500)})
    out, plan = _three(lambda f, s, d: d["t"].sample(0.25, seed=11),
                       {"t": t}, jax_sessions, parts=3, aqe=aqe)
    assert "TpuSampleExec" in plan.tree_string()
    assert 0.18 < out.num_rows / 1500 < 0.32
    _three(lambda f, s, d: d["t"].filter(f.col("v") > f.lit(0.0))
           .sample(0.5, seed=3).group_by().agg(f.count_star().alias("n"),
                                               f.sum(f.col("k")).alias("s")),
           {"t": t}, jax_sessions, aqe=aqe)
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(t, num_partitions=3)
    again = df.sample(0.25, seed=11).collect()
    assert sorted(again.column("k").to_pylist()) \
        == sorted(out.column("k").to_pylist())
    assert df.sample(0.25, seed=12).collect().column("k").to_pylist() \
        != again.column("k").to_pylist()
    with pytest.raises(ValueError):
        df.sample(1.5, seed=1)
    assert df.sample(0.0, seed=1).count() == 0
    assert df.sample(1.0, seed=1).count() == 1500


def test_range_sample_count(jax_sessions):
    def build(f, s, t):
        return s.range(0, 20000, num_partitions=2).sample(0.1, seed=7) \
            .agg(f.count_star().alias("n"))
    out, plan = _three(build, {}, jax_sessions)
    text = plan.tree_string()
    assert "TpuRangeExec" in text and "TpuSampleExec" in text
    assert out.column("n")[0].as_py() == jax_sessions[True].range(
        0, 20000, num_partitions=2).sample(0.1, seed=7).count()


# -- count, cache, results on the device ------------------------------------
def test_counts(gdata, jax_sessions):
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(gdata, num_partitions=2)
    jdf = jax_sessions[True].create_dataframe(gdata, num_partitions=2)
    assert df.count() == jdf.count() == 300
    assert df.union(df).count() == jdf.union(jdf).count() == 600
    assert df.filter(F.col("a") > F.lit(1)).count() \
        == jdf.filter(JF.col("a") > JF.lit(1)).count()
    _three(lambda f, s, t: t["g"].group_by("a").count(), {"g": gdata},
           jax_sessions)


def _metric(plan, name) -> int:
    if isinstance(plan, AdaptiveExec):
        plan = plan.final_plan()
    total = 0
    stack = [plan]
    while stack:
        node = stack.pop()
        total += getattr(node, "metrics", {}).get(name, 0)
        stage = getattr(node, "stage", None)
        stack.extend([stage.inner] if stage is not None else node.children)
    return total


@pytest.mark.parametrize("aqe", [True, False])
def test_cache(gdata, jax_sessions, aqe):
    """A cached DataFrame read by two queries: the first fills the cache
    (plans equal the JAX package's), the second is served from it (cache
    hits, no upload), and its results equal the first run's and the host
    engine's; the host engine caches too."""
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe})

    def cached(f, s, t):
        return t["g"].filter(f.col("a") > f.lit(0)).cache()

    def first(f, s, t):
        return cached(f, s, t).group_by("a").agg(f.sum(f.col("v"))
                                                 .alias("s"))
    out, plan = _three(first, {"g": gdata}, jax_sessions, aqe=aqe)
    assert "TpuCacheExec" in plan.tree_string()
    sess = TorchSession(conf, device="cpu")
    c = cached(F, sess, {"g": sess.create_dataframe(gdata,
                                                    num_partitions=2)})
    qa = c.group_by("a").agg(F.sum(F.col("v")).alias("s"))
    qb = c.agg(F.count_star().alias("n"))
    p1 = sess._physical(qa.logical, True)
    r1 = p1.collect().to_arrow()
    assert _metric(p1, CACHE_HITS) == 0 and _metric(p1, UPLOAD_BYTES) > 0
    p2 = sess._physical(qb.logical, True)
    r2 = p2.collect().to_arrow()
    assert _metric(p2, CACHE_HITS) == 2 and _metric(p2, UPLOAD_BYTES) == 0
    assert_tables_equal(r1, out)
    assert r2.column("n")[0].as_py() == sum(
        1 for a in gdata.column("a").to_pylist() if a is not None and a > 0)
    p3 = sess._physical(qa.logical, True)
    assert_tables_equal(p3.collect().to_arrow(), r1)
    assert _metric(p3, CACHE_HITS) == 2
    assert_tables_equal(qa.collect(device=False), r1)
    assert_tables_equal(qa.collect(device=False), r1)


def test_cache_under_a_limit_leaves_no_catalog_entry():
    """A cached scan abandoned under a limit registers nothing."""
    from spark_rapids_tpu_torch.memory.catalog import get_catalog
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(pa.table({"a": list(range(100))})).cache()
    before = get_catalog().stats()["buffers"]
    df.limit(5).collect(device=True)
    assert get_catalog().stats()["buffers"] - before <= 1


def test_results_left_on_the_device(gdata, jax_sessions):
    """``to_device_batches`` and ``num_partitions`` over the device plan;
    ``to_torch`` equals the JAX package's ``to_jax``: values sliced to the
    row count, validity masks with ``allow_nulls``, decimals unscaled,
    strings as (matrix, lengths); a null without ``allow_nulls`` raises."""
    from decimal import Decimal
    t = gdata.append_column("d", pa.array(
        [Decimal(i).scaleb(-2) for i in range(300)], pa.decimal128(10, 2)))
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(t, num_partitions=2)
    jdf = jax_sessions[False].create_dataframe(t, num_partitions=2)
    assert df.num_partitions() == jdf.num_partitions() == 2
    for p in range(2):
        rows = sum(int(b.num_rows) for b in df.to_device_batches(p))
        jrows = sum(int(b.num_rows) for b in jdf.to_device_batches(p))
        assert rows == jrows
    q = df.filter(F.col("a") > F.lit(1))
    jq = jdf.filter(JF.col("a") > JF.lit(1))
    with pytest.raises(ValueError):
        q.to_torch()
    got = q.to_torch(allow_nulls=True)
    want = jq.to_jax(allow_nulls=True)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tuple):
            assert np.array_equal(g[1].numpy(), np.asarray(w[1]))
            width = min(g[0].shape[1], np.asarray(w[0]).shape[1])
            assert np.array_equal(g[0][:, :width].numpy(),
                                  np.asarray(w[0])[:, :width])
        else:
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    only = q.select(F.col("b")).to_torch(columns=["b"], allow_nulls=True)
    assert set(only) <= {"b", "b__validity"}
