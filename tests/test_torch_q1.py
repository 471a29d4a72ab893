"""TPC-H Q1 and other grouped, sorted queries through the PyTorch port (on
the CPU), the JAX package (AQE off, and on as by default) and the port's
host engine: the same data gives the same rows in the same order. Keys,
row order and counts must be equal; doubles agree at rel 1e-9, which covers
the order of the float64 sums."""
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.tools import tpch as jtpch
from spark_rapids_tpu.utils.compile_cache import clear_cache

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal, data_gen


def _conf(min_bucket: int):
    return {"spark.rapids.tpu.batchRowsMinBucket": min_bucket}


def _four_ways(query, jquery, table: pa.Table, parts: int, min_bucket: int):
    """-> (port on the device path, port host engine, JAX package with AQE
    off, JAX package with AQE on)."""
    sess = TorchSession(_conf(min_bucket), device="cpu")
    q = query(sess.create_dataframe(table, num_partitions=parts))
    outs = [q.collect(), q.collect(device=False)]
    for aqe in (False, True):
        jsess = TpuSession({**_conf(min_bucket),
                            "spark.rapids.tpu.aqe.enabled": aqe})
        jq = jquery(jsess.create_dataframe(table, num_partitions=parts))
        outs.append(jq.collect(device=True))
    return outs


def _assert_same_rows_in_order(port: pa.Table, others) -> None:
    for other in others:
        assert port.schema == other.schema
        assert_tables_equal(port, other, ignore_order=False)


def _q1(df):
    return tpch.q1({"lineitem": df})


def _jq1(df):
    return jtpch.q1({"lineitem": df})


@pytest.mark.parametrize("rows", [1, 1000, 70000])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("min_bucket", [8, 1024])
def test_q1_matches_jax_package_and_host_engine(rows, parts, min_bucket):
    li = tpch.gen_lineitem(0, seed=0, rows=rows)
    port, *others = _four_ways(_q1, _jq1, li, parts, min_bucket)
    _assert_same_rows_in_order(port, others)
    if rows >= 1000:
        assert port.column("l_returnflag").to_pylist() == \
            ["A", "A", "N", "N", "R", "R"]
        assert port.column("l_linestatus").to_pylist() == ["F", "O"] * 3
        assert sum(port.column("count_order").to_pylist()) <= rows


@pytest.mark.parametrize("parts", [1, 3])
def test_q1_with_no_qualifying_rows_is_empty(parts):
    li = tpch.gen_lineitem(0, seed=1, rows=500)
    late = pa.array(np.full(li.num_rows, 10500, np.int32)).cast(pa.date32())
    li = li.set_column(li.schema.get_field_index("l_shipdate"), "l_shipdate",
                       late)
    port, *others = _four_ways(_q1, _jq1, li, parts, 8)
    assert port.num_rows == 0
    assert port.column_names[:2] == ["l_returnflag", "l_linestatus"]
    _assert_same_rows_in_order(port, others)


def _grouped_table(seed: int, n: int) -> pa.Table:
    """data_gen columns with null keys, a string key of mixed lengths
    (longer than 8 bytes, multi-byte UTF-8, empty), a small int key and a
    double key holding NaN, -0.0, 0.0 and +-inf (rounded so values repeat)."""
    rng = np.random.default_rng(seed)
    t = data_gen(rng, n, {"s": "string", "i": ("int32", 0, 4),
                          "k": "float64", "v": "float64", "w": "int64"})
    k = pc.round(pc.divide(t.column("k"), 150.0))
    return t.set_column(t.schema.get_field_index("k"), "k", k)


def _grouped_query(fns, df, nulls_first: bool):
    col = fns.col
    return (df.filter(col("w") > fns.lit(-2**61))
            .group_by("s", "k", "i")
            .agg(fns.sum(col("v")).alias("s_v"),
                 fns.count(col("v")).alias("n_v"),
                 fns.count_star().alias("n"),
                 fns.min(col("v")).alias("min_v"),
                 fns.max(col("v")).alias("max_v"),
                 fns.min(col("w")).alias("min_w"),
                 fns.avg(col("w")).alias("avg_w"))
            .sort(fns.SortOrder(col("s").expr, False, nulls_first),
                  col("k").asc(),
                  fns.SortOrder(col("i").expr, False, not nulls_first)))


def _without_jax_extreme_defect(port: pa.Table, jax_out: pa.Table
                                ) -> pa.Table:
    """``jax_out`` with the one known defect of the JAX package's device
    engine undone: where a group's min (max) contributions are all +inf
    (-inf) beside a null or filtered-out row, it gives +-1.8e308, and the
    port, Spark and both host engines give the infinity. Only cells where
    the port holds that infinity and the JAX package that finite extreme
    are replaced."""
    big = np.finfo(np.float64).max
    for name, edge, inf in (("min_v", big, np.inf), ("max_v", -big, -np.inf)):
        p = port.column(name).to_numpy(zero_copy_only=False)
        j = jax_out.column(name)
        fixed = pc.if_else(pa.array((j.to_numpy(zero_copy_only=False) == edge)
                                    & (p == inf)), inf, j)
        jax_out = jax_out.set_column(jax_out.schema.get_field_index(name),
                                     name, fixed)
    return jax_out


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("seed,parts", [(0, 1), (1, 3), (2, 2)])
def test_grouped_sorted_query_matches_jax_package(seed, parts, nulls_first):
    # the JAX package keys its compiled sort by a description that leaves
    # out the null order, so a sort compiled for the other null order would
    # be reused: start from an empty cache
    clear_cache()
    table = _grouped_table(seed, 1500)
    port, host, *jax_outs = _four_ways(
        lambda df: _grouped_query(F, df, nulls_first),
        lambda df: _grouped_query(JF, df, nulls_first), table, parts, 8)
    _assert_same_rows_in_order(port, [host])
    _assert_same_rows_in_order(
        port, [_without_jax_extreme_defect(port, j) for j in jax_outs])
    keys = port.column("s").to_pylist()
    assert None in keys and "longer string value" in keys \
        and "ünïcode" in keys
    assert (keys[0] is None) == nulls_first
    k = port.column("k").to_numpy(zero_copy_only=False)
    assert np.isnan(k).any() and (k == 0).any()


def _chain(plan):
    """(node name, description) from the root down the first children."""
    out = []
    while plan is not None:
        out.append((plan.node_name(), plan.node_desc()))
        plan = plan.children[0] if plan.children else None
    return out


def test_q1_device_plan_equals_jax_package_plan():
    li = tpch.gen_lineitem(0, seed=0, rows=5000)
    sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                         "spark.rapids.tpu.aqe.enabled": False},
                        device="cpu")
    q = _q1(sess.create_dataframe(li, num_partitions=2))
    jsess = TpuSession({"spark.rapids.tpu.aqe.enabled": False})
    jq = _jq1(jsess.create_dataframe(li, num_partitions=2))
    port = sess._physical(q.logical, True)
    assert _chain(port) == _chain(jsess._physical(jq.logical, True))
    assert [n for n, _ in _chain(port)] == [
        "DeviceToHostExec", "TpuSortExec", "TpuLocalExchangeExec",
        "TpuProjectExec", "TpuHashAggregateExec", "TpuLocalExchangeExec",
        "TpuWholeStage[Filter+Project+HashAggregate]", "HostToDeviceExec",
        "CpuScanExec"]
    host = _chain(sess._physical(q.logical, False))
    assert [n for n, _ in host] == [
        "CpuSortExec", "ShuffleExchangeExec", "CpuProjectExec",
        "CpuHashAggregateExec", "ShuffleExchangeExec",
        "CpuHashAggregateExec", "CpuProjectExec", "CpuFilterExec",
        "CpuScanExec"]
    assert host[1][1] == "RangePartitioning(8)"
    assert host[4][1] == "HashPartitioning(8)"


_EDGE_INTS = [-2**63, -2**63 + 1, -1, 0, 1, 2**62 + 3, 2**63 - 1]


def _edge_table() -> pa.Table:
    """Every (nullable bool, nullable int64 with the type's extremes) pair,
    in a shuffled order."""
    pairs = [(b, i) for b in (None, False, True) for i in _EDGE_INTS + [None]]
    order = np.random.default_rng(3).permutation(len(pairs))
    return pa.table({"b": pa.array([pairs[k][0] for k in order], pa.bool_()),
                     "i": pa.array([pairs[k][1] for k in order], pa.int64())})


def _spark_key(value, ascending: bool, nulls_first: bool):
    """Python sort key of one value under one Spark sort order: nulls
    first or last, false < true, Python ints (no overflow)."""
    if value is None:
        return (0 if nulls_first else 2, 0)
    v = int(value)
    return (1, v if ascending else -v)


@pytest.mark.parametrize("orders", [
    [("b", True, True)], [("b", False, False)], [("b", True, False)],
    [("b", False, True)], [("i", True, True)], [("i", False, False)],
    [("i", False, True)], [("i", True, False)],
    [("b", False, False), ("i", False, True)],
    [("i", True, False), ("b", True, True)]])
def test_sort_of_bool_and_int64_extremes_follows_spark(orders):
    """The device sort and the host engine order a nullable bool key false
    before true and an int64 key by value at the type's extremes, in both
    directions, with nulls first or last."""
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(_edge_table(), num_partitions=2)
    q = df.sort(*[F.SortOrder(F.col(c).expr, asc, nf)
                  for c, asc, nf in orders])
    rows = _edge_table().to_pylist()
    want = sorted(rows, key=lambda r: [_spark_key(r[c], asc, nf)
                                       for c, asc, nf in orders])
    names = [c for c, _, _ in orders]
    for out in (q.collect(), q.collect(device=False)):
        got = [tuple(r[c] for c in names) for r in out.to_pylist()]
        assert got == [tuple(r[c] for c in names) for r in want]


def test_host_engine_follows_the_shuffle_partitions_conf():
    li = tpch.gen_lineitem(0, seed=2, rows=2000)
    outs = []
    for parts in (3, 8):
        sess = TorchSession({"spark.rapids.tpu.shuffle.partitions": parts},
                            device="cpu")
        q = _q1(sess.create_dataframe(li, num_partitions=2))
        host = _chain(sess._physical(q.logical, False))
        assert host[1][1] == f"RangePartitioning({parts})"
        assert host[4][1] == f"HashPartitioning({parts})"
        outs.append(q.collect(device=False))
    _assert_same_rows_in_order(outs[0], [outs[1], _q1(TorchSession(
        device="cpu").create_dataframe(li, num_partitions=2)).collect()])


def test_q1_partial_aggregate_counts_rows_once(monkeypatch):
    """Q1's partial aggregate adds each batch of 500 rows into the groups
    once per sum (7 float64 segmented sums over one sort of the group ids)
    and counts them once (1 int64 pass): the count of a null-free projected
    input, which count(*) and each avg share."""
    import torch
    calls = []
    index_add = torch.Tensor.index_add_
    segment_reduce = torch.segment_reduce

    def counting(self, dim, index, source, **kw):
        calls.append((source.dtype, source.shape[0]))
        return index_add(self, dim, index, source, **kw)

    def counting_segments(data, reduce, **kw):
        calls.append((data.dtype, data.shape[0]))
        return segment_reduce(data, reduce, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", counting)
    monkeypatch.setattr(torch, "segment_reduce", counting_segments)
    sess = TorchSession(_conf(8), device="cpu")
    li = tpch.gen_lineitem(0, seed=0, rows=1000)
    _q1(sess.create_dataframe(li, num_partitions=2)).collect()
    partial = [d for d, n in calls if n == 512]   # the batches' capacity
    assert partial.count(torch.int64) == 2
    assert partial.count(torch.float64) == 14


def test_sort_over_the_batch_budget_takes_the_out_of_core_sort(monkeypatch):
    """A sort whose input batches pass ``batchSizeBytes`` together runs the
    out-of-core sort (sorted runs in the spill catalog, merged in rounds):
    its rows equal the JAX package's in order (the same merge), and the
    host engine's as a multiset, in the keys' order."""
    from spark_rapids_tpu_torch.exec.sort import TpuSortExec
    li = tpch.gen_lineitem(0, seed=0, rows=3000)
    conf = {**_conf(8), "spark.rapids.sql.batchSizeBytes": 1}
    sess = TorchSession(conf, device="cpu")
    calls = []
    real = TpuSortExec._merge_runs

    def spy(self, runs):
        calls.append(len(runs))
        yield from real(self, runs)
    monkeypatch.setattr(TpuSortExec, "_merge_runs", spy)
    q = sess.create_dataframe(li, num_partitions=3).sort("l_orderkey")
    got = q.collect()
    assert calls == [3]
    jsess = TpuSession({**conf, "spark.rapids.tpu.aqe.enabled": False})
    want = jsess.create_dataframe(li, num_partitions=3).sort(
        "l_orderkey").collect(device=True)
    assert_tables_equal(got, want, ignore_order=False)
    keys = got.column("l_orderkey").to_numpy()
    assert (np.diff(keys) >= 0).all() and len(keys) == 3000
    assert_tables_equal(got, q.collect(device=False))


def test_join_still_raises_naming_roadmap():
    """Joins without equi-keys (the nested-loop join) were still to port;
    since the nested-loop and cross joins step the cross join runs on the
    device's nested-loop join, equal to the host engine's."""
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tpch.gen_lineitem(0, seed=0, rows=10))
    q = df.join(df.select(F.col("l_tax").alias("t")), how="cross")
    got = q.collect()
    assert got.num_rows == 100
    assert "TpuBroadcastNestedLoopJoinExec" in sess._physical(
        q.logical).tree_string()
    assert_tables_equal(got, q.collect(device=False))


def test_string_max_is_tagged_and_runs_on_the_host_engine():
    """An aggregate the device cannot run (max of a string) is tagged with
    its reason and runs on the host engine, between device nodes that carry
    the string key down and up again; nothing falls back silently."""
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tpch.gen_lineitem(0, seed=0, rows=3000),
                               num_partitions=2)
    q = (df.filter(F.col("l_quantity") > F.lit(10.0))
         .group_by("l_linestatus")
         .agg(F.max(F.col("l_shipmode")).alias("m"),
              F.count_star().alias("n"))
         .sort("l_linestatus"))
    report = q.explain("device")
    assert "! CpuHashAggregateExec cannot run on the device because " \
        "aggregate input _agg0_in0: string is not ported" in report
    # AQE lowers each stage as it runs: the plan is whole after the run
    plan = q.session._physical(q.logical, True)
    plan.collect()
    text = plan.tree_string()
    assert "TpuWholeStage[Filter+Project]" in text and "TpuSortExec" in text
    _assert_same_rows_in_order(q.collect(), [q.collect(device=False)])
    strict = TorchSession({"spark.rapids.sql.test.enabled": True},
                          device="cpu")
    with pytest.raises(AssertionError, match="fell off the device"):
        strict._physical(q.logical, True).collect()
