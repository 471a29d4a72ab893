"""All 22 TPC-H queries through the PyTorch port on the CPU, its host engine
and the JAX package, at ``gen_all(0, tiny=True)`` in 2 partitions, with the
rules of tests/test_tpch_full.py: ordered compare for its ``_ORDERED``
queries, row counts and sorted float columns for its ``_LIMITED`` ones, a
multiset otherwise (floats at rel 1e-9). The port's device plan after the
run equals the JAX package's node for node, scalar-subquery literals
included, and so do its AQE events.

This file: the generators, Q1–Q11 with AQE on (the default), scalar
subqueries' edge cases and ``distinct``. Q12–Q22 with AQE on are in
tests/test_torch_tpch22_q12_q22.py, every query with AQE off in
tests/test_torch_tpch22_aqe_off.py."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.exec import aggregate as agg
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal

# tests/test_tpch_full.py's sets
ORDERED = {"q1", "q4", "q5", "q7", "q8", "q9", "q12", "q13", "q15", "q16",
           "q20", "q22"}
LIMITED = {"q2", "q3", "q10", "q18", "q21"}
HEAVY = {"q2", "q3", "q5", "q7", "q9", "q10", "q16", "q18", "q21"}
CONF = {"spark.rapids.tpu.batchRowsMinBucket": 64,
        "spark.rapids.sql.test.enabled": True}


def compare(name: str, got: pa.Table, want: pa.Table) -> None:
    """tests/test_tpch_full.py's comparison of one query's results."""
    if name not in LIMITED:
        assert_tables_equal(got, want, ignore_order=name not in ORDERED,
                            rel_tol=1e-9)
        return
    assert got.num_rows == want.num_rows
    assert got.column_names == want.column_names
    for c in got.column_names:
        if pa.types.is_floating(got.schema.field(c).type):
            np.testing.assert_allclose(
                np.sort(got.column(c).to_numpy(zero_copy_only=False)),
                np.sort(want.column(c).to_numpy(zero_copy_only=False)),
                rtol=1e-9)


def run_port(name: str, tables, conf: dict):
    """-> (port device result, the plan that ran, host engine result)."""
    sess = TorchSession(conf, device="cpu")
    q = tpch.QUERIES[name](tpch.build_dataframes(sess, tables, 2))
    plan = sess._physical(q.logical, True)
    out = plan.collect().to_arrow()
    return out, plan, q.collect(device=False)


def run_against_jax(name: str, tables, conf: dict) -> None:
    """The query through the port's device path, its host engine and the
    JAX package: equal results, equal plans, equal AQE events."""
    out, plan, host = run_port(name, tables, conf)
    jsess = TpuSession(conf)
    jq = jtpch.QUERIES[name](jtpch.build_dataframes(jsess, tables, 2))
    jplan = jsess._physical(jq.logical, True)
    jout = jplan.collect().to_arrow()
    assert out.schema == host.schema == jout.schema
    compare(name, out, host)
    compare(name, out, jout)
    text = plan.tree_string()
    assert text == jplan.tree_string()
    assert "Cpu" not in text.replace("CpuScanExec", "")
    if conf.get("spark.rapids.tpu.aqe.enabled", True):
        assert isinstance(plan, AdaptiveExec)
        assert plan.events == jplan.events
    else:
        assert "AdaptiveExec" not in text


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_all(0, tiny=True)


def test_generators_equal_the_jax_package_byte_for_byte(tables):
    jt = jtpch.gen_all(0, tiny=True)
    assert list(tables) == list(jt)
    for name in jt:
        assert tables[name].equals(jt[name]), name
    for sf, seed in ((0.01, 3), (0.02, 7)):
        assert tpch.gen_part(sf, seed=seed).equals(
            jtpch.gen_part(sf, seed=seed))
        assert tpch.gen_partsupp(sf, seed=seed + 2).equals(
            jtpch.gen_partsupp(sf, seed=seed + 2))
    assert sorted(tpch.QUERIES, key=lambda q: int(q[1:])) \
        == [f"q{i}" for i in range(1, 23)]


@pytest.mark.parametrize("name", [f"q{i}" for i in range(1, 12)])
def test_query_with_aqe_matches_jax_package_and_host_engine(tables, name):
    run_against_jax(name, tables, CONF)


# -- scalar subqueries ----------------------------------------------------------
def _frame(sess):
    return sess.create_dataframe(pa.table({
        "k": pa.array([1, 2, 3, 4, None], pa.int64()),
        "v": pa.array([1.5, None, 2.5, 4.0, 8.0]),
        "s": pa.array(["a", "b", None, "dd", "e"])}), num_partitions=2)


@pytest.mark.parametrize("device", [True, False])
def test_scalar_subquery_values_and_edge_cases(device):
    col, lit = F.col, F.lit
    sess = TorchSession(CONF, device="cpu")
    df = _frame(sess)
    mx = F.scalar_subquery(df.agg(F.max(col("v")).alias("m")))
    got = df.filter(col("v") * lit(2.0) >= mx).collect(device)
    assert sorted(got.column("k").to_pylist(), key=str) == [4, None]
    # no row -> a null literal: every comparison with it is null
    empty = F.scalar_subquery(df.filter(col("k") > lit(100))
                              .select(col("v")))
    assert df.filter(col("v") > empty).collect(device).num_rows == 0
    assert df.select(F.coalesce(empty, lit(-1.0)).alias("x")) \
        .collect(device).column("x").to_pylist() == [-1.0] * 5
    # a null value -> a null literal
    nul = F.scalar_subquery(df.filter(col("k").is_null()).select(col("k")))
    assert df.select(F.coalesce(nul, lit(-7)).alias("x")) \
        .collect(device).column("x").to_pylist() == [-7] * 5
    # a string and an int subquery keep their type
    first = F.scalar_subquery(df.filter(col("k") == lit(4)).select(col("s")))
    assert df.filter(col("s") == first).collect(device) \
        .column("k").to_pylist() == [4]
    cnt = F.scalar_subquery(df.agg(F.count_star().alias("c")))
    assert df.filter(col("k") == cnt).collect(device) \
        .column("k").to_pylist() == []
    assert df.filter(col("k") + lit(1) == cnt).collect(device) \
        .column("k").to_pylist() == [4]
    # two rows raise
    two = F.scalar_subquery(df.filter(col("k") <= lit(2)).select(col("v")))
    with pytest.raises(ValueError, match="2 rows"):
        df.filter(col("v") > two).collect(device)
    with pytest.raises(ValueError, match="exactly one column"):
        F.scalar_subquery(df)


def test_scalar_subquery_runs_before_the_plan_as_a_literal():
    col, lit = F.col, F.lit
    sess = TorchSession(CONF, device="cpu")
    df = _frame(sess)
    mx = F.scalar_subquery(df.agg(F.max(col("v")).alias("m")))
    plan = sess._physical(df.filter(col("v") >= mx * lit(0.5)).logical,
                          True)
    text = plan.tree_string()
    assert "scalar_subquery" not in text and "lit(8.0)" in text
    assert plan.collect().to_arrow().column("v").to_pylist() == [4.0, 8.0]


# -- distinct -------------------------------------------------------------------
@pytest.mark.parametrize("parts", [1, 3])
def test_distinct_with_null_and_string_keys(parts):
    rng = np.random.default_rng(parts)
    n = 500
    words = np.array(["", "a", "ab", "ünï", "zz"], dtype=object)
    table = pa.table({
        "k": pa.array(rng.integers(0, 4, n), pa.int64(),
                      mask=rng.random(n) < 0.2),
        "s": pa.array(words[rng.integers(0, 5, n)],
                      mask=rng.random(n) < 0.2),
        "d": pa.array(rng.choice([0.0, -0.0, 1.5, np.nan], n))})
    sess = TorchSession(CONF, device="cpu")
    df = sess.create_dataframe(table, num_partitions=parts).distinct()
    dev, host = df.collect(), df.collect(device=False)
    jsess = TpuSession(CONF)
    jout = jsess.create_dataframe(table, num_partitions=parts).distinct() \
        .collect(device=True)
    assert_tables_equal(dev, host)
    assert_tables_equal(dev, jout)
    want = {(k, s, "nan" if d != d else d + 0.0) for k, s, d in zip(
        *(table.column(c).to_pylist() for c in ("k", "s", "d")))}
    assert dev.num_rows == len(want)


def test_sorted_group_sum_equals_index_add_on_the_cpu():
    """The card's run-to-run exact float group sum, run on the CPU, adds
    each group's values in row order, as ``index_add_`` does there."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1e6, 1e6, 5000))
    gid = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32))
    want = torch.zeros(400, dtype=torch.float64).index_add_(0, gid.long(),
                                                            x)
    assert torch.equal(agg._seg_sum_sorted(x, gid, 400), want)
