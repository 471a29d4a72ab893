"""``first``, ``last`` and the variance family of the port
(``expr/aggregates.py``, ``exec/aggregate.py``, ``plan/host_groupby.py``)
under every ``spark.rapids.tpu.groupby.strategy``, against the JAX package.

Tolerances. first, last, counts and keys exactly. The moments: the port's
device path against its host engine at rel 1e-12 (the same two-pass
formula, sums in another order); against the JAX package at rel 1e-9 on
well-conditioned data, as the JAX package keeps (sum, sum of squares,
count) where the port keeps (count, mean, M2) and merges them by Chan's
formula. On a group of equal large values the JAX package's formula
cancels to a negative variance and a NaN deviation, and the port gives 0
(pinned)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from harness import assert_tables_equal
from spark_rapids_tpu_torch.columnar.device import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec.aggregate import (_hash_group_ids,
                                                   _sorted_group_ids)
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_STRATEGY = "spark.rapids.tpu.groupby.strategy"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread: the tests run in several worker
    processes at once, and a thread pool each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(n: int = 300) -> pa.Table:
    rng = np.random.default_rng(4)
    return pa.table({
        "k": pa.array(rng.integers(0, 7, n), mask=rng.random(n) < 0.05),
        "s": pa.array(rng.choice(["a", "bb", "", "ccc"], n)),
        "v": pa.array(rng.normal(5.0, 2.0, n), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "c": pa.array(np.arange(n) % 7 * 10),
    })


def _aggs(M):
    c = M.col
    return [M.first(c("i")).alias("fi"), M.last(c("v")).alias("lv"),
            M.first(c("c")).alias("fc"),
            M.stddev(c("v")).alias("sd"), M.stddev_samp(c("i")).alias("ss"),
            M.stddev_pop(c("v")).alias("sp"), M.variance(c("v")).alias("va"),
            M.var_samp(c("i")).alias("vs"), M.var_pop(c("v")).alias("vp"),
            M.count(c("v")).alias("n")]


@pytest.fixture(scope="module")
def jax_results():
    table = _table()
    jdf = TpuSession({}).create_dataframe(table, num_partitions=2)
    q = jdf.group_by("k", "s").agg(*_aggs(JF))
    g = jdf.agg(*_aggs(JF))
    return table, q.collect(device=False), g.collect(device=False)


@pytest.mark.parametrize("strategy", ["sort", "hash", "auto"])
def test_grouped_and_grand_stats(jax_results, strategy):
    table, jq, jg = jax_results
    sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                         _STRATEGY: strategy}, device="cpu")
    df = sess.create_dataframe(table, num_partitions=2)
    for q, want in ((df.group_by("k", "s").agg(*_aggs(F)), jq),
                    (df.agg(*_aggs(F)), jg)):
        dev = q.collect()
        assert_tables_equal(dev, q.collect(device=False), rel_tol=1e-12)
        assert_tables_equal(dev, want, rel_tol=1e-9)
    plain = TorchSession({"spark.rapids.tpu.aqe.enabled": False,
                          _STRATEGY: strategy}, device="cpu")
    plan = plain._physical(plain.create_dataframe(table).group_by("k").agg(
        *_aggs(F)).logical, True).tree_string()
    assert ("strategy=sort" in plan) == (strategy == "sort"), plan


def test_strategies_give_equal_rows_and_groups():
    """The sort grouping orders groups by key, the hash one by first
    appearance: the same groups, the same members."""
    rng = np.random.default_rng(1)
    n = 500
    keys = rng.integers(-3, 3, n)
    f = rng.choice([0.0, -0.0, np.nan, 1.5, -2.0], n)
    valid = torch.from_numpy(rng.random(n) > 0.1)
    mat = torch.from_numpy(rng.choice([97, 98], (n, 8)).astype(np.uint8))
    lens = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    table = DeviceTable(
        (DeviceColumn(torch.from_numpy(keys), valid, dt.LONG),
         DeviceColumn(torch.from_numpy(f), torch.ones(n, dtype=torch.bool),
                      dt.DOUBLE),
         DeviceColumn(mat, torch.ones(n, dtype=torch.bool), dt.STRING,
                      lengths=lens)),
        torch.from_numpy(rng.random(n) > 0.05),
        torch.tensor(n, dtype=torch.int32), ("a", "b", "c"))
    gs, _, ns = _sorted_group_ids(table, ["a", "b", "c"])
    gh, _, nh = _hash_group_ids(table, ["a", "b", "c"])
    assert int(ns) == int(nh)
    active = table.row_mask
    pairs = set(zip(gs[active].tolist(), gh[active].tolist()))
    assert len(pairs) == int(ns)     # a one-to-one map between the ids


def test_variance_of_equal_values_is_zero_where_jax_cancels():
    table = pa.table({"k": [1] * 1000 + [2] * 3,
                      "v": [123456.789] * 1000 + [1.0, 2.0, 4.0]})

    def q(M, sess):
        return sess.create_dataframe(table, num_partitions=2).group_by(
            "k").agg(M.var_samp(M.col("v")).alias("vs"),
                     M.stddev_samp(M.col("v")).alias("ss"))
    for strategy in ("sort", "hash"):
        sess = TorchSession({_STRATEGY: strategy}, device="cpu")
        for device in (True, False):
            rows = sorted(q(F, sess).collect(device=device).to_pylist(),
                          key=lambda r: r["k"])
            assert rows[0]["vs"] == 0.0 and rows[0]["ss"] == 0.0
            assert rows[1]["vs"] == pytest.approx(7 / 3, rel=1e-12)
    jrows = sorted(q(JF, TpuSession({})).collect().to_pylist(),
                   key=lambda r: r["k"])
    # the JAX package: (sumsq - sum^2 / n) / (n - 1) far from 0 (its sign
    # depends on how the rows split; in one partition it is negative and
    # the deviation NaN)
    assert jrows[0]["vs"] == pytest.approx(1.779122872872873e-04, rel=1e-9)
    one = TpuSession({}).create_dataframe(table, num_partitions=1).group_by(
        "k").agg(JF.var_samp(JF.col("v")).alias("vs"),
                 JF.stddev_samp(JF.col("v")).alias("ss")).collect()
    row = [r for r in one.to_pylist() if r["k"] == 1][0]
    assert row["vs"] < 0 and row["ss"] != row["ss"]


def test_empty_input_and_the_conf():
    table = _table().slice(0, 0)
    sess = TorchSession({"spark.rapids.sql.test.enabled": True},
                        device="cpu")
    df = sess.create_dataframe(table)
    assert df.group_by("k").agg(*_aggs(F)).collect().num_rows == 0
    grand = df.agg(*_aggs(F))
    out = grand.collect()
    assert out.equals(grand.collect(device=False))
    assert out.to_pylist()[0]["n"] == 0 and out.to_pylist()[0]["sd"] is None
    assert RapidsConf({_STRATEGY: "SORT"}).get(_STRATEGY).lower() == "sort"
    with pytest.raises(Exception):
        RapidsConf({_STRATEGY: "bogus"})


def test_approx_percentile_on_the_host_engine_equals_jax():
    """The sketch state is an array, which only the host engine holds, in
    both packages; the percentiles equal the JAX package's exactly (the
    same t-digest on numpy)."""
    rng = np.random.default_rng(6)
    table = pa.table({"k": rng.integers(0, 3, 900),
                      "v": pa.array(rng.normal(size=900),
                                    mask=rng.random(900) < 0.1)})

    def q(M, sess):
        df = sess.create_dataframe(table, num_partitions=2)
        return df.group_by("k").agg(
            M.approx_percentile(M.col("v"), 0.5).alias("med"),
            M.approx_percentile(M.col("v"), [0.1, 0.9], 100).alias("q"))
    pq = q(F, TorchSession({}, device="cpu"))
    jq = q(JF, TpuSession({}))
    got = pq.collect()
    assert got.equals(pq.collect(device=False))
    assert_tables_equal(got, jq.collect(), rel_tol=0.0)
    assert "aggregate state" in pq.explain("device")
    assert "ARRAY" in pq.explain("device").upper()
