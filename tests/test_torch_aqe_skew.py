"""AQE's skew split and partition coalescing (plan/aqe.py ``_apply_skew``,
``_apply_coalescing`` and the stage readers) against the JAX package, on
the host tier (``shuffle.mode=host``, tests/test_aqe.py's cases) and on the
mesh tier (an 8-shard ``virtual_mesh`` against JAX's 8 CPU devices).

Tolerances: AQE events and final plans (``tree_string``) exactly; rows
exactly, doubles at rel 1e-9 (tests/harness.py)."""
import numpy as np
import pandas as pd
import pytest

from harness import assert_tables_equal
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.parallel.mesh import virtual_cpu_mesh
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession

_NO_BCAST = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
             "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold": -1}
_SKEW = {**_NO_BCAST,
         "spark.rapids.tpu.aqe.coalescePartitions.enabled": False,
         "spark.rapids.tpu.aqe.skewJoin.skewedPartitionThresholdBytes": 2048,
         "spark.rapids.tpu.aqe.skewJoin.skewedPartitionFactor": 2,
         "spark.rapids.tpu.aqe.advisoryPartitionSizeBytes": 2048}


def _sessions(mesh: bool, **extra):
    conf = {"spark.rapids.tpu.shuffle.partitions": 6,
            "spark.rapids.tpu.shuffle.mode": "auto" if mesh else "host",
            **extra}
    port = TorchSession(conf, device="cpu")
    jsess = TpuSession(conf)
    if mesh:
        port.attach_mesh(virtual_mesh(8))
        jsess.attach_mesh(virtual_cpu_mesh(8))
    return port, jsess


def _groupby(sess, fns, seed=11):
    rng = np.random.default_rng(seed)
    df = sess.create_dataframe(pd.DataFrame({
        "g": rng.integers(0, 50, 3000).astype(np.int64),
        "x": rng.normal(size=3000)}), num_partitions=4)
    return df.group_by("g").agg(fns.sum(fns.col("x")).alias("sx"))


def _join(sess, fns, n_left=3000, n_right=500):
    rng = np.random.default_rng(7)
    left = pd.DataFrame({"k": rng.integers(0, n_right, n_left)
                         .astype(np.int64), "v": rng.normal(size=n_left)})
    right = pd.DataFrame({"k": np.arange(n_right, dtype=np.int64),
                          "name": [f"name_{i}" for i in range(n_right)]})
    return sess.create_dataframe(left, num_partitions=3).join(
        sess.create_dataframe(right, num_partitions=2), on="k") \
        .select("k", "v", "name")


def _skewed(sess, fns, how):
    rng = np.random.default_rng(5 if how == "inner" else 9)
    hot = 8000 if how == "inner" else 6000
    k = np.concatenate([np.zeros(hot, dtype=np.int64),
                        rng.integers(1, 40, 500).astype(np.int64)])
    left = pd.DataFrame({"k": k, "v": rng.normal(size=len(k))})
    rk = np.arange(40, dtype=np.int64) if how == "inner" \
        else np.arange(0, 60, 2, dtype=np.int64)
    right = pd.DataFrame({"k": rk, "w": rng.normal(size=len(rk))})
    return sess.create_dataframe(left, num_partitions=3).join(
        sess.create_dataframe(right, num_partitions=2), on="k", how=how) \
        .select("k", "v", "w")


_CASES = {
    "groupby_coalesces": (_groupby, {}, "coalesced stage"),
    "min_partition_num": (
        _groupby, {"spark.rapids.tpu.aqe.coalescePartitions.minPartitionNum":
                   3}, "coalesced stage"),
    "join_coalesces_both_sides": (_join, _NO_BCAST, "coalesced join inputs"),
    "skew_inner": (lambda s, f: _skewed(s, f, "inner"), _SKEW, "skew split"),
    "skew_left_outer": (lambda s, f: _skewed(s, f, "left"), _SKEW,
                        "skew split"),
}


@pytest.mark.parametrize("mesh", [False, True], ids=["host", "mesh"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_aqe_rewrites_equal_jax(case, mesh):
    build, extra, event = _CASES[case]
    port, jsess = _sessions(mesh, **extra)
    q, jq = build(port, F), build(jsess, JF)
    plan = port._physical(q.logical, True)
    jplan = jsess._physical(jq.logical, True)
    assert isinstance(plan, AdaptiveExec)
    got = plan.collect().to_arrow()
    want = jplan.collect().to_arrow()
    assert plan.events == jplan.events
    assert any(e.startswith(event) for e in plan.events), plan.events
    assert plan.final_plan().tree_string() == jplan.final_plan() \
        .tree_string()
    assert_tables_equal(got, want)
    assert_tables_equal(got, q.collect(device=False))
    if case == "min_partition_num":
        assert plan.final_plan().num_partitions >= 3
    if case == "groupby_coalesces":
        assert plan.final_plan().num_partitions == 1


def test_no_rewrite_is_noted_as_not_ported():
    """The "not ported yet" branch is gone: a stage of many partitions is
    coalesced, and no event says otherwise."""
    port, _ = _sessions(False)
    plan = port._physical(_groupby(port, F).logical, True)
    plan.collect()
    assert not any("not ported" in e for e in plan.events), plan.events
