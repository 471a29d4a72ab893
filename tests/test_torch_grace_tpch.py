"""TPC-H Q3, Q5, Q21 and right and full outer joins through the port's
grace join on the CPU, under a small ``batchSizeBytes``, AQE off and on (a
broadcast build over the budget split once): rows equal to the host
engine's and the JAX package's, plans and AQE events included, and every
buffer the plan registered closed when the query ends; Q3's buckets
through every spill tier."""
import pytest

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory.stores import StorageTier
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal
from test_torch_grace import _GraceSpy

_ROWS = 6000


@pytest.fixture(scope="module")
def tables():
    return {"lineitem": tpch.gen_lineitem(0, rows=_ROWS),
            "orders": tpch.gen_orders(0, rows=_ROWS // 4),
            "customer": tpch.gen_customer(0, rows=_ROWS // 40),
            "supplier": tpch.gen_supplier(0, rows=_ROWS // 120),
            "nation": tpch.gen_nation(), "region": tpch.gen_region()}


def _outer(how):
    """customer (the probe) joined to orders (the build) on custkey: orders
    of customers past the table's last key are build rows no probe row
    matches, and customers without orders probe rows no build row
    matches."""
    def query(fns, t):
        col = fns.col
        return (t["customer"].select("c_custkey", "c_acctbal")
                .join(t["orders"].select("o_orderkey", "o_custkey",
                                         "o_totalprice"), how=how,
                      condition=col("c_custkey") == col("o_custkey")))
    return query


_QUERIES = {"q3": (tpch.q3, jtpch.q3), "q5": (tpch.q5, jtpch.q5),
            "q21": (tpch.q21, jtpch.q21),
            "right": (lambda t: _outer("right")(F, t),
                      lambda t: _outer("right")(JF, t)),
            "full": (lambda t: _outer("full")(F, t),
                     lambda t: _outer("full")(JF, t))}


@pytest.mark.parametrize("aqe", [False, True])
@pytest.mark.parametrize("name", sorted(_QUERIES))
def test_tpch_under_a_small_batch_budget_matches_jax(tables, monkeypatch,
                                                     name, aqe):
    """Each query with its builds over ``batchSizeBytes`` (48 KiB; 16 KiB
    for the outer joins, whose build is orders): AQE off plans shuffled
    joins, which take the grace join; AQE on demotes small builds to
    broadcast, and a broadcast build over the budget is split once for
    every partition. Rows equal the host engine's and the JAX
    package's in order, plans node for node, AQE events exactly, and the
    query leaves no buffer in the catalog."""
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 64,
            "spark.rapids.sql.batchSizeBytes":
                (16 if name in ("right", "full") else 48) * 1024,
            "spark.rapids.sql.test.enabled": True,
            "spark.rapids.tpu.aqe.enabled": aqe}
    if not aqe:
        conf["spark.rapids.tpu.autoBroadcastJoinThreshold"] = -1
    spy = _GraceSpy(monkeypatch)
    splits = []
    real_split = tjoins.TpuShuffledHashJoinExec._grace_split

    def split(node, table, keys, n_sub):
        if isinstance(node, tjoins.TpuBroadcastHashJoinExec) \
                and keys is node.right_keys:
            splits.append(id(node))
        return real_split(node, table, keys, n_sub)
    monkeypatch.setattr(tjoins.TpuShuffledHashJoinExec, "_grace_split",
                        split)
    cat = tcatalog.BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
    tcatalog.set_catalog(cat)
    try:
        sess = TorchSession(conf, device="cpu")
        port_q, jax_q = _QUERIES[name]
        q = port_q({k: sess.create_dataframe(v, num_partitions=2)
                    for k, v in tables.items()})
        plan = sess._physical(q.logical, True)
        got = plan.collect().to_arrow()
        assert plan.release_spill_handles() >= (1 if splits else 0)
        cat.assert_no_leaks()
        assert got.num_rows > 0 and spy.n_sub
        assert len(splits) == len(set(splits))
        if name in ("q3", "q5") and aqe:
            assert splits  # a demoted broadcast build over the budget
        # the JAX pipeline runs a broadcast join's partitions on threads
        # that share its one-entry prep cache, and a bucket's prep closes
        # another thread's (ROADMAP Queue 3): its partitions run in turn
        jsess = TpuSession({**conf, "spark.rapids.tpu.pipeline.enabled": False})
        jq = jax_q({k: jsess.create_dataframe(v, num_partitions=2)
                    for k, v in tables.items()})
        jplan = jsess._physical(jq.logical, True)
        want = jplan.collect().to_arrow()
        ordered = name not in ("right", "full")
        assert_tables_equal(got, want, ignore_order=not ordered)
        assert_tables_equal(got, q.collect(device=False),
                            ignore_order=not ordered)
        assert plan.tree_string() == jplan.tree_string()
        if aqe:
            assert isinstance(plan, AdaptiveExec)
            assert plan.events == jplan.events
        cat.assert_no_leaks()
    finally:
        tcatalog.set_catalog(None)


def test_dataframe_collect_closes_the_broadcast_and_its_parts(tables):
    """``DataFrame.collect`` releases what the plan registered: the
    broadcast build and its grace parts leave the catalog with the query."""
    cat = tcatalog.BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
    tcatalog.set_catalog(cat)
    try:
        sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 64,
                             "spark.rapids.sql.batchSizeBytes": 16 * 1024},
                            device="cpu")
        q = tpch.q3({k: sess.create_dataframe(v, num_partitions=2)
                     for k, v in tables.items()})
        assert q.collect().num_rows > 0
        cat.assert_no_leaks()
        assert cat.peak_device_bytes > 0
        assert cat.stats()["tiers"] == {}
    finally:
        tcatalog.set_catalog(None)


def test_grace_parts_spill_and_come_back_through_every_tier(tables,
                                                            tmp_path):
    """Q3 with AQE off under a catalog of a few parts: buckets go device
    -> host -> disk and back, and the rows stay the host engine's."""
    cat = tcatalog.BufferCatalog(device_limit=40_000, host_limit=20_000,
                                 disk_dir=str(tmp_path))
    tcatalog.set_catalog(cat)
    try:
        sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 64,
                             "spark.rapids.sql.batchSizeBytes": 16 * 1024,
                             "spark.rapids.tpu.autoBroadcastJoinThreshold":
                                 -1,
                             "spark.rapids.tpu.aqe.enabled": False},
                            device="cpu")
        q = tpch.q3({k: sess.create_dataframe(v, num_partitions=2)
                     for k, v in tables.items()})
        assert_tables_equal(q.collect(), q.collect(device=False),
                            ignore_order=False)
        counts = cat.stats()["spill_count"]
        assert counts[StorageTier.HOST] > 0 and counts[StorageTier.DISK] > 0
        cat.assert_no_leaks()
    finally:
        tcatalog.set_catalog(None)
