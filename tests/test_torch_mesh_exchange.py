"""The device exchange across a mesh (shuffle/ici.py ``mesh_exchange``,
exec/exchange.py ``TpuShuffleExchangeExec``) against the JAX package's ICI
tier: the JAX side on its 8 virtual CPU devices (tests/conftest.py), the
port on ``virtual_mesh(n, "cpu")``, the same seeded numpy inputs.

Tolerances: shards, slots, masks and planes exactly; query rows exactly,
doubles at rel 1e-9 (tests/harness.py), plans (``tree_string``) exactly."""
import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import Mesh

from harness import assert_tables_equal
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.device import DeviceTable as JTable
from spark_rapids_tpu.columnar.device import stable_counting_order
from spark_rapids_tpu.columnar.host import HostColumn as JCol
from spark_rapids_tpu.columnar.host import HostTable as JHost
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.parallel.mesh import virtual_cpu_mesh
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle import ici as jici
from spark_rapids_tpu.shuffle.manager import _partition_order

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostColumn, HostTable
from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
from spark_rapids_tpu_torch.plan.physical import ShuffleExchangeExec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.ici import (mesh_exchange, shard_table,
                                                unshard_table)
from spark_rapids_tpu_torch.shuffle.manager import counting_order

_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 8,
         "spark.rapids.tpu.shuffle.partitions": 4}


def _columns(rng, n):
    k = rng.integers(0, 50, n).astype(np.int64)
    valid = rng.uniform(size=n) > 0.1
    v = rng.uniform(0, 1, n)
    s = np.array(["a", "bb", "ccc", "dddddddddd", "", "ééé"],
                 dtype=object)[rng.integers(0, 6, n)]
    d = rng.integers(0, 1000, n).astype(np.int32)
    return [("k", dt.LONG, jdt.LONG, k, valid), ("v", dt.DOUBLE, jdt.DOUBLE,
                                                 v, None),
            ("s", dt.STRING, jdt.STRING, s, None),
            ("d", dt.DATE, jdt.DATE, d, valid)]


@pytest.mark.parametrize("n_dev,quota,keys", [
    (8, 32, ["k"]), (8, None, ["k", "s"]), (4, 128, ["s"]),
    (2, None, ["d", "k"])])
def test_mesh_exchange_equals_ici_all_to_all_slot_for_slot(n_dev, quota,
                                                           keys):
    rng = np.random.default_rng(n_dev)
    cols = _columns(rng, 512)
    jt = JHost([c[0] for c in cols], [JCol(c[2], c[3], c[4]) for c in cols])
    pt = HostTable([c[0] for c in cols],
                   [HostColumn(c[1], c[3], c[4]) for c in cols])
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    jout = jici.ici_all_to_all_exchange(
        jici.shard_table(JTable.from_host(jt, min_bucket=8, capacity=512),
                         mesh), keys, mesh, quota=quota)
    pout = mesh_exchange(shard_table(
        DeviceTable.from_host(pt, 8, torch.device("cpu"), capacity=512),
        virtual_mesh(n_dev)), keys, quota=quota)
    assert len(pout.shards) == n_dev
    ju, pu = jici.unshard_table(jout), unshard_table(pout)
    np.testing.assert_array_equal(np.asarray(ju.row_mask),
                                  pu.row_mask.numpy())
    for jc, pc in zip(ju.columns, pu.columns):
        np.testing.assert_array_equal(np.asarray(jc.data), pc.data.numpy())
        np.testing.assert_array_equal(np.asarray(jc.validity),
                                      pc.validity.numpy())
        if jc.lengths is not None:
            np.testing.assert_array_equal(np.asarray(jc.lengths),
                                          pc.lengths.numpy())
    assert int(ju.num_rows) == int(pu.num_rows) == 512


@pytest.mark.parametrize("n,p", [(1000, 5), (1000, 32), (777, 40),
                                 (300, 200)])
def test_counting_order_equals_stable_counting_order_and_partition_order(
        n, p):
    """P <= 31 takes the JAX one-hot order, P > 31 its stable argsort: the
    plain counting order equals both."""
    rng = np.random.default_rng(p)
    ids = rng.integers(0, p, n).astype(np.int32)
    order, counts = counting_order(torch.from_numpy(ids), p)
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(stable_counting_order(ids, p)))
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(_partition_order(ids, p - 1)))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=p))


def _find(plan, cls, out=None):
    out = [] if out is None else out
    if isinstance(plan, cls):
        out.append(plan)
    for c in plan.children:
        _find(c, cls, out)
    return out


def _sessions(n_dev=8, **extra):
    conf = {**_CONF, "spark.rapids.tpu.aqe.enabled": False, **extra}
    port = TorchSession(conf, device="cpu").attach_mesh(virtual_mesh(n_dev))
    jsess = TpuSession(conf)
    jsess.attach_mesh(virtual_cpu_mesh(n_dev))
    return port, jsess


def _queries(which, fns, sess):
    rng = np.random.default_rng(3)
    col, fsum, count = fns.col, fns.sum, fns.count
    if which == "groupby":
        t = pa.table({"k": rng.integers(0, 20, 400),
                      "v": rng.uniform(0, 10, 400)})
        df = sess.create_dataframe(t, num_partitions=3)
        return df.group_by("k").agg(fsum(col("v")).alias("s"),
                                    count(col("v")).alias("n"))
    if which == "strings":
        keys = np.array(["alpha", "beta", "gamma", "d", "epsilon-long-key",
                         ""])
        t = pa.table({"k": keys[rng.integers(0, len(keys), 300)],
                      "v": rng.uniform(0, 5, 300)})
        return sess.create_dataframe(t, num_partitions=2).group_by("k") \
            .agg(fsum(col("v")).alias("s"))
    left = pa.table({"k": rng.integers(0, 30, 250),
                     "a": rng.uniform(0, 1, 250)})
    right = pa.table({"k": np.arange(30), "b": rng.uniform(0, 1, 30)})
    return sess.create_dataframe(left, num_partitions=3).join(
        sess.create_dataframe(right, num_partitions=2), on="k", how="inner")


@pytest.mark.parametrize("which", ["groupby", "strings", "join"])
def test_planner_exchanges_across_the_mesh_as_jax_does(which):
    """tests/test_exchange.py's queries: the hash exchanges plan as the
    port's TpuShuffleExchangeExec, the plan equals the JAX package's node
    for node, the rows equal JAX's and the host engine's."""
    extra = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1} \
        if which == "join" else {}
    port, jsess = _sessions(**extra)
    q, jq = _queries(which, F, port), _queries(which, JF, jsess)
    plan = port._physical(q.logical, device=True)
    jplan = jsess._physical(jq.logical, device=True)
    assert _find(plan, TpuShuffleExchangeExec), plan.tree_string()
    got = plan.collect().to_arrow()
    want = jplan.collect().to_arrow()
    assert plan.tree_string() == jplan.tree_string()
    assert_tables_equal(got, want)
    assert_tables_equal(got, q.collect(device=False))


def test_host_mode_keeps_the_host_exchange():
    port, _ = _sessions(**{"spark.rapids.tpu.shuffle.mode": "host"})
    q = _queries("groupby", F, port)
    plan = port._physical(q.logical, device=True)
    assert not _find(plan, TpuShuffleExchangeExec)
    assert _find(plan, ShuffleExchangeExec)
    assert_tables_equal(plan.collect().to_arrow(), q.collect(device=False))


def test_a_mesh_of_one_shard_is_the_local_tier():
    port = TorchSession({**_CONF, "spark.rapids.tpu.aqe.enabled": False},
                        device="cpu").attach_mesh(virtual_mesh(1))
    assert port.shuffle_mesh() is None
    plan = port._physical(_queries("groupby", F, port).logical, True)
    assert not _find(plan, TpuShuffleExchangeExec)
    assert "TpuLocalExchangeExec" in plan.tree_string()


def test_exchange_streams_chunks_and_counts_once_per_chunk():
    """exchangeChunkRows=512: the 8000-row input streams in chunks, each
    with its own quota from its count pass; partitions hold one spill
    handle a chunk; the rows and the skew record equal the input's."""
    port, _ = _sessions(**{"spark.rapids.tpu.shuffle.exchangeChunkRows": 512,
                           "spark.rapids.tpu.mesh.stageExecution.enabled":
                           False})
    rng = np.random.default_rng(11)
    t = pa.table({"k": rng.integers(0, 40, 8000).astype("int64"),
                  "v": rng.uniform(0, 10, 8000)})
    q = port.create_dataframe(t, num_partitions=4).group_by("k").agg(
        F.sum(F.col("v")).alias("s"))
    plan = port._physical(q.logical, device=True)
    ex = _find(plan, TpuShuffleExchangeExec)[0]
    got = plan.collect().to_arrow()
    assert_tables_equal(got, q.collect(device=False))
    assert ex.metrics["exchangeChunks"] > 1
    assert len(ex.quotas) == ex.metrics["exchangeChunks"]
    assert any(len(ex.partition_handles(p)) > 1 for p in range(8))
    rows, nbytes = ex.partition_stats()
    assert sum(rows) == sum(n for p in range(8)
                            for _h, n in ex.partition_handles(p))
    assert len(nbytes) == 8


def test_float_keys_meet_on_one_shard_where_jax_splits_them():
    """A join on a float key whose values include -0.0 and 0.0 and NaNs of
    two payloads, across an 8-shard mesh, AQE off. The host engine (Spark's
    semantics: -0.0 = 0.0, NaN = NaN in a join key) is the reference; the
    port's exchange hashes floats normalised and equals it. The JAX package
    hashes the raw bits (shuffle/manager.py:174-177): its rows, pinned here
    as a reference fault the port does not copy, lose the matches that
    landed on another shard."""
    conf = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1}
    port, jsess = _sessions(**conf)
    nan2 = np.array([0x7FF8000000000001], dtype=np.uint64).view(
        np.float64)[0]
    lk = np.array([0.0, -0.0, np.nan, nan2, 1.5, -0.0, 2.5] * 20)
    rk = np.array([-0.0, 0.0, nan2, np.nan, 1.5, 3.5])
    left = pa.table({"f": lk, "a": np.arange(len(lk))})
    right = pa.table({"f": rk, "b": np.arange(len(rk)) * 10})

    def run(sess, device):
        df = sess.create_dataframe(left, num_partitions=3).join(
            sess.create_dataframe(right, num_partitions=2), on="f")
        return df, df.collect(device=device)
    q, got = run(port, True)
    want = q.collect(device=False)
    assert_tables_equal(got, want)
    # every zero matches both zeros, every NaN both NaNs, 1.5 once
    assert got.num_rows == 20 * (3 * 2 + 2 * 2 + 1)
    _, jgot = run(jsess, True)
    assert jgot.num_rows < got.num_rows  # the pinned JAX fault
