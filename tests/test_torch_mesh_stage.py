"""Mesh stages (exec/mesh.py ``TpuMeshStageExec``, ``plan_mesh_stages``)
against the JAX package's (tests/test_mesh_exec.py's cases): the port on
``virtual_mesh(n, "cpu")``, JAX on its 8 virtual CPU devices.

Tolerances: plans (``tree_string``) exactly; rows exactly, doubles at rel
1e-9 (tests/harness.py)."""
import numpy as np
import pyarrow as pa
import pytest

from harness import assert_tables_equal
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.parallel.mesh import virtual_cpu_mesh
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.exec.mesh import MESH_DISPATCHES, TpuMeshStageExec
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch
from spark_rapids_tpu_torch.utils import faults

_BASE = {"spark.rapids.tpu.batchRowsMinBucket": 8,
         "spark.rapids.tpu.shuffle.partitions": 4,
         "spark.rapids.tpu.aqe.enabled": False}
_OFF = {"spark.rapids.tpu.mesh.stageExecution.enabled": False}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset_faults()
    yield
    faults.reset_faults()


def _port(n=8, **extra):
    return TorchSession({**_BASE, **extra}, device="cpu").attach_mesh(
        virtual_mesh(n))


def _jax(n=8, **extra):
    s = TpuSession({**_BASE, **extra})
    s.attach_mesh(virtual_cpu_mesh(n))
    return s


def _frame(sess, rows=64, seed=0):
    rng = np.random.default_rng(seed)
    return sess.create_dataframe(pa.table({
        "k": rng.integers(0, 9, rows), "v": rng.random(rows),
        "w": rng.integers(-50, 50, rows)}), num_partitions=2)


def _agg(df, fns):
    return df.group_by("k").agg(fns.sum(fns.col("v")).alias("s"),
                                fns.count(fns.col("w")).alias("c"))


def _find(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children:
        r = _find(c, cls)
        if r is not None:
            return r
    return None


_QUERIES = {
    "final_agg": lambda df, f: _agg(df, f),
    "project_over_agg": lambda df, f: _agg(df, f).select(
        (f.col("s") + f.col("c")).alias("t"), f.col("k")),
    "filter_over_agg": lambda df, f: _agg(df, f).filter(f.col("c") > 5),
}


@pytest.mark.parametrize("name", sorted(_QUERIES))
@pytest.mark.parametrize("n", [2, 8])
def test_mesh_stage_plan_and_rows_equal_jax(name, n):
    """The exchange's consumer chain lifts onto the mesh as in the JAX
    package (plan node for node); rows equal JAX's, the per-partition
    path's and the host engine's; one dispatch a shard."""
    port, jsess = _port(n), _jax(n)
    q = _QUERIES[name](_frame(port), F)
    plan = port._physical(q.logical, device=True)
    jplan = jsess._physical(_QUERIES[name](_frame(jsess), JF).logical,
                            device=True)
    got = plan.collect().to_arrow()
    assert plan.tree_string() == jplan.tree_string()
    node = _find(plan, TpuMeshStageExec)
    assert node is not None and node._has_final_agg()
    assert node.exchange._keep_sharded
    assert node.metrics[MESH_DISPATCHES] == n
    assert node.chain[0].children == (node.exchange,)
    for below, above in zip(node.chain, node.chain[1:]):
        assert above.children == (below,)
    assert_tables_equal(got, jplan.collect().to_arrow())
    assert_tables_equal(got, q.collect(device=False))
    off = _port(n, **_OFF)
    qo = _QUERIES[name](_frame(off), F)
    plan_off = off._physical(qo.logical, device=True)
    assert _find(plan_off, TpuMeshStageExec) is None
    assert_tables_equal(got, plan_off.collect().to_arrow())


def test_keep_sharded_exchange_splits_late_for_a_per_partition_reader():
    port = _port()
    q = _agg(_frame(port, rows=200), F)
    plan = port._physical(q.logical, device=True)
    node = _find(plan, TpuMeshStageExec)
    ex = node.exchange
    chunks = ex.sharded_chunks()
    assert chunks is not None and len(chunks) == 1
    assert ex._shards is None  # no per-shard registration
    # a per-partition consumer forces the late split: same rows
    rows = sum(int(b.num_rows) for p in range(8)
               for b in ex.execute_columnar(p))
    assert rows == sum(chunks[0][1])
    assert ex.sharded_chunks() is None
    assert_tables_equal(plan.collect().to_arrow(), q.collect(device=False))
    assert node.fell_back


def test_multi_chunk_exchange_hits_the_unshard_boundary():
    """With more than one streamed chunk a final aggregate cannot run per
    shard: the exchange splits, the stage falls back, the rows stay."""
    port = _port(**{"spark.rapids.tpu.shuffle.exchangeChunkRows": 64})
    q = _agg(_frame(port, rows=2000), F)
    plan = port._physical(q.logical, device=True)
    got = plan.collect().to_arrow()
    node = _find(plan, TpuMeshStageExec)
    assert node.fell_back and node.metrics[MESH_DISPATCHES] == 0
    assert node.exchange.metrics["exchangeChunks"] > 1
    assert_tables_equal(got, q.collect(device=False))


def test_injected_dispatch_failure_degrades_with_parity():
    """A classified failure of the dispatch quarantines the stage and runs
    the per-partition path: the same rows."""
    port = _port(**{"spark.rapids.tpu.faults.enabled": True,
                    "spark.rapids.tpu.faults.spec":
                    "mesh.dispatch:times=1:action=fatal"})
    q = _agg(_frame(port), F)
    plan = port._physical(q.logical, device=True)
    got = plan.collect().to_arrow()
    assert _find(plan, TpuMeshStageExec).fell_back
    assert_tables_equal(got, q.collect(device=False))


def test_unclassified_failure_propagates(monkeypatch):
    port = _port()
    q = _agg(_frame(port), F)
    plan = port._physical(q.logical, device=True)

    def boom(self, chunk):
        raise ValueError("a bug, not a device failure")
    monkeypatch.setattr(TpuMeshStageExec, "_dispatch_chunk", boom)
    with pytest.raises(ValueError, match="a bug"):
        plan.collect()


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_tpch_on_the_mesh_equals_jax_and_the_host(query):
    """TPC-H at the tiny scale over an 8-shard mesh, AQE off, broadcasts
    off: the plan equals the JAX package's, the rows JAX's, the
    per-partition path's and the host engine's."""
    conf = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1}
    tables = tpch.gen_all(0, tiny=True)
    port, jsess = _port(**conf), _jax(**conf)
    q = getattr(tpch, query)(tpch.build_dataframes(port, tables, 2))
    jq = getattr(jtpch, query)(jtpch.build_dataframes(jsess, tables, 2))
    plan = port._physical(q.logical, device=True)
    jplan = jsess._physical(jq.logical, device=True)
    got = plan.collect().to_arrow()
    assert plan.tree_string() == jplan.tree_string()
    assert _find(plan, TpuShuffleExchangeExec) is not None
    ordered = query == "q1"
    assert_tables_equal(got, jplan.collect().to_arrow(),
                        ignore_order=not ordered)
    assert_tables_equal(got, q.collect(device=False),
                        ignore_order=not ordered)
