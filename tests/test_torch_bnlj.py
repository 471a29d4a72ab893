"""The nested-loop and cross joins of the port against the JAX package: every
join type through the port's device path (``TpuBroadcastNestedLoopJoinExec``
with ``test.enabled``), its host engine (``CpuBroadcastNestedLoopJoinExec``)
and the JAX package, rows equal as multisets and ``tree_string()`` plans
equal. The cases are the JAX package's ``tests/test_device_joins.py``
(non-equi conditions, the cross join, build windowing under a 64 KiB
``batchSizeBytes``, unmatched build rows once over 3 stream partitions)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec.joins import TpuBroadcastNestedLoopJoinExec
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.plan import physical_joins as pj
from spark_rapids_tpu_torch.session import TorchSession

from harness import assert_tables_equal, data_gen


@pytest.fixture(autouse=True)
def _jax_bucket_policy():
    """A JAX session sets the JAX package's process-wide bucket ladder
    (``configure_buckets``) for every later JAX call in the process; this
    file's sessions put it back as they found it."""
    from spark_rapids_tpu.columnar import device as jdev
    saved = jdev._POLICY
    yield
    jdev._POLICY = saved


_HOWS = ["inner", "cross", "left", "right", "full", "left_semi", "left_anti"]


def _bnlj_nodes(plan):
    stack, found = [plan], []
    while stack:
        node = stack.pop()
        if type(node).__name__ == "TpuBroadcastNestedLoopJoinExec":
            found.append(node)
        stack.extend(node.children)
    return found


def _run(query, tables, conf=None, parts=(2, 1)):
    """``query(fns, dataframes)`` through the port (device with
    ``test.enabled``, and its host engine) and the JAX package: rows equal
    as multisets, plans equal. Returns (port rows, the device join node)."""
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 8, **(conf or {})}
    sess = TorchSession({**conf, "spark.rapids.sql.test.enabled": True},
                        device="cpu")
    jsess = TpuSession(conf)
    q, jq = (query(fns, {k: s.create_dataframe(v, num_partitions=p)
                         for (k, v), p in zip(tables.items(), parts)})
             for s, fns in ((sess, F), (jsess, JF)))
    plan = sess._physical(q.logical, True)
    got = plan.collect().to_arrow()
    nodes = _bnlj_nodes(plan)
    assert nodes, plan.tree_string()
    jplan = jsess._physical(jq.logical, True)
    want = jplan.collect().to_arrow()
    assert plan.tree_string() == jplan.tree_string()
    assert_tables_equal(got, want, ignore_order=True)
    assert_tables_equal(got, q.collect(device=False), ignore_order=True)
    return got, nodes[0]


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(23)
    return {"l": data_gen(rng, 60, {"a": ("int64", 0, 40)}),
            "r": data_gen(rng, 25, {"b": ("int64", 0, 40)})}


@pytest.mark.parametrize("how", _HOWS)
def test_every_join_type_greater_than(sides, how):
    def query(fns, t):
        cond = None if how == "cross" else fns.col("a") > fns.col("b")
        return t["l"].join(t["r"], how=how, condition=cond)
    _run(query, sides)


@pytest.mark.parametrize("how", [h for h in _HOWS if h != "cross"])
def test_every_join_type_plus_one(sides, how):
    """``a == b + 1`` is no equi-key (one side is an expression): it stays
    a nested-loop condition, as in the JAX plan."""
    _run(lambda fns, t: t["l"].join(
        t["r"], how=how, condition=fns.col("a") == fns.col("b") + 1), sides)


def test_cross_join_method_and_strings():
    """``DataFrame.cross_join`` on string and float columns: every pair."""
    rng = np.random.default_rng(5)
    tables = {"l": data_gen(rng, 13, {"s": "string", "x": "float64"}),
              "r": data_gen(rng, 7, {"t": "string", "y": "int32"})}
    got, _ = _run(lambda fns, t: t["l"].cross_join(t["r"]), tables)
    assert got.num_rows == 13 * 7


@pytest.mark.parametrize("budget", [64 * 1024, 4 * 1024])
@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_build_side_windowing_under_64k(how, budget):
    """Both sides window so the pair slots stay under ``batchSizeBytes``:
    at the JAX case's 64 KiB the 400-row build (capacity 512) is one
    window; at 4 KiB it is crossed in several build windows, and the
    stream side's any-pass and the build's seen rows are ORed over them.
    Rows equal every time, right/full leftovers included."""
    rng = np.random.default_rng(7)
    tables = {"l": data_gen(rng, 150, {"a": ("int64", 0, 60)},
                            null_prob=0.05),
              "r": data_gen(rng, 400, {"b": ("int64", 0, 60)},
                            null_prob=0.05)}
    conf = {"spark.rapids.sql.batchSizeBytes": budget,
            "spark.rapids.tpu.autoBroadcastJoinThreshold": -1}
    _, node = _run(lambda fns, t: t["l"].join(
        t["r"], how=how, condition=fns.col("a") == fns.col("b") + 1),
        tables, conf)
    ws, bws = node.window_shape
    assert (bws < 512) == (budget == 4 * 1024)
    assert node._window_shape(512) == (ws, bws)


def test_window_shape_equals_the_jax_formula():
    from spark_rapids_tpu.exec.joins import \
        TpuBroadcastNestedLoopJoinExec as JBnlj
    from spark_rapids_tpu.plan.schema import Field as JField
    from spark_rapids_tpu.plan.schema import Schema as JSchema
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    from spark_rapids_tpu_torch.plan.schema import Field, Schema

    class _Leaf:
        def __init__(self, schema):
            self.schema = schema
            self.children = ()
            self.num_partitions = 1

    tl = _Leaf(Schema([Field("a", tdt.LONG), Field("s", tdt.STRING)]))
    tr = _Leaf(Schema([Field("b", tdt.DOUBLE)]))
    jl = _Leaf(JSchema([JField("a", jdt.LONG), JField("s", jdt.STRING)]))
    jr = _Leaf(JSchema([JField("b", jdt.DOUBLE)]))
    for bb in (64 * 1024, 1 << 20, 512 << 20):
        for mb in (8, 1024):
            t = TpuBroadcastNestedLoopJoinExec(
                tl, tr, "inner", None, torch.device("cpu"), RapidsConf({
                    "spark.rapids.tpu.batchRowsMinBucket": mb,
                    "spark.rapids.sql.batchSizeBytes": bb}))
            j = JBnlj(jl, jr, "inner", None, mb, bb)
            for cap in (8, 64, 1024, 1 << 16, 1 << 20):
                assert t._window_shape(cap) == j._window_shape(cap)


def test_unmatched_build_rows_once_over_three_partitions():
    """right/full: a build row no stream row matches appears exactly once,
    whatever the stream's partitions and batches."""
    rng = np.random.default_rng(11)
    tables = {"l": data_gen(rng, 50, {"a": ("int64", 0, 10)},
                            null_prob=0.0),
              "r": pa.table({"b": [5, 1000]})}
    for how in ("right", "full"):
        got, _ = _run(lambda fns, t: t["l"].join(
            t["r"], how=how, condition=fns.col("a") > fns.col("b")),
            tables, parts=(3, 1))
        assert got.column("b").to_pylist().count(1000) == 1


def test_host_engine_chunks_equal_one_pass(monkeypatch):
    """The host engine forms the pairs in chunks; the rows and their order
    do not depend on the chunk size."""
    from spark_rapids_tpu_torch.columnar.host import HostTable
    from spark_rapids_tpu_torch.plan.planner import plan_physical
    rng = np.random.default_rng(3)
    lt = data_gen(rng, 70, {"a": ("int64", 0, 20)})
    rt = data_gen(rng, 9, {"b": ("int64", 0, 20)})
    sess = TorchSession(device="cpu")
    l, r = sess.create_dataframe(lt), sess.create_dataframe(rt)
    for how in _HOWS:
        cond = None if how == "cross" else F.col("a") >= F.col("b")
        node = plan_physical(l.join(r, how=how, condition=cond).logical,
                             sess.conf)
        while not isinstance(node, pj.CpuBroadcastNestedLoopJoinExec):
            node = node.children[0]
        args = (HostTable.from_arrow(lt), HostTable.from_arrow(rt), [], [],
                how, node.condition, False)
        whole = pj.join_host_tables(*args)
        monkeypatch.setattr(pj, "_PAIR_CHUNK", 20)
        chunked = pj.join_host_tables(*args)
        monkeypatch.undo()
        assert whole.to_arrow().equals(chunked.to_arrow())


def test_plans_without_equi_keys_are_nested_loop():
    """No equality between the sides: the host plan is the nested-loop
    join, never a raise; an equality plus a residual stays a hash join."""
    from spark_rapids_tpu_torch.plan.planner import plan_physical
    sess = TorchSession(device="cpu")
    l = sess.create_dataframe(pa.table({"a": [1, 2, 3]}))
    r = sess.create_dataframe(pa.table({"b": [2, 3]}))
    for q in (l.cross_join(r), l.join(r, condition=F.col("a") < F.col("b")),
              l.join(r, how="left", condition=(F.col("a") < F.col("b"))
                     | (F.col("a") == F.col("b")))):
        text = plan_physical(q.logical, sess.conf).tree_string()
        assert "CpuBroadcastNestedLoopJoinExec" in text, text
    eq = l.join(r, condition=(F.col("a") == F.col("b"))
                & (F.col("a") > F.lit(1)))
    assert "NestedLoop" not in plan_physical(eq.logical,
                                             sess.conf).tree_string()
