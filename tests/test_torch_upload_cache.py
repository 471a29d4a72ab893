"""The upload cache, the coalesce after upload and the bulk download of the
PyTorch port (on the CPU), against the JAX package's
``spark_rapids_tpu/exec/transitions.py``.

The cache's counters are process-wide, so every test starts from empty
caches (both packages) and compares deltas."""
import gc
import hashlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar.device import (
    to_host_batched as jto_host_batched)
from spark_rapids_tpu.columnar.host import HostTable as JHostTable
from spark_rapids_tpu.exec import transitions as jtrans
from spark_rapids_tpu.plan.physical import PhysicalPlan as JPhysicalPlan
from spark_rapids_tpu.plan.schema import Schema as JSchema
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.columnar.device import (DeviceTable,
                                                    to_host_batched)
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.exec import transitions as trans
from spark_rapids_tpu_torch.exec.transitions import (
    HostToDeviceExec, TpuCoalesceBatchesExec, clear_upload_cache,
    upload_cache_stats)
from spark_rapids_tpu_torch.plan.aqe import walk_plan
from spark_rapids_tpu_torch.plan.physical import PhysicalPlan
from spark_rapids_tpu_torch.plan.schema import Schema
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal

_KEYS = ("entries", "bytes", "hits", "inserts", "evictions")
_CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_caches():
    gc.collect()
    clear_upload_cache()
    jtrans.clear_upload_cache()
    yield
    clear_upload_cache()
    jtrans.clear_upload_cache()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in _KEYS}


@pytest.fixture(scope="module")
def tables():
    return jtpch.gen_all(0, tiny=True)


def _sequence(stats, session, queries, tables, parts=2):
    """Each query twice over one set of DataFrames; -> the stats delta of
    each run and the results."""
    dfs = {k: session.create_dataframe(v, num_partitions=parts)
           for k, v in tables.items()}
    deltas, results = [], []
    for q in queries:
        for _ in range(2):
            before = stats()
            results.append(q(dfs).collect())
            deltas.append(_delta(before, stats()))
    return deltas, results


def test_second_run_hits_and_deltas_equal_jax(tables):
    names = ("q6", "q1", "q3")
    deltas, results = _sequence(
        upload_cache_stats, TorchSession(device="cpu"),
        [tpch.QUERIES[n] for n in names], tables)
    jdeltas, jresults = _sequence(
        jtrans.upload_cache_stats, TpuSession(),
        [jtpch.QUERIES[n] for n in names], tables)
    assert deltas == jdeltas
    for i in range(0, len(deltas), 2):
        cold, warm = deltas[i], deltas[i + 1]
        assert cold["inserts"] > 0 and cold["hits"] == 0
        assert warm["hits"] == cold["inserts"] and warm["inserts"] == 0
    for got, want in zip(results, jresults):
        assert_tables_equal(got, want, ignore_order=False)


def test_dropped_source_frees_its_bytes(tables):
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tables["lineitem"], num_partitions=2)
    tpch.q6({"lineitem": df}).collect()
    held = upload_cache_stats()
    assert held["bytes"] > 0 and held["entries"] == 2
    del df
    gc.collect()
    after = upload_cache_stats()
    assert after["bytes"] == 0 and after["entries"] == 0
    assert after["evictions"] - held["evictions"] == 2


@pytest.mark.parametrize("conf", [
    {"spark.rapids.tpu.scan.deviceCache.maxBytes": 0},
    {"spark.rapids.tpu.scan.deviceCache.maxBytes": 1000},
    {"spark.rapids.tpu.scan.deviceCache.enabled": False}])
def test_uploads_past_the_budget_are_served_uncached(tables, conf):
    sess = TorchSession({**conf, "spark.rapids.tpu.aqe.enabled": False},
                        device="cpu")
    df = sess.create_dataframe(tables["lineitem"], num_partitions=2)
    q = tpch.q6({"lineitem": df})
    before = upload_cache_stats()
    first = q.collect()
    plan = sess._physical(q.logical, True)
    second = plan.collect().to_arrow()
    assert _delta(before, upload_cache_stats()) == dict.fromkeys(_KEYS, 0)
    assert_tables_equal(first, second, ignore_order=False)
    uploads = [n for n in walk_plan(plan)
               if isinstance(n, HostToDeviceExec)]
    assert uploads and all(u.metrics["uploadCacheHits"] == 0
                           and u.metrics["uploadBytes"] > 0 for u in uploads)


def test_budget_serves_what_does_not_fit_and_evicts_nothing(tables):
    """A budget that holds one batch: the first upload is cached, the
    second is served uncached; no entry is evicted."""
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tables["lineitem"], num_partitions=2)
    q = tpch.q6({"lineitem": df})
    q.collect()
    one = upload_cache_stats()["bytes"] // 2
    clear_upload_cache()
    tight = TorchSession({"spark.rapids.tpu.scan.deviceCache.maxBytes":
                          one}, device="cpu")
    q2 = tpch.q6({"lineitem": tight.create_dataframe(
        tables["lineitem"], num_partitions=2)})
    before = upload_cache_stats()
    q2.collect()
    q2.collect()
    d = _delta(before, upload_cache_stats())
    assert d == {"entries": 1, "bytes": one, "hits": 1, "inserts": 1,
                 "evictions": 0}


def test_clear_upload_cache_empties_it(tables):
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tables["lineitem"], num_partitions=2)
    tpch.q6({"lineitem": df}).collect()
    held = upload_cache_stats()["bytes"]
    assert held > 0
    assert clear_upload_cache() == held
    assert upload_cache_stats()["bytes"] == 0
    assert upload_cache_stats()["entries"] == 0
    before = upload_cache_stats()
    tpch.q6({"lineitem": df}).collect()
    assert _delta(before, upload_cache_stats())["inserts"] == 2


def test_cpu_and_cuda_keys_never_share_an_entry():
    ht = HostTable.from_arrow(pa.table({"a": [1, 2, 3]}))
    child = type("Src", (PhysicalPlan,), {
        "schema": Schema([]), "children": (),
        "execute": lambda self, p: iter([ht]),
        "num_partitions": property(lambda self: 1)})()
    up = HostToDeviceExec(child, 64, _CPU, cache_max_bytes=1 << 20)
    a = next(up.execute_columnar(0))
    assert next(up.execute_columnar(0)) is a
    # another device (meta tensors stand in for a card here) gets its own
    # upload under its own key
    other = HostToDeviceExec(child, 64, torch.device("meta"),
                             cache_max_bytes=1 << 20)
    b = next(other.execute_columnar(0))
    assert b is not a and b.device.type == "meta" and a.device == _CPU
    assert next(other.execute_columnar(0)) is b
    assert set(trans._UPLOAD_CACHE[id(ht)][1]) == {
        (64, _CPU), (64, torch.device("meta"))}


def _plane_hashes() -> dict:
    out = {}
    for key, (_, tables_) in list(trans._UPLOAD_CACHE.items()):
        for inner, t in tables_.items():
            planes = [t.row_mask, t.num_rows]
            for c in t.columns:
                planes += [c.data, c.validity]
                if c.lengths is not None:
                    planes.append(c.lengths)
            out[(key, inner)] = [hashlib.sha1(p.numpy().tobytes()).hexdigest()
                                 for p in planes]
    return out


@pytest.mark.parametrize("name", ["q1", "q3", "q13", "q18", "q21"])
def test_cached_planes_never_change(tables, name):
    """A cached batch is shared by every later run: no query writes into
    its tensors, and the second run (from the cache) equals the first."""
    sess = TorchSession(device="cpu")
    dfs = {k: sess.create_dataframe(v, num_partitions=2)
           for k, v in tables.items()}
    q = tpch.QUERIES[name](dfs)
    first = q.collect()
    before = _plane_hashes()
    assert before
    stats = upload_cache_stats()
    second = q.collect()
    assert _delta(stats, upload_cache_stats())["hits"] > 0
    assert _plane_hashes() == before
    assert_tables_equal(second, first, ignore_order=False)


# ---------------------------------------------------------------------------
# coalescing after upload
# ---------------------------------------------------------------------------
def _host(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 9, n), pa.int64()),
                     "s": pa.array([f"v{i}" * (i % 3) for i in range(n)],
                                   pa.string()),
                     "d": pa.array(rng.normal(size=n),
                                   mask=rng.random(n) < 0.2)})


class _Batches(PhysicalPlan):
    def __init__(self, batches, schema):
        self.batches, self.schema, self.children = batches, schema, ()

    def execute_columnar(self, pidx):
        yield from self.batches


class _JBatches(JPhysicalPlan):
    def __init__(self, batches, schema):
        self.batches, self.schema, self.children = batches, schema, ()

    def execute_columnar(self, pidx):
        yield from self.batches


_CAPS = [64, 64, 128, 64, 256, 64, 64]


def _coalesce_pair(**goal):
    port, jax_ = [], []
    for i, cap in enumerate(_CAPS):
        t = _host(cap - 7, i)
        port.append(DeviceTable.from_host(HostTable.from_arrow(t), 64, _CPU,
                                          capacity=cap))
        jax_.append(JDeviceTable.from_host(JHostTable.from_arrow(t), 64,
                                           capacity=cap))
    ex = TpuCoalesceBatchesExec(_Batches(port, Schema([])), min_bucket=64,
                                **goal)
    jex = jtrans.TpuCoalesceBatchesExec(_JBatches(jax_, JSchema([])),
                                        min_bucket=64, **goal)
    return ex, jex


@pytest.mark.parametrize("goal", [
    {"target_rows": 192}, {"target_rows": 256},
    {"target_rows": 1 << 20, "target_bytes": 4000},
    {"target_rows": 200, "target_bytes": 2500},
    {"target_rows": 64}])
def test_coalesce_flush_points_equal_jax(goal):
    ex, jex = _coalesce_pair(**goal)
    assert ex.node_desc() == jex.node_desc()
    got, want = list(ex.execute_columnar(0)), list(jex.execute_columnar(0))
    assert [t.capacity for t in got] == [t.capacity for t in want]
    assert [int(t.num_rows) for t in got] == [int(t.num_rows) for t in want]
    assert [t.nbytes() for t in got] == [t.nbytes() for t in want]
    assert ex.metrics["numOutputBatches"] == len(got)
    for t, jt in zip(got, want):
        assert_tables_equal(t.to_host().to_arrow(), jt.to_host().to_arrow(),
                            ignore_order=False)


def test_coalesce_after_upload_is_planned_as_in_jax(tables):
    conf = {"spark.rapids.tpu.coalesce.afterUpload.enabled": True,
            "spark.rapids.tpu.coalesce.targetBytes": 1 << 20}
    sess, jsess = TorchSession(conf, device="cpu"), TpuSession(conf)
    for name in ("q6", "q1"):
        q = tpch.QUERIES[name]({"lineitem": sess.create_dataframe(
            tables["lineitem"], num_partitions=2)})
        jq = jtpch.QUERIES[name]({"lineitem": jsess.create_dataframe(
            tables["lineitem"], num_partitions=2)})
        plan, jplan = sess._physical(q.logical, True), \
            jsess._physical(jq.logical, True)
        got = plan.collect().to_arrow()
        assert_tables_equal(got, jplan.collect().to_arrow())
        assert_tables_equal(got, q.collect(device=False))
        text = plan.tree_string()
        assert "TpuCoalesceBatchesExec [rows=1048576 bytes=1048576]" in text
        assert text == jplan.tree_string()


# ---------------------------------------------------------------------------
# bulk download
# ---------------------------------------------------------------------------
def test_to_host_batched_equals_per_batch_to_host():
    """The bulk download of filtered batches (strings, nulls, empty ones)
    against the filtered source tables and the JAX package's
    ``to_host_batched`` of the same batches; one batch alone
    (``DeviceTable.to_host``, plane by plane) against the same."""
    tables_, jtables, want = [], [], []
    for i, n in enumerate((0, 5, 64, 200)):
        src = _host(n, i)
        t = DeviceTable.from_host(HostTable.from_arrow(src), 64, _CPU)
        jt = JDeviceTable.from_host(JHostTable.from_arrow(src), 64)
        if n:
            t = t.filter_mask(t.column("k").data % 3 != 0)
            jt = jt.filter_mask(jt.column("k").data % 3 != 0)
            src = src.filter(pa.array(src.column("k").to_numpy() % 3 != 0))
        tables_.append(t)
        jtables.append(jt)
        want.append(src)
    got = to_host_batched(tables_)
    jgot = jto_host_batched(jtables)
    assert len(got) == len(tables_) == len(jgot)
    for g, jg, src, t in zip(got, jgot, want, tables_):
        assert g.num_rows == src.num_rows
        assert g.to_arrow().equals(src), g.to_arrow()
        assert g.to_arrow().equals(jg.to_arrow())
        assert t.to_host().to_arrow().equals(src)
    assert to_host_batched([]) == []


def test_async_off_downloads_per_batch_with_equal_results(tables):
    outs = []
    for bulk in (True, False):
        sess = TorchSession({"spark.rapids.tpu.async.enabled": bulk},
                            device="cpu")
        q = tpch.q1({"lineitem": sess.create_dataframe(
            tables["lineitem"], num_partitions=2)})
        plan = sess._physical(q.logical, True)
        outs.append(plan.collect().to_arrow())
        roots = [n for n in walk_plan(plan.final_plan())
                 if type(n).__name__ == "DeviceToHostExec"]
        assert roots and all(r.bulk == bulk for r in roots)
    assert_tables_equal(outs[0], outs[1], ignore_order=False)
