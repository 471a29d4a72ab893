"""The pipelined executor (parallel/pipeline.py) against the sequential
collect and the JAX package's pipeline: the same rows in the same order,
bounded queues, errors that cross threads, admission that never deadlocks,
and the grace join under concurrent drains (the JAX pipeline shares a
broadcast join's one-entry prep cache across its threads and raises; the
port keeps an entry per task).

Every test that starts threads waits for them with a timeout, so a hang
fails the test instead of stopping the suite. Tolerances: rows exactly,
doubles at rel 1e-9 (tests/harness.py)."""
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from harness import assert_tables_equal
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.memory.semaphore import get_semaphore
from spark_rapids_tpu_torch.parallel import pipeline as P
from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

_WAIT_S = 60.0


def _run_with_timeout(fn):
    """``fn()`` on a thread joined with a timeout: a hang fails the test."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(_WAIT_S)
    assert not t.is_alive(), "the pipelined run hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _conf(enabled, **extra):
    return {"spark.rapids.tpu.batchRowsMinBucket": 8,
            "spark.rapids.tpu.shuffle.partitions": 6,
            "spark.rapids.tpu.pipeline.enabled": enabled,
            "spark.rapids.tpu.pipeline.taskPool": 3, **extra}


@pytest.mark.parametrize("tier", ["host", "mesh"])
def test_pipelined_collect_equals_sequential_in_partition_order(tier):
    """Six host-tier (or eight mesh) partitions drained by three tasks: the
    rows in partition order equal the sequential collect's."""
    rng = np.random.default_rng(0)
    t = pa.table({"k": rng.integers(0, 100, 3000),
                  "v": rng.uniform(0, 1, 3000)})
    outs = []
    for enabled in (True, False):
        extra = {"spark.rapids.tpu.aqe.enabled": False}
        if tier == "host":
            extra["spark.rapids.tpu.shuffle.mode"] = "host"
        sess = TorchSession(_conf(enabled, **extra), device="cpu")
        if tier == "mesh":
            sess.attach_mesh(virtual_mesh(8))
        q = sess.create_dataframe(t, num_partitions=3).group_by("k").agg(
            F.sum(F.col("v")).alias("s"))
        assert sess._physical(q.logical).num_partitions > 1
        outs.append(_run_with_timeout(q.collect))
    assert_tables_equal(outs[0], outs[1], ignore_order=False)
    deadline = time.monotonic() + _WAIT_S
    while P.active_workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert P.active_workers() == 0


def test_q1_q6_pipelined_equal_jax_and_sequential():
    tables = tpch.gen_all(0, tiny=True)
    for name in ("q1", "q6"):
        got = {}
        for enabled in (True, False):
            sess = TorchSession(_conf(enabled), device="cpu")
            q = getattr(tpch, name)(tpch.build_dataframes(sess, tables, 3))
            got[enabled] = _run_with_timeout(q.collect)
        jsess = TpuSession(_conf(False))
        jq = getattr(jtpch, name)(jtpch.build_dataframes(jsess, tables, 3))
        assert_tables_equal(got[True], got[False], ignore_order=False)
        assert_tables_equal(got[True], jq.collect(),
                            ignore_order=False)


def test_grace_join_under_the_pipeline():
    """Q3 with a batch budget that sends its broadcast builds through the
    grace join, drained by concurrent tasks: equal to the sequential run,
    the host engine and the JAX package run sequentially (its pipeline
    breaks on this shape)."""
    tables = tpch.gen_all(0, tiny=True)
    extra = {"spark.rapids.sql.batchSizeBytes": 4000}
    outs = {}
    for enabled in (True, False):
        sess = TorchSession(_conf(enabled, **extra), device="cpu")
        q = tpch.q3(tpch.build_dataframes(sess, tables, 3))
        outs[enabled] = _run_with_timeout(q.collect)
    assert outs[True].num_rows > 0
    assert_tables_equal(outs[True], outs[False], ignore_order=False)
    assert_tables_equal(outs[True], q.collect(device=False),
                        ignore_order=False)
    jsess = TpuSession(_conf(False, **extra))
    jq = jtpch.q3(jtpch.build_dataframes(jsess, tables, 3))
    assert_tables_equal(outs[True], jq.collect(),
                        ignore_order=False)


def test_prefetched_keeps_order_and_bounds_its_queue():
    P.configure_pipeline(TorchSession(_conf(True), device="cpu").conf)
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    seen = []
    for x in P.prefetched(gen, stage="test", depth=2):
        # the producer runs at most depth (+1 in hand) ahead
        assert len(produced) - len(seen) <= 4
        seen.append(x)
        time.sleep(0.001)
    assert seen == list(range(50))


def test_prefetched_reraises_the_workers_error_with_its_stage():
    def gen():
        yield 1
        raise KeyError("lost block")

    it = P.prefetched(gen, stage="shuffle_map", depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError) as e:
        next(it)
    assert any("shuffle_map" in n for n in getattr(e.value, "__notes__", []))


def test_an_abandoned_prefetch_cancels_its_worker():
    def gen():
        i = 0
        while True:
            i += 1
            yield i

    it = P.prefetched(gen, stage="endless", depth=2)
    assert next(it) == 1
    it.close()
    deadline = time.monotonic() + _WAIT_S
    while P.active_workers() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert P.active_workers() == 0


def test_parallel_map_keeps_order_and_raises_the_first_error():
    P.configure_pipeline(TorchSession(_conf(True), device="cpu").conf)
    assert P.parallel_map(lambda x: x * x, range(20), max_workers=4) \
        == [x * x for x in range(20)]

    def bad(x):
        if x == 7:
            raise ValueError("seven")
        return x
    with pytest.raises(ValueError, match="seven"):
        P.parallel_map(bad, range(20), max_workers=4)


def test_workers_run_under_their_tasks_admission():
    """A stage worker takes no permit of its own: with one permit held by
    the task, the worker's acquire returns at once."""
    sess = TorchSession(_conf(True, **{
        "spark.rapids.sql.concurrentGpuTasks": 1}), device="cpu")
    sem = get_semaphore(sess.conf)

    def worker_acquires():
        sem.acquire_if_necessary()
        sem.release_if_held()
        yield "ok"

    with sem.task_scope():
        out = _run_with_timeout(lambda: list(
            P.prefetched(worker_acquires, stage="exempt", depth=1)))
    assert out == ["ok"]
    assert sem.holder_count() == 0
