"""The task semaphore (memory/semaphore.py) against the JAX package's
``TpuSemaphore``: reentrant attributed holds, ``dump()`` of the same shape,
the held-time histogram equal to the JAX ``Histogram`` on the same
observations, ``concurrentGpuTasks`` permits across threads, admission
parked on the OOM gate, and each partition's device drain held in a task
scope during ``collect``."""
import threading
import time

import numpy as np
import pytest

from spark_rapids_tpu.memory import semaphore as jsem
from spark_rapids_tpu.utils.metrics import Histogram as JHistogram

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.memory import retry, semaphore
from spark_rapids_tpu_torch.memory.semaphore import TaskSemaphore
from spark_rapids_tpu_torch.utils.metrics import Histogram


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_equals_jax(seed):
    import random
    rng = random.Random(seed)
    vals = [rng.expovariate(3.0) for _ in range(rng.choice([0, 5, 3000]))]
    h, jh = Histogram("x"), JHistogram("x")
    for v in vals:
        h.observe(v)
        jh.observe(v)
    snap, jsnap = h.snapshot(), jh.snapshot()
    assert list(snap) == list(jsnap)
    np.testing.assert_array_equal(list(snap.values()), list(jsnap.values()))
    np.testing.assert_array_equal(h.quantiles([0.1, 0.5, 0.99]),
                                  jh.quantiles([0.1, 0.5, 0.99]))


def test_reentrant_attributed_holds_and_dump_shape():
    sem, js = TaskSemaphore(2), jsem.TpuSemaphore(2)
    for s in (sem, js):
        s.acquire_if_necessary(7)
        s.acquire_if_necessary(7)
        assert s.holder_count() == 1
        s.release_if_held(7)
        assert s.holder_count() == 1
        s.release_if_held(7)
        assert s.holder_count() == 0
    d, jd = sem.dump(), js.dump()
    assert set(d) == set(jd)
    assert d["acquires"] == jd["acquires"] == 1
    assert d["held_seconds"]["count"] == jd["held_seconds"]["count"] == 1


def test_task_scope_releases_every_hold():
    sem = TaskSemaphore(1)
    with sem.task_scope(3):
        sem.acquire_if_necessary(3)
        sem.acquire_if_necessary(3)
        assert sem.dump()["holders"][0]["depth"] == 3
    assert sem.holder_count() == 0
    # the permit is free again for another task
    with sem.held(4):
        assert sem.holder_count() == 1


def test_permits_bound_concurrent_tasks():
    sem = TaskSemaphore(2)
    inside, peak = [0], [0]
    lock = threading.Lock()

    def task(i):
        with sem.task_scope(i):
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            time.sleep(0.05)
            with lock:
                inside[0] -= 1

    ts = [threading.Thread(target=task, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert peak[0] == 2
    assert sem.dump()["acquires"] == 6 and sem.holder_count() == 0


def test_admission_parks_on_the_oom_gate():
    retry.reset_retry_state()
    retry.configure_oom_retry(RapidsConf(
        {"spark.rapids.tpu.oom.arbitration.maxWaitSeconds": 5.0}))
    sem = TaskSemaphore(4)
    engaged, release, done = (threading.Event() for _ in range(3))
    t_admit = {}

    def retrier():
        retry._ARBITER.engage()
        engaged.set()
        release.wait(5)
        retry._ARBITER.disengage()

    def admit():
        engaged.wait(5)
        t0 = time.monotonic()
        sem.acquire_if_necessary(99)
        t_admit["s"] = time.monotonic() - t0
        sem.release_all(99)
        done.set()

    ts = [threading.Thread(target=retrier), threading.Thread(target=admit)]
    for t in ts:
        t.start()
    engaged.wait(5)
    time.sleep(0.2)
    assert not done.is_set()
    release.set()
    for t in ts:
        t.join(5)
    assert t_admit["s"] >= 0.15
    retry.reset_retry_state()


def test_session_permits_and_drain_scope():
    """``concurrentGpuTasks`` sets the permits; each partition drain holds
    one task's permit and the collect leaves none held. Sequentially
    (``pipeline.enabled=false``) the calling thread holds it, one holder
    at a time; pipelined, each drain holds its own on a pool thread, never
    more than the permits."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import transitions
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    for pipelined in (False, True):
        sess = TorchSession({"spark.rapids.sql.concurrentGpuTasks": 3,
                             "spark.rapids.tpu.pipeline.enabled": pipelined},
                            device="cpu")
        sem = semaphore.peek_semaphore()
        assert sem.permits == 3
        seen = []
        orig = transitions.to_host_batched

        def spy(tables):
            seen.append(sem.dump()["holders"])
            return orig(tables)
        transitions.to_host_batched = spy
        try:
            df = sess.create_dataframe(pa.table({"a": list(range(100))}),
                                       num_partitions=2)
            out = df.filter(F.col("a") > 10).collect()
        finally:
            transitions.to_host_batched = orig
        assert out.num_rows == 89
        assert len(seen) == 2
        if pipelined:
            assert all(1 <= len(h) <= 2 for h in seen)
            assert all(x["thread"].startswith("srt-pipeline:collect")
                       for h in seen for x in h)
        else:
            assert all(len(h) == 1 for h in seen)
            assert seen[0][0]["thread"] == threading.current_thread().name
        assert sem.holder_count() == 0
    TorchSession(device="cpu")
    assert semaphore.peek_semaphore().permits == 1


def test_nested_drain_keeps_the_outer_hold():
    sem = semaphore.get_semaphore(RapidsConf({}))
    with sem.drain_scope():
        with sem.drain_scope():
            pass
        assert sem.holder_count() == 1
    assert sem.holder_count() == 0
