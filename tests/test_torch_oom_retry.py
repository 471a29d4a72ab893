"""The port's OOM retry ladder (memory/retry.py) against the JAX package's:
scripted functions that fail k times leave the same ladder records and the
same ``DeviceOomError`` fields, ``split_device_rows`` halves equal the JAX
halves plane for plane, the arbiter parks admissions across threads, the
classifier takes the torch allocators' errors, and Q1, Q6 and Q3 under a
strict pool and ``action=oom`` give their clean answers, and JAX's, with
retries and splits above 0."""
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.memory import retry as jretry
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.memory import catalog as tcat
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.retry import (DeviceOomError,
                                                 InjectedDeviceFailure,
                                                 is_retryable_oom)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch
from spark_rapids_tpu_torch.utils import faults

from harness import assert_tables_equal


@pytest.fixture(autouse=True)
def _jax_bucket_policy():
    """A JAX session sets the JAX package's process-wide bucket ladder
    (``configure_buckets``) for every later JAX call in the process; this
    file's sessions put it back as they found it."""
    from spark_rapids_tpu.columnar import device as jdev
    saved = jdev._POLICY
    yield
    jdev._POLICY = saved


_KEYS = ("scope", "attempts", "splits", "rematerializations",
         "spilled_bytes", "outcome")


def _reset():
    for mod in (retry, jretry):
        mod.reset_retry_state()
    retry.configure_oom_retry(RapidsConf({}))
    jretry.configure_oom_retry(JConf({}))
    faults.reset_faults()
    faults.reset_recovery()


@pytest.fixture(autouse=True)
def _pristine():
    _reset()
    yield
    _reset()


def _fake_spill(freed):
    def spill(self):
        self.spilled_bytes += freed
        return freed
    return spill


class _OomAfter:
    """Fails with the module's OOM for its first ``failures`` calls."""

    def __init__(self, failures, error):
        self.failures, self.error, self.calls = failures, error, 0

    def __call__(self, *args):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.error()
        return "ok"


_PORT_OOM = lambda: torch.OutOfMemoryError(  # noqa: E731
    "CUDA out of memory. Tried to allocate 2.00 GiB")
_JAX_OOM = lambda: RuntimeError(  # noqa: E731
    "RESOURCE_EXHAUSTED: out of memory while allocating 1234 bytes")


def _both(monkeypatch, freed, body):
    """``body(module, oom)`` on the port and on the JAX package, each with a
    fake spill rung freeing ``freed``; -> (port result, JAX result)."""
    out = []
    for mod, oom in ((retry, _PORT_OOM), (jretry, _JAX_OOM)):
        monkeypatch.setattr(mod._Ladder, "spill", _fake_spill(freed))
        try:
            res = ("ok", body(mod, oom))
        except Exception as e:  # both must fail alike
            res = (type(e).__name__, {k: getattr(e, k, None) for k in
                                      ("scope", "attempts", "splits",
                                       "spilled_bytes")})
        recs = [{k: r[k] for k in _KEYS}
                for r in mod.drain_oom_retry_records()]
        stats = {k: v for k, v in mod.retry_stats().items()}
        out.append((res, recs, stats))
    return out


@pytest.mark.parametrize("failures", [0, 1, 2, 3, 99])
@pytest.mark.parametrize("freed", [0, 512])
def test_with_retry_records_equal_jax(monkeypatch, failures, freed):
    def body(mod, oom):
        fn = _OomAfter(failures, oom)
        out = mod.with_retry(fn, scope="jit", context="c", max_retries=2)
        return out, fn.calls
    port, jax_ = _both(monkeypatch, freed, body)
    assert port == jax_


def _splitter(batch):
    if len(batch) <= 1:
        return None
    half = len(batch) // 2
    return batch[:half], batch[half:]


def _combine(outs):
    return [x for o in outs for x in o]


@pytest.mark.parametrize("limit", [1, 2, 3, 8])
@pytest.mark.parametrize("max_splits", [1, 2, 4])
@pytest.mark.parametrize("freed", [0, 4096])
def test_split_ladder_records_equal_jax(monkeypatch, limit, max_splits,
                                        freed):
    """A batch over ``limit`` rows fails; the halves recurse; the split
    budget spans the whole scope."""
    def body(mod, oom):
        ran = []

        def fn(batch):
            if len(batch) > limit:
                raise oom()
            ran.append(list(batch))
            return [x * 10 for x in batch]
        out = mod.with_retry_split(fn, list(range(8)), splitter=_splitter,
                                   combiner=_combine, scope="project",
                                   max_splits=max_splits)
        return out, ran
    port, jax_ = _both(monkeypatch, freed, body)
    assert port == jax_


def test_nested_ladder_escalates_straight_to_split(monkeypatch):
    def body(mod, oom):
        calls = []

        def fn(batch):
            calls.append(len(batch))
            if len(batch) > 2:
                raise mod.DeviceOomError("inner ladder exhausted",
                                         scope="jit")
            return list(batch)
        return mod.with_retry_split(fn, [1, 2, 3, 4], splitter=_splitter,
                                    combiner=_combine,
                                    scope="wholestage"), calls
    port, jax_ = _both(monkeypatch, 4096, body)
    assert port == jax_
    assert port[0][1] == ([1, 2, 3, 4], [4, 2, 2])


def test_classification_takes_the_torch_allocators():
    assert is_retryable_oom(torch.OutOfMemoryError("CUDA out of memory."))
    assert is_retryable_oom(torch.cuda.OutOfMemoryError("x"))
    assert is_retryable_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert is_retryable_oom(RuntimeError("CUDA error: out of memory"))
    assert is_retryable_oom(RuntimeError(
        "[enforce fail at alloc_cpu.cpp:117] . DefaultCPUAllocator: can't "
        "allocate memory: you tried to allocate 123 bytes."))
    assert is_retryable_oom(MemoryError(
        "strict pool mode: 999 bytes cannot fit (used=1, limit=2)"))
    assert is_retryable_oom(DeviceOomError("inner"))
    assert not is_retryable_oom(InjectedDeviceFailure(
        "CUDA error: injected non-retryable device failure"))
    assert not is_retryable_oom(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not is_retryable_oom(ValueError("CUDA out of memory"))


def test_injected_oom_is_a_real_torch_oom():
    faults.install(faults.FaultInjector(
        "alloc.jit:times=1:action=oom;alloc.upload:times=1:action=fatal", 0))
    with pytest.raises(torch.OutOfMemoryError):
        retry._maybe_inject("alloc.jit")
    with pytest.raises(InjectedDeviceFailure):
        retry._maybe_inject("alloc.upload")
    retry._maybe_inject("alloc.jit")  # spent: nothing


def _device_table(t: pa.Table, bucket: int) -> DeviceTable:
    return DeviceTable.from_host(HostTable.from_arrow(t), bucket,
                                 torch.device("cpu"))


def test_split_device_rows_equals_jax_plane_for_plane():
    from spark_rapids_tpu.columnar.device import DeviceTable as JTable
    from spark_rapids_tpu.columnar.host import HostTable as JHost
    rng = np.random.default_rng(4)
    n = 37
    t = pa.table({"a": pa.array(rng.integers(0, 9, n), type=pa.int64()),
                  "s": pa.array([["x", "yy", None, "zzz"][i % 4]
                                 for i in range(n)]),
                  "f": pa.array(np.where(rng.random(n) < .2, None,
                                         rng.random(n)), type=pa.float64())})
    port = _device_table(t, 8)
    jax_ = JTable.from_host(JHost.from_arrow(t), 8)
    # a scattered mask, so the split compacts first
    keep = rng.random(port.capacity) < 0.7
    port = port.filter_mask(torch.from_numpy(keep))
    jax_ = jax_.filter_mask(keep)
    halves = retry.split_device_rows(port)
    jhalves = jretry.split_device_rows(jax_)
    assert len(halves) == len(jhalves) == 2
    for h, jh in zip(halves, jhalves):
        assert h.capacity == jh.capacity
        assert np.array_equal(h.row_mask.numpy(), np.asarray(jh.row_mask))
        assert int(h.num_rows) == int(jh.num_rows)
        for c, jc in zip(h.columns, jh.columns):
            v, jv = np.asarray(c.validity), np.asarray(jc.validity)
            assert np.array_equal(v, jv)
            d, jd = c.data.numpy(), np.asarray(jc.data)
            if d.ndim == 2:  # the string matrices: the bytes and lengths
                w = min(d.shape[1], jd.shape[1])
                assert np.array_equal(d[v][:, :w], jd[jv][:, :w])
                assert np.array_equal(c.lengths.numpy()[v],
                                      np.asarray(jc.lengths)[jv])
            else:
                assert np.array_equal(d[v], jd[jv], equal_nan=True)
    back = retry._concat_combine(list(halves)).to_host().to_arrow()
    assert back.equals(port.to_host().to_arrow())
    one = _device_table(pa.table({"a": [7]}), 1)
    assert one.capacity == 1 and retry.split_device_rows(one) is None


def test_split_host_rows():
    t = HostTable.from_arrow(pa.table({"a": np.arange(11)}))
    a, b = retry.split_host_rows(t)
    assert (a.num_rows, b.num_rows) == (5, 6)
    assert pa.concat_tables([a.to_arrow(), b.to_arrow()]).equals(
        t.to_arrow())
    assert retry.split_host_rows(t.slice(0, 1)) is None


def test_arbiter_parks_admissions_across_threads():
    """While one thread retries, another's admission parks on the gate and
    goes on once the retrier disengages; a retrier never gates itself."""
    retry.configure_oom_retry(RapidsConf(
        {"spark.rapids.tpu.oom.arbitration.maxWaitSeconds": 5.0}))
    engaged, release = threading.Event(), threading.Event()
    waited = {}

    def retrier():
        retry._ARBITER.engage()
        retry.oom_admission_gate()  # never parks on itself
        engaged.set()
        release.wait(5)
        retry._ARBITER.disengage()

    def admit():
        engaged.wait(5)
        t0 = time.monotonic()
        retry.oom_admission_gate()
        waited["s"] = time.monotonic() - t0

    ts = [threading.Thread(target=retrier), threading.Thread(target=admit)]
    for t in ts:
        t.start()
    engaged.wait(5)
    time.sleep(0.3)
    assert retry.arbiter_snapshot()["gate_active"]
    release.set()
    for t in ts:
        t.join(5)
    assert waited["s"] >= 0.25
    assert retry.retry_stats()["gate_waits"] == 1
    assert not retry.arbiter_snapshot()["gate_active"]


def test_two_retriers_serialize_and_both_recover(monkeypatch):
    """Two threads OOM at once: their post-OOM attempts run under the
    exclusive token one after the other, and both recover."""
    monkeypatch.setattr(retry._Ladder, "spill", _fake_spill(1))
    inside, overlap = [0], []
    lock = threading.Lock()

    def work(_):
        with lock:
            inside[0] += 1
            overlap.append(inside[0])
        time.sleep(0.05)
        with lock:
            inside[0] -= 1
        return "ok"

    def run(out, i):
        fn = _OomAfter(1, _PORT_OOM)
        out[i] = retry.with_retry(lambda: fn() and work(None), scope="jit")

    out = [None, None]
    ts = [threading.Thread(target=run, args=(out, i)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert out == ["ok", "ok"]
    assert max(overlap) == 1
    assert retry.retry_stats()["oom_recoveries"] == 2


# ---------------------------------------------------------------------------
# TPC-H under a strict pool and injected OOMs
# ---------------------------------------------------------------------------
_BASE = {"spark.rapids.tpu.batchRowsMinBucket": 64,
         "spark.rapids.tpu.shuffle.partitions": 2}


@pytest.fixture(scope="module")
def tables():
    return jtpch.gen_all(0, tiny=True)


def _port_run(name, tables, conf):
    sess = TorchSession({**_BASE, **conf}, device="cpu")
    dfs = tpch.build_dataframes(sess, tables, num_partitions=2)
    return getattr(tpch, name)(dfs).collect()


@pytest.mark.parametrize("name", ["q1", "q6", "q3"])
def test_tpch_under_strict_pool_and_injected_oom(tables, name):
    """The ``bench.py _worker_oom`` contract on the CPU: a clean run gives
    the answer and the catalog's peak; a fresh session under
    ``memory.pool.mode=strict`` at 40 % of that peak and
    ``alloc.jit:after=3:times=2:action=oom`` (seed 11) gives the same
    answer, equal to the JAX package's, with retries and splits above 0
    and no host fallback."""
    from spark_rapids_tpu_torch.exec import fallback
    before = tcat.peek_catalog()
    try:
        tcat.set_catalog(None)
        clean = _port_run(name, tables, {})
        peak = tcat.peek_catalog().peak_device_bytes
        assert peak > 0
        fallback.reset_fallback_state()
        got = _port_run(name, tables, {
            "spark.rapids.tpu.memory.pool.size": max(int(peak * 0.4), 1),
            "spark.rapids.tpu.memory.pool.mode": "strict",
            "spark.rapids.tpu.faults.enabled": True,
            "spark.rapids.tpu.faults.seed": 11,
            "spark.rapids.tpu.faults.spec":
                "alloc.jit:after=3:times=2:action=oom"})
        faults.reset_faults()
        stats = retry.retry_stats()
        recs = retry.drain_oom_retry_records()
    finally:
        faults.reset_faults()
        TorchSession(device="cpu")  # default pool settings again
        tcat.set_catalog(before)
    assert_tables_equal(got, clean, ignore_order=False)
    jsess = TpuSession(_BASE)
    want = getattr(jtpch, name)(jtpch.build_dataframes(
        jsess, tables, num_partitions=2)).collect()
    assert_tables_equal(got, want, ignore_order=name != "q1")
    assert stats["oom_retries"] > 0 and stats["oom_splits"] > 0, stats
    assert any(r["cause"] == "OutOfMemoryError" for r in recs), recs
    assert fallback.fallback_stats()["host_fallbacks"] == 0
    led = faults.recovery_counters()
    assert led["oom_retries"] > 0 and led["oom_splits"] > 0


def test_upload_oom_splits_the_host_batch(tables):
    """``alloc.upload`` pressure: the upload scope splits the host batch
    (half the device footprint each) and Q6 is still right."""
    clean = _port_run("q6", tables, {})
    got = _port_run("q6", tables, {
        "spark.rapids.tpu.scan.deviceCache.enabled": False,
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.spec": "alloc.upload:times=3:action=oom"})
    faults.reset_faults()
    assert_tables_equal(got, clean)
    s = retry.retry_stats()
    assert s["oom_retries"] + s["oom_splits"] >= 1
    assert any(r["scope"] == "h2d-upload"
               for r in retry.drain_oom_retry_records())


def test_no_leaked_arbiter_state_after_a_failed_ladder(monkeypatch):
    monkeypatch.setattr(retry._Ladder, "spill", _fake_spill(0))
    with pytest.raises(DeviceOomError) as ei:
        retry.with_retry(_OomAfter(99, _PORT_OOM), scope="jit")
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert "survived the retry ladder" in str(ei.value)
    snap = retry.arbiter_snapshot()
    assert snap == {"active_retriers": 0, "gate_active": False,
                    "token_held": False}
    (rec,) = retry.drain_oom_retry_records()
    assert rec["cause"] == "OutOfMemoryError" and rec["outcome"] == "failed"
