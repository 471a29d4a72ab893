"""The memory profiler (utils/memprof.py), the catalog's strict pool and
debug allocator (memory/catalog.py), the spill stores' fault points and
buffer donation, against the JAX package: one sequence of registrations,
spills, restores and frees drives both catalogs and both profilers, whose
holders, peaks, aggregations and leak reports must be equal; the holders
sum to the catalog's peak within 1 % (the JAX pin); a strict pool raises
"cannot fit" with a postmortem first; the debug allocator catches double
frees, underflows and uses after close; a corrupt spill ends in the
checksum's error; a donated plane is released."""
import gc
import weakref

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceTable as JTable
from spark_rapids_tpu.columnar.host import HostTable as JHost
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.memory import catalog as jcat
from spark_rapids_tpu.utils import memprof as jmemprof
from spark_rapids_tpu.utils.node_context import node_scope as jnode_scope

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.memory import catalog as tcat
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   DebugMemoryError)
from spark_rapids_tpu_torch.memory.stores import (SpillCorruptionError,
                                                  StorageTier)
from spark_rapids_tpu_torch.utils import faults, memprof
from spark_rapids_tpu_torch.utils.node_context import node_scope


@pytest.fixture(autouse=True)
def _jax_bucket_policy():
    """A JAX session sets the JAX package's process-wide bucket ladder
    (``configure_buckets``) for every later JAX call in the process; this
    file's sessions put it back as they found it."""
    from spark_rapids_tpu.columnar import device as jdev
    saved = jdev._POLICY
    yield
    jdev._POLICY = saved


def _arrow(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({"a": rng.integers(0, 100, n), "b": rng.uniform(0, 1, n),
                     "s": [f"str{i}" for i in range(n)]})


def _pair(n=64, seed=0):
    t = _arrow(n, seed)
    return (DeviceTable.from_host(HostTable.from_arrow(t), 8,
                                  torch.device("cpu")),
            JTable.from_host(JHost.from_arrow(t), min_bucket=8))


@pytest.fixture
def profilers():
    prev, jprev = memprof.get_memprof(), jmemprof.get_memprof()
    mp, jmp = memprof.MemoryProfiler(), jmemprof.MemoryProfiler()
    memprof.set_memprof(mp)
    jmemprof.set_memprof(jmp)
    yield mp, jmp
    memprof.set_memprof(prev)
    jmemprof.set_memprof(jprev)


def _drop_times(d):
    if isinstance(d, dict):
        return {k: _drop_times(v) for k, v in d.items()
                if k not in ("held_s", "ts")}
    if isinstance(d, list):
        return [_drop_times(v) for v in d]
    return d


def test_one_sequence_drives_both_profilers_alike(monkeypatch):
    """Registrations under three operators, a spill forced by the budget,
    a restore, an external source and frees: the same ring kinds, holders,
    peaks, aggregations and leak report in both packages. Each catalog
    reports to its own profiler, on this thread only (a thread an earlier
    test left behind must not write into the rings compared here)."""
    import threading
    mp, jmp = memprof.MemoryProfiler(), jmemprof.MemoryProfiler()
    me = threading.get_ident()
    monkeypatch.setattr(tcat, "_memprof",
                        lambda: mp if threading.get_ident() == me else None)
    monkeypatch.setattr(jcat, "_memprof",
                        lambda: jmp if threading.get_ident() == me else None)
    (t1, j1), (t2, j2), (t3, j3) = (_pair(128 * (i + 1), i)
                                    for i in range(3))
    assert t1.nbytes() == j1.nbytes() and t3.nbytes() == j3.nbytes()
    limit = t1.nbytes() + t2.nbytes() + t3.nbytes() // 2
    cat = BufferCatalog(device_limit=limit, host_limit=1 << 30)
    jc = jcat.BufferCatalog(device_limit=limit, host_limit=1 << 30)
    ext = {"v": 0}
    hs, jhs = [], []
    for nid, (name, t, j) in enumerate([("ScanExec", t1, j1),
                                        ("HashAggregateExec", t2, j2),
                                        ("SortExec", t3, j3)]):
        with node_scope(nid, name, query_id=11), \
                jnode_scope(nid, name, query_id=11):
            hs.append(cat.register(t))
            jhs.append(jc.register(j))
    assert [h.tier for h in hs] == [h.tier for h in jhs]
    assert hs[0].tier == StorageTier.HOST
    ext["v"] = 999
    cat.register_external_bytes("upload_cache", lambda: ext["v"])
    jc.register_external_bytes("upload_cache", lambda: ext["v"])
    with node_scope(0, "ScanExec", query_id=11), \
            jnode_scope(0, "ScanExec", query_id=11):
        hs[0].get()
        jhs[0].get()
    hs[1].close()
    jhs[1].close()
    assert cat.peak_device_bytes == jc.peak_device_bytes
    assert [e["kind"] for e in mp.events()] \
        == [e["kind"] for e in jmp.events()]
    assert mp.holders_by_operator() == jmp.holders_by_operator()
    assert mp.peak_holders == jmp.peak_holders
    assert mp.peak_bytes == jmp.peak_bytes
    assert _drop_times(mp.snapshot()) == _drop_times(jmp.snapshot())
    assert mp.stats() == jmp.stats()
    assert _drop_times(mp.query_end(11)) == _drop_times(jmp.query_end(11))
    for h in hs[:1] + hs[2:]:
        h.close()
    for h in jhs[:1] + jhs[2:]:
        h.close()


def test_holders_sum_to_the_catalog_peak(profilers):
    mp, _ = profilers
    cat = BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
    handles = []
    for nid, name in enumerate(["ScanExec", "HashAggregateExec",
                                "ShuffleExchangeExec"]):
        with node_scope(nid, name, query_id=3):
            handles.append(cat.register(_pair(128 * (nid + 1), nid)[0]))
    assert sum(mp.peak_holders.values()) == mp.peak_bytes
    assert mp.peak_bytes == pytest.approx(cat.peak_device_bytes, rel=0.01)
    for h in handles:
        h.close()
    summary = mp.query_end(3)
    assert sum(d["peak_bytes"] for d in summary["per_operator"].values()) \
        == pytest.approx(cat.peak_device_bytes, rel=0.01)
    assert summary["leaked_bytes"] == 0


def test_a_query_attributes_its_operators_and_leaks_nothing(profilers):
    """A collect runs in a query scope and every device operator in its
    node scope: the broadcast build is held by its join, a join's spilled
    and restored bytes are attributed, and nothing stays registered."""
    mp, _ = profilers
    from spark_rapids_tpu.tools import tpch as jtpch
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    before = tcat.peek_catalog()
    try:
        tcat.set_catalog(BufferCatalog(device_limit=1 << 30,
                                       host_limit=1 << 30))
        sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 64},
                            device="cpu")
        dfs = tpch.build_dataframes(sess, jtpch.gen_all(0, tiny=True),
                                    num_partitions=2)
        tpch.q3(dfs).collect()
        summary = sess.last_memory_summary
    finally:
        tcat.set_catalog(before)
    assert summary["leaked_buffers"] == []
    ops = {k.split("#")[0] for k in summary["per_operator"]}
    assert ops & {"TpuBroadcastHashJoinExec", "TpuShuffledHashJoinExec"}
    assert sum(summary["peak_holders"].values()) == summary["peak_bytes"]


def test_strict_pool_raises_cannot_fit_with_a_postmortem(profilers):
    mp, _ = profilers
    t, _ = _pair(256, 1)
    cat = BufferCatalog(RapidsConf({
        "spark.rapids.tpu.memory.pool.mode": "strict",
        "spark.rapids.tpu.memory.pool.size": t.nbytes() + 10}))
    h = cat.register(t)
    h2 = None
    with h:  # pinned: nothing can spill
        with pytest.raises(MemoryError, match="cannot fit") as ei:
            h2 = cat.register(_pair(256, 2)[0])
    from spark_rapids_tpu_torch.memory.retry import is_retryable_oom
    assert is_retryable_oom(ei.value) and h2 is None
    (pm,) = mp.drain_postmortems()
    assert "allocation failure: strict pool mode" in pm["context"]
    assert "holders by operator" in pm["report"]
    # unpinned, the same registration spills the first and fits
    h3 = cat.register(_pair(256, 2)[0])
    assert h.tier == StorageTier.HOST and h3.tier == StorageTier.DEVICE
    for x in (h, h3):
        x.close()


def test_pool_mode_none_keeps_no_budget():
    t, _ = _pair(256, 1)
    cat = BufferCatalog(RapidsConf({
        "spark.rapids.tpu.memory.pool.mode": "none",
        "spark.rapids.tpu.memory.pool.size": 1}))
    hs = [cat.register(_pair(256, i)[0]) for i in range(3)]
    assert all(h.tier == StorageTier.DEVICE for h in hs)
    for h in hs:
        h.close()


def test_debug_allocator_catches_misuse_as_jax_does():
    conf = {"spark.rapids.tpu.memory.debug": True}
    cat = BufferCatalog(RapidsConf(conf), device_limit=1 << 30,
                        host_limit=1 << 30)
    jc = jcat.BufferCatalog(JConf(conf), device_limit=1 << 30,
                            host_limit=1 << 30)
    for c, t in ((cat, _pair(64, 5)[0]), (jc, _pair(64, 5)[1])):
        h = c.register(t)
        site = c._sites[h.buffer_id]
        assert site.rsplit(":", 1)[1].isdigit()
        with pytest.raises(Exception, match="refcount underflow"):
            c.release(h.buffer_id)
        h.close()
        with pytest.raises(Exception, match="double free"):
            c.close_buffer(h.buffer_id)
        with pytest.raises(Exception, match="use-after-close"):
            c.acquire(h.buffer_id)
        with pytest.raises(Exception, match="unknown/closed"):
            c.release(h.buffer_id)
        leak = c.register(t)
        with pytest.raises(Exception, match="1 leaked buffer"):
            c.assert_no_leaks()
        leak.close()
        c.used = None
    with pytest.raises(DebugMemoryError):
        cat.close_buffer(0)


def test_debug_poisons_freed_host_planes_and_checks_drift():
    t, _ = _pair(64, 6)
    cat = BufferCatalog(RapidsConf({"spark.rapids.tpu.memory.debug": True}),
                        device_limit=t.nbytes(), host_limit=1 << 30)
    h1 = cat.register(t)
    h2 = cat.register(_pair(64, 7)[0])
    assert h1.tier == StorageTier.HOST
    planes = cat._buffers[h1.buffer_id].host_arrays
    h1.close()
    assert all((a.view(np.uint8) == 0xDD).all() for a in planes.values()
               if a.ndim)
    cat.device.used_bytes += 1
    with pytest.raises(DebugMemoryError, match="device accounting drift"):
        cat._check_invariants()
    cat.device.used_bytes -= 1
    assert "site=" in cat.oom_dump() and "test_torch_memprof.py" not in \
        cat.oom_dump().split("largest buffers:")[0]
    h2.close()


@pytest.mark.parametrize("direct", [True, False])
def test_corrupt_spill_ends_in_the_checksum_error(tmp_path, direct):
    t, _ = _pair(64, 8)
    conf = RapidsConf({"spark.rapids.tpu.memory.disk.direct": direct})
    cat = BufferCatalog(conf, device_limit=t.nbytes(), host_limit=1,
                        disk_dir=str(tmp_path))
    faults.reset_recovery()
    faults.install(faults.FaultInjector("spill.write:times=1:action=corrupt",
                                        0))
    try:
        h1 = cat.register(t)
        h2 = cat.register(_pair(64, 9)[0])
        assert h1.tier == StorageTier.DISK
        with pytest.raises(SpillCorruptionError, match="crc32"):
            h1.get()
        assert faults.recovery_counters()["spill_corruptions"] == 1
    finally:
        faults.reset_faults()
    h2.close()


def test_spill_write_raise_and_read_fault(tmp_path):
    t, _ = _pair(64, 10)
    cat = BufferCatalog(device_limit=t.nbytes(), host_limit=1,
                        disk_dir=str(tmp_path))
    faults.install(faults.FaultInjector("spill.write:times=1", 0))
    try:
        h1 = cat.register(t)
        with pytest.raises(faults.FaultInjectedError, match="spill.write"):
            cat.register(_pair(64, 11)[0])
        # the failed write left the buffer whole on the device, spillable
        # later (the JAX package's straight-to-disk path loses it)
        assert h1.tier == StorageTier.DEVICE
        assert h1.get().nbytes() == t.nbytes()
        faults.install(faults.FaultInjector("spill.read:times=1", 0))
        h2 = cat.register(_pair(64, 11)[0])
        assert h1.tier == StorageTier.DISK
        with pytest.raises(SpillCorruptionError, match="injected fault"):
            h1.get()
    finally:
        faults.reset_faults()
    h2.close()


def test_session_binds_a_catalog_of_its_pool_settings():
    before = tcat.peek_catalog()
    from spark_rapids_tpu_torch.session import TorchSession
    try:
        tcat.set_catalog(None)
        TorchSession(device="cpu")
        assert tcat.peek_catalog() is None      # made on first use
        TorchSession({"spark.rapids.tpu.memory.pool.size": 1 << 20,
                      "spark.rapids.tpu.memory.pool.mode": "strict"},
                     device="cpu")
        strict = tcat.peek_catalog()
        assert strict.device.limit_bytes == 1 << 20
        assert strict._pool_mode == "strict"
        TorchSession(device="cpu")               # a default session after
        assert tcat.peek_catalog() is not strict
        assert tcat.peek_catalog()._pool_mode == "logical"
        explicit = BufferCatalog(device_limit=123)
        tcat.set_catalog(explicit)
        TorchSession({"spark.rapids.tpu.memory.pool.mode": "none"},
                     device="cpu")
        assert tcat.peek_catalog() is explicit   # a test's catalog stays
    finally:
        tcat.set_catalog(before)


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------
_DONATE = {"spark.rapids.tpu.scan.deviceCache.enabled": False,
           "spark.rapids.tpu.donation.force": True,
           "spark.rapids.tpu.batchRowsMinBucket": 8}


def _donating_query(fns, df):
    col = fns.col
    return df.filter(col("a") > fns.lit(10)).select(
        (col("a") + fns.lit(1)).alias("a1"), col("b"))


def test_a_donated_plane_is_released():
    """An upload the cache does not keep is the stage's alone: the stage
    takes it out of its box, the chain consumes it, and the input's planes
    die before the stage's output is consumed (a weakref to one dies)."""
    from spark_rapids_tpu_torch.exec.wholestage import TpuWholeStageExec
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    sess = TorchSession(_DONATE, device="cpu")
    df = sess.create_dataframe(_arrow(100, 3).select(["a", "b"]))
    plan = sess._physical(_donating_query(F, df).logical, True)
    stage = plan.child
    assert isinstance(stage, TpuWholeStageExec) and stage.donate_inputs
    upload = stage.source
    refs = []
    orig = upload._upload

    def spy(batch):
        t = orig(batch)
        refs.append(weakref.ref(t.columns[0].data))
        return t
    upload._upload = spy
    gen = stage.execute_columnar(0)
    out = next(gen)
    gc.collect()
    assert refs and refs[0]() is None
    assert stage.metrics["donatedBytes"] > 0
    assert int(out.num_rows) == int((_arrow(100, 3)["a"].to_numpy()
                                     > 10).sum())
    gen.close()


def test_donated_bytes_equal_jax():
    """Under ``donation.force`` on the CPU both packages donate every
    uncached upload of the same plan, and count the same bytes."""
    from spark_rapids_tpu.expr import functions as JF
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.utils import metrics as JM
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    t = _arrow(300, 4).select(["a", "b"])
    sess = TorchSession(_DONATE, device="cpu")
    jsess = TpuSession(_DONATE)
    plan = sess._physical(_donating_query(
        F, sess.create_dataframe(t, num_partitions=2)).logical, True)
    jplan = jsess._physical(_donating_query(
        JF, jsess.create_dataframe(t, num_partitions=2)).logical, True)
    got, want = plan.collect().to_arrow(), jplan.collect().to_arrow()
    assert got.equals(want)
    jbytes = jplan.child.metrics.metric(JM.DONATED_BYTES).value
    assert jbytes > 0
    assert plan.child.metrics["donatedBytes"] == jbytes


def test_cached_and_registered_batches_are_never_donated():
    from spark_rapids_tpu_torch.exec.transitions import (mark_exclusive,
                                                         take_exclusive)
    t, _ = _pair(64, 12)
    mark_exclusive(t)
    BufferCatalog(device_limit=1 << 30).register(t).close()
    assert not take_exclusive(t)
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    sess = TorchSession({**_DONATE,
                         "spark.rapids.tpu.scan.deviceCache.enabled": True},
                        device="cpu")
    plan = sess._physical(_donating_query(
        F, sess.create_dataframe(_arrow(50, 1).select(["a", "b"]))).logical,
        True)
    plan.collect()
    assert plan.child.metrics["donatedBytes"] == 0


def test_a_donating_oom_rebuilds_from_the_host_origin():
    """An OOM in a donating dispatch after its input was consumed: the
    ladder rebuilds the batch from the host origin and the answer holds."""
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.memory import retry
    from spark_rapids_tpu_torch.session import TorchSession
    retry.reset_retry_state()
    t = _arrow(200, 5).select(["a", "b"])
    clean = _donating_query(F, TorchSession(device="cpu").create_dataframe(
        t)).collect()
    sess = TorchSession({**_DONATE, "spark.rapids.tpu.faults.enabled": True,
                         "spark.rapids.tpu.faults.spec":
                             "alloc.jit:times=1:action=oom"}, device="cpu")
    got = _donating_query(F, sess.create_dataframe(t)).collect()
    faults.reset_faults()
    assert got.equals(clean)
    s = retry.retry_stats()
    assert s["oom_rematerializations"] >= 1 or s["oom_splits"] >= 1
