"""The port's spill catalog against the JAX package's, on the same numpy
batches handed to both engines: one sequence of registrations, pins,
restores and closes under the same device and host limits moves the same
buffers between the same tiers, with equal spill counts and bytes, equal
device, host and disk use, in both disk modes; the spilled planes are the
same arrays under the same keys; every restore gives the table back plane
for plane; a corrupted spill file raises ``SpillCorruptionError``. Then the
spill queue's pop order against the JAX package's native queue, the
configuration keys the catalog reads, and the upload cache's OOM hook."""
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu import native as jnative
from spark_rapids_tpu.memory import catalog as jcatalog
from spark_rapids_tpu.memory import stores as jstores

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory import stores as tstores
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   SpillPriorities)
from spark_rapids_tpu_torch.memory.stores import (SpillCorruptionError,
                                                  StorageTier)

from test_torch_joins import _assert_planes_equal, _payload, _tables

_CAP = 64


def _pair(seed: int):
    """The same batch as (port table, JAX table): a double, an int32 with
    nulls and a string column, some rows masked off."""
    rng = np.random.default_rng(seed)
    row_mask = rng.random(_CAP) < 0.8
    return _tables(["d", "i", "s"], _payload(rng, _CAP), row_mask)


def _assert_tables_equal(a, b):
    """Two port tables, plane for plane."""
    assert a.names == b.names and a.capacity == b.capacity
    assert torch.equal(a.row_mask, b.row_mask)
    assert int(a.num_rows) == int(b.num_rows) and a.num_rows.dim() == 0
    for x, y in zip(a.columns, b.columns):
        assert x.dtype == y.dtype and x.all_valid == y.all_valid
        assert torch.equal(x.data, y.data) and torch.equal(x.validity,
                                                           y.validity)
        assert (x.lengths is None) == (y.lengths is None)
        if x.lengths is not None:
            assert torch.equal(x.lengths, y.lengths)


def _state(cat, handles) -> dict:
    """Everything the two catalogs must agree on."""
    s = cat.stats()
    return {"tiers": [cat.tier_of(h.buffer_id)
                      if h is not None and h.buffer_id in cat._buffers
                      else None for h in handles],
            "spill_count": s["spill_count"],
            "spilled_bytes": s["spilled_bytes"],
            "device_used": s["device_used"], "host_used": s["host_used"],
            "disk_used": s["disk_used"],
            "peak": s["peak_device_bytes"]}


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
def test_tier_moves_and_counters_equal_jax(tmp_path, direct, checksum):
    pairs = [_pair(seed) for seed in range(5)]
    size = pairs[0][0].nbytes()
    assert all(p.nbytes() == size == j.nbytes() for p, j in pairs)
    device_limit, host_limit = int(2.5 * size), int(1.5 * size)
    tcat = BufferCatalog(RapidsConf({
        "spark.rapids.tpu.memory.disk.direct": direct,
        "spark.rapids.tpu.memory.disk.checksum": checksum}),
        device_limit=device_limit, host_limit=host_limit,
        disk_dir=str(tmp_path / "port"))
    jcat = jcatalog.BufferCatalog(device_limit=device_limit,
                                  host_limit=host_limit,
                                  disk_dir=str(tmp_path / "jax"))
    jcat.disk.direct, jcat.disk.checksum = direct, checksum
    th, jh = [], []

    def both(fn):
        fn(tcat, th, 0)
        fn(jcat, jh, 1)
        assert _state(tcat, th) == _state(jcat, jh)

    prios = [SpillPriorities.INPUT, SpillPriorities.BROADCAST,
             SpillPriorities.INPUT, SpillPriorities.ACTIVE_ON_DECK,
             SpillPriorities.INPUT]

    def register(i):
        return lambda cat, hs, side: hs.append(
            cat.register(pairs[i][side], prios[i]))
    for i in range(3):
        both(register(i))
    assert th[0].tier == StorageTier.HOST  # the oldest INPUT went first
    # with buffer 1 pinned, registering 3 spills 2, and 0 goes to disk
    with th[1], jh[1]:
        both(register(3))
    assert th[0].tier == StorageTier.DISK
    assert th[2].tier == StorageTier.HOST
    assert th[1].tier == StorageTier.DEVICE
    # restores: from disk, then from host, each spilling in turn
    for i in (0, 2, 1):
        both(lambda cat, hs, side, i=i: hs[i].get())
        _assert_tables_equal(th[i].get(), pairs[i][0])
    both(register(4))
    for i in (3, 0):
        both(lambda cat, hs, side, i=i: hs[i].close())
        th[i] = jh[i] = None
    for i in (4, 1, 2):
        both(lambda cat, hs, side, i=i: hs[i].get())
        _assert_planes_equal(th[i].get(), jh[i].get())
    assert sum(tcat.spill_count.values()) >= 6
    assert tcat.spill_count[StorageTier.DISK] >= 2
    for i in (1, 2, 4):
        both(lambda cat, hs, side, i=i: hs[i].close())
    tcat.assert_no_leaks()
    assert tcat.stats()["device_used"] == tcat.stats()["host_used"] == 0
    assert tcat.disk.used_bytes == 0
    assert not any(os.scandir(tcat.disk.dir))


@pytest.mark.parametrize("direct", [True, False])
def test_spilled_planes_equal_jax_and_restore_plane_for_plane(tmp_path,
                                                              direct):
    port, jt = _pair(7)
    arrays, meta = tstores._table_to_host_arrays(port)
    jarrays, _ = jstores._table_to_host_arrays(jt)
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], np.asarray(jarrays[k]))
        assert arrays[k].dtype == np.asarray(jarrays[k]).dtype, k
    _assert_tables_equal(tstores._host_arrays_to_table(arrays, meta), port)
    # the disk tier: the same files, restored to the same table
    stored = tstores.StoredTable(0, None, 0, port.nbytes())
    stored.host_arrays, stored.meta = arrays, meta
    disk = tstores.DiskStore(str(tmp_path / "port"), direct=direct)
    disk.put(stored)
    jstored = jstores.StoredTable(0, None, 0, jt.nbytes())
    jstored.host_arrays = jarrays
    jdisk = jstores.DiskStore(str(tmp_path / "jax"), direct=direct)
    jdisk.put(jstored)
    assert disk.used_bytes == jdisk.used_bytes > 0
    loaded, jloaded = disk.load(stored), jdisk.load(jstored)
    assert sorted(loaded) == sorted(jloaded)
    for k in loaded:
        np.testing.assert_array_equal(loaded[k], jloaded[k])
    _assert_tables_equal(tstores._host_arrays_to_table(loaded, meta), port)


@pytest.mark.parametrize("direct", [True, False])
def test_corrupt_spill_file_raises(tmp_path, direct):
    """A byte flipped in a spilled file after its checksum was recorded:
    the restore raises, it never serves the bytes."""
    port, _ = _pair(3)
    size = port.nbytes()
    cat = BufferCatalog(RapidsConf({
        "spark.rapids.tpu.memory.disk.direct": direct}),
        device_limit=size, host_limit=size // 2,
        disk_dir=str(tmp_path))
    h = cat.register(port)
    cat.register(_pair(4)[0])  # spills h straight to disk
    assert h.tier == StorageTier.DISK
    path = cat._buffers[h.buffer_id].disk_path
    if direct:
        path = os.path.join(path, "col0.data.npy")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(path) // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(SpillCorruptionError, match="crc32"):
        h.get()


def test_spill_queue_pops_in_the_jax_order():
    """Random pushes, removals and pops: the port's heap and the JAX
    package's native queue give the same (priority, payload) sequence,
    equal priorities oldest first."""
    rng = np.random.default_rng(0)
    ours, theirs = tcatalog._SpillQueue(), jnative.HashedPriorityQueue()
    handles = []
    popped = []
    for step in range(2000):
        op = rng.random()
        if op < 0.55:
            p, payload = int(rng.integers(0, 4)) * 10, step
            handles.append((ours.push(p, payload), theirs.push(p, payload)))
        elif op < 0.7 and handles:
            a, b = handles.pop(int(rng.integers(0, len(handles))))
            assert ours.remove(a) == theirs.remove(b)
        else:
            got, want = ours.pop(), theirs.pop()
            assert got == want
            popped.append(got)
        assert len(ours) == len(theirs)
    assert len(popped) > 400 and None in popped
    while len(theirs):
        assert ours.pop() == theirs.pop()
    assert ours.pop() is None


def test_catalog_reads_its_configuration_keys():
    size = _pair(0)[0].nbytes()
    cat = BufferCatalog(RapidsConf({
        "spark.rapids.memory.host.spillStorageSize": 12345,
        "spark.rapids.tpu.memory.disk.direct": False,
        "spark.rapids.tpu.memory.disk.checksum": False}))
    assert cat.host.limit_bytes == 12345
    assert not cat.disk.direct and not cat.disk.checksum
    # no CUDA device to ask: the JAX package's 8 GiB, times allocFraction
    assert cat.device.limit_bytes == int(8 * 1024 ** 3 * 0.9)
    assert BufferCatalog(device=torch.device("cpu")).device.limit_bytes \
        == int(8 * 1024 ** 3 * 0.9)
    # oomSpill off: a registration over the budget spills nothing
    off = BufferCatalog(RapidsConf({
        "spark.rapids.memory.gpu.oomSpill.enabled": False}),
        device_limit=size)
    hs = [off.register(_pair(i)[0]) for i in range(3)]
    assert all(h.tier == StorageTier.DEVICE for h in hs)
    assert off.device.used_bytes == 3 * size


def test_oom_callback_failure_is_recorded_and_spill_continues():
    cat = BufferCatalog(device_limit=1 << 20, host_limit=1 << 20)
    h = cat.register(_pair(1)[0])

    def bad_callback():
        raise RuntimeError("boom from cache dropper")
    cat.register_oom_callback(bad_callback)
    with pytest.warns(RuntimeWarning, match="OOM callback .* failed"):
        freed = cat.handle_device_oom("unit test")
    assert freed == h.catalog._buffers[h.buffer_id].size_bytes
    assert h.tier == StorageTier.HOST
    assert cat.oom_callback_errors == 1 and cat.oom_events == 1
    assert any("boom from cache dropper" in d for d in cat.diagnostics)
    assert cat.counters()["oom_callback_errors"] == 1


def test_catalog_accounts_external_device_bytes():
    cat = BufferCatalog(device_limit=1 << 20, host_limit=1 << 20)
    cat.register_external_bytes("upload_cache_test", lambda: 1234)
    assert cat.external_device_bytes() == 1234
    assert cat.device_in_use_bytes() == cat.device.used_bytes + 1234
    assert cat.peak_device_bytes >= 1234
    assert cat.stats()["external_bytes"]["upload_cache_test"] == 1234
    cat.register_external_bytes("broken", lambda: 1 / 0)
    assert cat.external_device_bytes() == 1234


def test_device_oom_empties_the_upload_cache_and_reports_its_bytes():
    """The upload cache registers with the process catalog when it caches
    an upload: ``handle_device_oom`` drops it and counts its bytes among
    those freed, as the JAX package's hook does."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import transitions as T
    from spark_rapids_tpu_torch.expr import functions as F
    from spark_rapids_tpu_torch.session import TorchSession
    T.clear_upload_cache()
    cat = BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
    tcatalog.set_catalog(cat)
    try:
        sess = TorchSession(device="cpu")
        df = sess.create_dataframe(pa.table({"a": np.arange(5000.0)}),
                                   num_partitions=2)
        df.filter(F.col("a") > F.lit(1.0)).collect()
        cached = T.upload_cache_stats()["bytes"]
        assert cached > 0 and T.upload_cache_stats()["entries"] == 2
        assert cat.external_device_bytes() == cached
        assert cat.peak_device_bytes >= cached
        assert cat.handle_device_oom("unit test") == cached
        assert T.upload_cache_stats()["bytes"] == 0
        assert T.upload_cache_stats()["entries"] == 0
        assert cat.external_device_bytes() == 0
    finally:
        tcatalog.set_catalog(None)
        T.clear_upload_cache()
