"""The in-process executor tier: the serializer, the transport, the shuffle
buffer catalog, ``ShuffleManager`` and ``LocalCluster`` (shuffle/ and
parallel/), against the JAX package's (tests/test_shuffle.py's cases) and
the host engine.

Tolerances: serialized round trips and rows exactly, doubles at rel 1e-9
(tests/harness.py)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from harness import assert_tables_equal
from spark_rapids_tpu.columnar.device import DeviceTable as JTable
from spark_rapids_tpu.columnar.host import HostTable as JHost
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.parallel.runtime import LocalCluster as JCluster
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle.manager import ShuffleManager as JManager
from spark_rapids_tpu.shuffle.transport import \
    LocalShuffleTransport as JTransport

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.parallel.executor import FailureDetector
from spark_rapids_tpu_torch.parallel.runtime import (LocalCluster,
                                                     TpuManagedExchangeExec)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_table,
                                                       serialize_table)
from spark_rapids_tpu_torch.shuffle.transport import (
    LocalShuffleTransport, ShuffleFetchFailedException, ShuffleTransport,
    load_transport)
from spark_rapids_tpu_torch.tools import tpch

_CPU = torch.device("cpu")


def _arrow(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 10, n)),
        "v": pa.array(rng.uniform(0, 1, n)),
        "s": pa.array([f"s{i % 7}" if i % 11 else None for i in range(n)]),
        "d": pa.array([None if i % 13 == 0 else (i - 100) * 10**20 + 7
                       for i in range(n)], type=pa.decimal128(30, 2))})


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_serializer_roundtrip(codec):
    t = HostTable.from_arrow(_arrow())
    assert deserialize_table(serialize_table(t, codec)).to_arrow() \
        .equals(t.to_arrow())
    empty = HostTable.from_arrow(_arrow().slice(0, 0))
    assert deserialize_table(serialize_table(empty, codec)).num_rows == 0


def test_lz4_waits_for_the_native_codec():
    """The lz4 codec came with the host native library (it raised until
    then): a frame round-trips and its body is the JAX package's LZ4 block
    of the same raw body."""
    from spark_rapids_tpu import native as jnative
    t = HostTable.from_arrow(_arrow())
    frame = serialize_table(t, "lz4")
    assert deserialize_table(frame).to_arrow().equals(t.to_arrow())
    raw = serialize_table(t, "none")[28:]
    assert frame[28:] == jnative.lz4_compress(raw)


def test_transport_loads_by_the_jax_class_name():
    assert isinstance(load_transport(RapidsConf()), LocalShuffleTransport)
    t = LocalShuffleTransport()
    with pytest.raises(ShuffleFetchFailedException):
        list(t.fetch([(0, 0, 0)]))


class _ReversingTransport(ShuffleTransport):
    """Hands blocks back in reverse order (a protocol mock)."""

    def __init__(self, conf=None):
        self.inner = LocalShuffleTransport()

    def publish(self, block, payload):
        self.inner.publish(block, payload)

    def fetch(self, blocks):
        yield from self.inner.fetch(list(reversed(blocks)))

    def remove_shuffle(self, sid):
        self.inner.remove_shuffle(sid)


def _partitions(mgr, sid, parts, maps=1):
    return [[b.to_host() for b in mgr.read_partition(sid, maps, p, 8)]
            for p in range(parts)]


@pytest.mark.parametrize("tier,codec", [("cached", "none"),
                                        ("transport", "none"),
                                        ("transport", "zlib")])
def test_write_read_equals_the_jax_manager_partition_for_partition(tier,
                                                                   codec):
    """One map task's batch written into 4 partitions and read back: each
    partition holds the JAX manager's rows (the same hash), every key in
    one partition."""
    conf = RapidsConf({
        "spark.rapids.tpu.shuffle.cacheWrites":
        "on" if tier == "cached" else "off",
        "spark.rapids.shuffle.compression.codec": codec})
    mgr = ShuffleManager(conf, _ReversingTransport(), _CPU)
    src = _arrow(200)
    sid = mgr.new_shuffle_id()
    sizes = mgr.write_partition(sid, 0, iter([DeviceTable.from_host(
        HostTable.from_arrow(src.select(["k", "v", "s"])), 8, _CPU)]),
        ["k"], 4)
    assert len(sizes) == 4
    got = _partitions(mgr, sid, 4)
    jmgr = JManager(transport=JTransport())
    jsid = jmgr.new_shuffle_id()
    jmgr.write_partition(jsid, 0, iter([JTable.from_host(JHost.from_arrow(
        src.select(["k", "v", "s"])), min_bucket=8)]), ["k"], 4)
    for p in range(4):
        want = [b.to_host().to_arrow() for b in
                jmgr.read_partition(jsid, 1, p, min_bucket=8)]
        mine = [t.to_arrow() for t in got[p]]
        assert sum(t.num_rows for t in mine) == sum(t.num_rows
                                                    for t in want)
        if want and want[0].num_rows:
            assert_tables_equal(pa.concat_tables(mine),
                                pa.concat_tables(want))
    st = mgr.shuffle_skew_stats(sid)
    assert sum(st["rows"]) == 200
    mgr.unregister_shuffle(sid)


def test_a_lost_block_recomputes_its_map_task_once():
    mgr = ShuffleManager(RapidsConf({"spark.rapids.tpu.shuffle.cacheWrites":
                                     "off"}), LocalShuffleTransport(), _CPU)
    batch = DeviceTable.from_host(HostTable.from_arrow(_arrow(50)), 8, _CPU)
    sid = mgr.new_shuffle_id()
    mgr.write_partition(sid, 0, iter([batch]), ["k"], 2)
    mgr.transport.remove_shuffle(sid)
    calls = []

    def recompute(m):
        calls.append(m)
        mgr.write_partition(sid, m, iter([batch]), ["k"], 2)
    rows = sum(int(b.num_rows) for p in range(2)
               for b in mgr.read_partition(sid, 1, p, 8, recompute))
    assert rows == 50 and calls == [0]
    mgr.transport.remove_shuffle(sid)
    with pytest.raises(ShuffleFetchFailedException):
        list(mgr.read_partition(sid, 1, 0, 8))


def test_the_read_throttle_uploads_in_groups():
    """maxMetadataSize below one block: every fetched block uploads on its
    own, and the rows stay."""
    mgr = ShuffleManager(RapidsConf({
        "spark.rapids.tpu.shuffle.cacheWrites": "off",
        "spark.rapids.shuffle.maxMetadataSize": 1}), None, _CPU)
    sid = mgr.new_shuffle_id()
    for m in range(3):
        mgr.write_partition(sid, m, iter([DeviceTable.from_host(
            HostTable.from_arrow(_arrow(60, m)), 8, _CPU)]), ["k"], 1)
    batches = list(mgr.read_partition(sid, 3, 0, 8))
    assert len(batches) == 3
    assert sum(int(b.num_rows) for b in batches) == 180


def test_failure_detector_declares_a_silent_peer_dead_once():
    now = [0.0]
    det = FailureDetector(timeout_s=5.0, clock=lambda: now[0])
    lost = []
    det.on_peer_lost(lost.append)
    det.on_peer_lost(lambda e: 1 / 0)  # a bad listener stops nothing
    det.heartbeat(1)
    det.heartbeat(2)
    now[0] = 6.0
    det.heartbeat(2)
    assert det.check() == [1] and det.check() == []
    assert lost == [1] and det.live() == [2]
    assert len(det.listener_errors) == 1


@pytest.mark.parametrize("tier,codec", [("cached", "none"),
                                        ("transport", "zlib")])
def test_local_cluster_runs_q1_and_q3_through_the_shuffle_managers(tier,
                                                                   codec):
    """LocalCluster(2): every hash exchange of Q1 and Q3 (AQE on, broadcasts
    off) goes through the executors' shuffle managers; the rows equal the
    host engine's and the single-session run's."""
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 8,
            "spark.rapids.tpu.shuffle.partitions": 4,
            "spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.shuffle.cacheWrites":
            "on" if tier == "cached" else "off",
            "spark.rapids.shuffle.compression.codec": codec}
    sess = TorchSession(conf, device="cpu")
    tables = tpch.gen_all(0, tiny=True)
    with LocalCluster(2, sess.conf, device="cpu") as cluster:
        for name in ("q1", "q3"):
            q = getattr(tpch, name)(tpch.build_dataframes(sess, tables, 2))
            got = cluster.run(q)
            assert_tables_equal(got, q.collect(device=False),
                                ignore_order=False)
            assert_tables_equal(got, q.collect(), ignore_order=False)
        published = [ctx.shuffle for ctx in cluster.executors]
        assert cluster.executors[0].shuffle.buffer_catalog is \
            cluster.executors[1].shuffle.buffer_catalog
    from spark_rapids_tpu_torch.shuffle.manager import shuffle_stats
    st = shuffle_stats()
    assert st["writes_cached_tier" if tier == "cached"
              else "writes_transport_tier"] > 0
    assert published


def test_managed_exchange_is_planned_only_inside_a_cluster_run():
    sess = TorchSession({"spark.rapids.tpu.shuffle.partitions": 4,
                         "spark.rapids.tpu.aqe.enabled": False}, device="cpu")
    q = tpch.q1(tpch.build_dataframes(sess, tpch.gen_all(0, tiny=True), 2))
    assert "TpuManagedExchangeExec" not in sess._physical(q.logical) \
        .tree_string()
    assert TpuManagedExchangeExec.__doc__


@pytest.mark.parametrize("parts", [2, 4, 8, 16])
def test_local_cluster_meets_float_keys_on_one_partition(parts):
    """64 probe rows keyed 0.0, -0.0, NaN and a NaN with payload 0x3039 (16
    of each) joined on ``f == g`` to build rows {0.0, NaN}, broadcasts and
    AQE off: every hash exchange goes through the executors' shuffle
    managers, whose map side hashes floats normalised. The port's
    ``LocalCluster(2)`` gives the JAX cluster's and the host engine's 64
    rows, the payload-NaN rows included."""
    nan_payload = np.array([0x7FF8000000003039], dtype=np.uint64).view(
        np.float64)[0]
    probe = pa.table({"f": np.repeat([0.0, -0.0, np.nan, nan_payload], 16),
                      "a": np.arange(64)})
    build = pa.table({"g": np.array([0.0, np.nan]), "b": np.array([10, 20])})
    conf = {"spark.rapids.tpu.batchRowsMinBucket": 8,
            "spark.rapids.tpu.shuffle.partitions": parts,
            "spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.aqe.enabled": False}
    sess = TorchSession(conf, device="cpu")
    q = sess.create_dataframe(probe, num_partitions=2).join(
        sess.create_dataframe(build, num_partitions=2),
        condition=F.col("f") == F.col("g"))
    with LocalCluster(2, sess.conf, device="cpu") as cluster:
        got = cluster.run(q)
    jsess = TpuSession(conf)
    jq = jsess.create_dataframe(probe, num_partitions=2).join(
        jsess.create_dataframe(build, num_partitions=2),
        condition=JF.col("f") == JF.col("g"))
    with JCluster(2, jsess.conf) as cluster:
        jgot = cluster.run(jq)
    host = q.collect(device=False)
    for table in (got, jgot, host):
        assert sorted(table.column("a").to_pylist()) == list(range(64))
    assert_tables_equal(got, jgot)
    assert_tables_equal(got, host)
