"""The port's TCP shuffle transport (shuffle/tcp.py) against the JAX
package's, in one process on localhost: the cases of the JAX package's
tests/test_process_cluster.py (round trip, chunked spill-backed serving,
the inflight budget) and tests/test_faults.py (retries, give-ups, misses,
lazy providers), and the wire between the two packages in both directions
(a JAX client, traced and untraced, against a port server; a port client
against a JAX server), with chunked windows and a spilled store. Then the
port's ``ShuffleManager`` over two TCP transports with each codec, against
the JAX manager's partitions.

Tolerances: none; blocks are compared byte for byte, rows exactly."""
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from harness import assert_tables_equal
from spark_rapids_tpu.columnar.device import DeviceTable as JTable
from spark_rapids_tpu.columnar.host import HostTable as JHost
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.shuffle.manager import ShuffleManager as JManager
from spark_rapids_tpu.shuffle.tcp import TcpShuffleTransport as JTcp
from spark_rapids_tpu.shuffle.transport import \
    LocalShuffleTransport as JLocal
from spark_rapids_tpu.utils.tracing import (TraceContext,
                                            activate_trace_context)

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_table,
                                                       serialize_table)
from spark_rapids_tpu_torch.shuffle.tcp import (TcpShuffleTransport,
                                                _HostBlockStore)
from spark_rapids_tpu_torch.shuffle.transport import (
    BlockId, LocalShuffleTransport, ShuffleFetchFailedException)
from spark_rapids_tpu_torch.utils import faults

_CPU = torch.device("cpu")
_SMALL = {"spark.rapids.tpu.shuffle.tcp.chunkBytes": 64 * 1024,
          "spark.rapids.tpu.shuffle.host.storeBytes": 300 * 1024,
          "spark.rapids.shuffle.transport.maxReceiveInflightBytes":
          700 * 1024}


@pytest.fixture(autouse=True)
def _pristine_faults():
    faults.reset_faults()
    faults.reset_recovery()
    yield
    faults.reset_faults()
    faults.reset_recovery()


def _faults(spec):
    faults.configure_faults(RapidsConf({
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.seed": 7,
        "spark.rapids.tpu.faults.spec": spec}))


def _table(vals, keys=None):
    data = {"v": pa.array(np.asarray(vals, dtype=np.int64))}
    if keys is not None:
        data = {"k": pa.array(np.asarray(keys, dtype=np.int64)), **data}
    return HostTable.from_arrow(pa.table(data))


def _pair(server_cls, server_conf, client_cls, client_conf):
    a, b = server_cls(server_conf), client_cls(client_conf)
    b.add_peer(*a.address)
    return a, b


def test_tcp_transport_roundtrip_and_fetch_failed():
    a, b = _pair(TcpShuffleTransport, None, TcpShuffleTransport, None)
    try:
        a.publish(BlockId(7, 0, 0), serialize_table(_table([1, 2, 3])))
        b.publish(BlockId(7, 1, 0), serialize_table(_table([4])))
        got = dict(b.fetch([BlockId(7, 0, 0), BlockId(7, 1, 0)]))
        assert deserialize_table(got[BlockId(7, 0, 0)]) \
            .column("v").values.tolist() == [1, 2, 3]
        assert deserialize_table(got[BlockId(7, 1, 0)]) \
            .column("v").values.tolist() == [4]
        with pytest.raises(ShuffleFetchFailedException):
            list(b.fetch([BlockId(7, 9, 9)]))
        assert a.bytes_published > 0 and b.bytes_fetched > 0
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("server,client,traced", [
    ("port", "jax", False), ("port", "jax", True), ("jax", "port", False)])
def test_the_wire_is_the_jax_packages(server, client, traced):
    """Six 256 KiB blocks through a 300 KiB store (most of them spilled to
    disk), served in 64 KiB windows under a 700 KiB receive budget, between
    a port and a JAX transport: every block arrives byte for byte, a
    removed shuffle answers "not found", and the server's store spilled."""
    port_conf, jax_conf = RapidsConf(_SMALL), JConf(_SMALL)
    classes = {"port": (TcpShuffleTransport, port_conf),
               "jax": (JTcp, jax_conf)}
    a, b = _pair(*classes[server], *classes[client])
    try:
        rng = np.random.default_rng(0)
        payloads = {m: rng.integers(0, 256, 256 * 1024, dtype=np.uint8)
                    .tobytes() for m in range(6)}
        for m, p in payloads.items():
            a.publish(BlockId(5, m, 0), p)
        assert a.store.spilled_blocks >= 4
        assert a.store.mem_bytes <= 300 * 1024 + 256 * 1024
        blocks = [BlockId(5, m, 0) for m in range(6)]
        if traced:
            with activate_trace_context(
                    TraceContext("0123456789abcdef", 1, query_id=3)):
                got = dict(b.fetch(blocks))
        else:
            got = dict(b.fetch(blocks))
        for m, p in payloads.items():
            assert got[BlockId(5, m, 0)] == p, f"block {m} differs"
        assert 0 < b.inflight.peak <= 700 * 1024
        a.publish(BlockId(6, 0, 0), b"tiny")
        a.remove_shuffle(5)
        with pytest.raises(Exception) as e:
            list(b.fetch([BlockId(5, 0, 0)]))
        assert type(e.value).__name__ == "ShuffleFetchFailedException"
        assert dict(b.fetch([BlockId(6, 0, 0)]))[BlockId(6, 0, 0)] == b"tiny"
    finally:
        a.close()
        b.close()


def test_a_fetch_failure_releases_the_inflight_budget():
    conf = RapidsConf({
        "spark.rapids.tpu.shuffle.tcp.chunkBytes": 8 * 1024,
        "spark.rapids.shuffle.transport.maxReceiveInflightBytes": 64 * 1024})
    a, b = _pair(TcpShuffleTransport, conf, TcpShuffleTransport, conf)
    try:
        a.publish(BlockId(3, 1, 0), b"x" * 30000)
        with pytest.raises(ShuffleFetchFailedException):
            list(b.fetch([BlockId(3, 0, 0), BlockId(3, 1, 0)]))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with b.inflight._cv:
                if b.inflight._used == 0:
                    break
            time.sleep(0.05)
        with b.inflight._cv:
            assert b.inflight._used == 0
        assert dict(b.fetch([BlockId(3, 1, 0)]))[BlockId(3, 1, 0)] \
            == b"x" * 30000
    finally:
        a.close()
        b.close()


def test_transient_socket_errors_retry_to_the_same_bytes():
    conf = RapidsConf({"spark.rapids.tpu.shuffle.tcp.retryBackoffMs": 5,
                       "spark.rapids.tpu.shuffle.tcp.retryMaxBackoffMs": 20})
    a, b = _pair(TcpShuffleTransport, conf, TcpShuffleTransport, conf)
    try:
        payload = serialize_table(_table([1, 2, 3], [0, 1, 2]))
        a.publish(BlockId(5, 0, 0), payload)
        _faults("tcp.connect:times=1;tcp.read:times=1")
        assert dict(b.fetch([BlockId(5, 0, 0)]))[BlockId(5, 0, 0)] == payload
        counters = faults.recovery_counters()
        assert counters["transport_retries"] >= 2
        assert counters["transport_giveups"] == 0
        assert faults.active().counters()["tcp.connect"]["fires"] == 1
        assert faults.active().counters()["tcp.read"]["fires"] == 1
    finally:
        a.close()
        b.close()


def test_exhausted_retries_are_a_fetch_failure_and_a_miss_is_not_retried():
    conf = RapidsConf({"spark.rapids.tpu.shuffle.tcp.retryAttempts": 2,
                       "spark.rapids.tpu.shuffle.tcp.retryBackoffMs": 5,
                       "spark.rapids.tpu.shuffle.tcp.retryMaxBackoffMs": 10})
    a, b = _pair(TcpShuffleTransport, conf, TcpShuffleTransport, conf)
    try:
        with pytest.raises(ShuffleFetchFailedException):
            list(b.fetch([BlockId(9, 9, 9)]))
        assert faults.recovery_counters()["transport_retries"] == 0
        a.publish(BlockId(6, 0, 0), serialize_table(_table([1], [0])))
        _faults("tcp.connect")   # every attempt
        with pytest.raises(ShuffleFetchFailedException):
            list(b.fetch([BlockId(6, 0, 0)]))
        assert faults.recovery_counters()["transport_giveups"] >= 1
    finally:
        a.close()
        b.close()


def test_a_lazy_provider_is_bounded_and_a_recovered_one_forgiven():
    store = _HostBlockStore(1 << 20, max_provider_retries=3)
    block = BlockId(1, 0, 0)
    calls = []

    def bad():
        calls.append(1)
        raise RuntimeError("serialization keeps failing")

    store.put_lazy(block, bad)
    for _ in range(5):
        try:
            store.length(block)
        except RuntimeError:
            continue
    assert len(calls) == 3
    assert store.length(block) is None and len(calls) == 3
    good, state = BlockId(1, 1, 0), {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient")
        return b"payload"

    store.put_lazy(good, flaky)
    with pytest.raises(RuntimeError):
        store.length(good)
    assert store.length(good) == len(b"payload")
    assert good not in store._provider_retries
    assert store.lazy_depth() == 0


def _key_table(n=300, seed=4):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n)),
        "v": pa.array(rng.uniform(0, 1, n)),
        "s": pa.array([f"s{i % 7}" if i % 11 else None for i in range(n)])})


@pytest.mark.parametrize("codec", ["none", "zlib", "lz4"])
def test_the_manager_over_tcp_equals_the_jax_manager(codec):
    """Two map tasks written by one port manager on its TCP transport,
    each reduce partition read by a second manager on another transport
    (fetched over the socket): the rows of each partition are the JAX
    manager's, and the blocks' codec is the one asked for."""
    conf = RapidsConf({"spark.rapids.shuffle.compression.codec": codec})
    wt, rt = _pair(TcpShuffleTransport, conf, TcpShuffleTransport, conf)
    try:
        writer = ShuffleManager(conf, wt, _CPU)
        reader = ShuffleManager(conf, rt, _CPU)
        assert not writer.cache_writes and writer.codec == codec
        srcs = [_key_table(300, m) for m in range(2)]
        for m, src in enumerate(srcs):
            writer.write_partition(0, m, iter([DeviceTable.from_host(
                HostTable.from_arrow(src), 8, _CPU)]), ["k"], 4)
        jmgr = JManager(transport=JLocal())
        for m, src in enumerate(srcs):
            jmgr.write_partition(0, m, iter([JTable.from_host(
                JHost.from_arrow(src), min_bucket=8)]), ["k"], 4)
        total = 0
        for p in range(4):
            mine = [b.to_host().to_arrow()
                    for b in reader.read_partition(0, 2, p, 8)]
            want = [b.to_host().to_arrow()
                    for b in jmgr.read_partition(0, 2, p, min_bucket=8)]
            rows = sum(t.num_rows for t in mine)
            assert rows == sum(t.num_rows for t in want)
            total += rows
            if rows:
                assert_tables_equal(pa.concat_tables(mine),
                                    pa.concat_tables(want))
        assert total == 600
        frame = wt.store.read(BlockId(0, 0, 0), 0, 12)
        assert frame[:4] == b"SRTT"
        assert int.from_bytes(frame[8:12], "little") == \
            {"none": 0, "zlib": 1, "lz4": 2}[codec]
    finally:
        wt.close()
        rt.close()


def test_zstd_takes_lz4_as_in_the_jax_package():
    conf = RapidsConf({"spark.rapids.shuffle.compression.codec": "ZSTD"})
    assert ShuffleManager(conf, LocalShuffleTransport(), _CPU).codec == "lz4"
    assert JManager(JConf({"spark.rapids.shuffle.compression.codec":
                           "zstd"}), JLocal()).codec == "lz4"

