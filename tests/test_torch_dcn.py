"""The port's DCN tier (shuffle/dcn.py) and broadcast manager
(shuffle/broadcast.py) in one process, against the JAX package's: the mock
fabric's device-to-device moves (the case of the JAX package's
tests/test_shuffle.py:176), the TCP DCN tier's lazy serialisation, its
fault points and observatory notes, a JAX DCN client fetching from a port
DCN server, and a broadcast built once and fetched by another executor.

Tolerances: none; rows and bytes equal."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceTable as JTable
from spark_rapids_tpu.columnar.host import HostTable as JHost
from spark_rapids_tpu.shuffle.dcn import DcnShuffleTransport as JDcn
from spark_rapids_tpu.shuffle.dcn import MockDcnFabric as JFabric
from spark_rapids_tpu.shuffle.dcn import \
    TcpDcnShuffleTransport as JTcpDcn

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   SpillPriorities)
from spark_rapids_tpu_torch.shuffle import telemetry
from spark_rapids_tpu_torch.shuffle.broadcast import BroadcastManager
from spark_rapids_tpu_torch.shuffle.dcn import (DcnShuffleTransport,
                                                MockDcnFabric,
                                                TcpDcnShuffleTransport)
from spark_rapids_tpu_torch.shuffle.tcp import TcpShuffleTransport
from spark_rapids_tpu_torch.shuffle.transport import (
    BlockId, ShuffleFetchFailedException)
from spark_rapids_tpu_torch.utils import faults

_CPU = torch.device("cpu")


def _arrow(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 9, n)),
                     "v": pa.array(rng.normal(size=n)),
                     "s": pa.array([f"r{i}" if i % 5 else None
                                    for i in range(n)])})


def test_the_mock_fabric_moves_device_to_device_as_the_jax_one():
    """A block published on host a lands on host b's device, rows equal to
    the JAX mock's move; the link's bytes are the table's; a missing block
    and the fault hook raise fetch-failed."""
    import jax
    src = _arrow()
    fabric = MockDcnFabric()
    catalog = BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
    a = DcnShuffleTransport(fabric, "host-a", device="cpu", catalog=catalog)
    b = DcnShuffleTransport(fabric, "host-b", device="cpu")
    t = DeviceTable.from_host(HostTable.from_arrow(src), 8, _CPU)
    a.publish_table(BlockId(1, 0, 0), t)
    assert catalog.device.used_bytes == t.nbytes()
    got = dict(b.fetch_tables([BlockId(1, 0, 0)]))[BlockId(1, 0, 0)]
    assert got.device == b.device
    jfabric = JFabric()
    devs = jax.devices()
    ja = JDcn(jfabric, "host-a", device=devs[0])
    jb = JDcn(jfabric, "host-b", device=devs[1])
    ja.publish_table(BlockId(1, 0, 0), JTable.from_host(JHost.from_arrow(src),
                                                        8))
    jgot = dict(jb.fetch_tables([BlockId(1, 0, 0)]))[BlockId(1, 0, 0)]
    assert got.to_host().to_arrow().equals(jgot.to_host().to_arrow())
    assert fabric.link_bytes[("host-a", "host-b")] == t.nbytes()
    assert fabric.transfers == 1
    with pytest.raises(ShuffleFetchFailedException):
        list(b.fetch_tables([BlockId(1, 9, 9)]))
    calls = []

    def fault(src_host, dst_host, blk):
        calls.append(blk)
        raise ShuffleFetchFailedException(blk, "injected DCN fault")
    fabric.fault = fault
    with pytest.raises(ShuffleFetchFailedException, match="injected"):
        list(b.fetch_tables([BlockId(1, 0, 0)]))
    assert calls == [BlockId(1, 0, 0)]
    a.remove_shuffle(1)
    assert catalog.device.used_bytes == 0


@pytest.fixture
def tcp_pair():
    conf = RapidsConf({"spark.rapids.tpu.shuffle.tcp.retryAttempts": 1})
    a = TcpDcnShuffleTransport(conf, "cpu")
    b = TcpDcnShuffleTransport(conf, "cpu")
    b.add_peer(*a.address)
    a.add_peer(*b.address)
    yield a, b
    a.close()
    b.close()
    faults.reset_faults()
    telemetry.reset_shuffle_telemetry()


def test_the_tcp_dcn_tier_serialises_only_when_asked(tcp_pair):
    """A table published on a stays on its device, serialised once when b
    first asks (lz4, the tier's codec), and lands on b's device with a's
    rows; each phase is noted (enqueue, serialize, fetch, deserialize)."""
    a, b = tcp_pair
    obs = telemetry.configure_shuffle_telemetry(RapidsConf({
        "spark.rapids.tpu.shuffle.telemetry.enabled": True}))
    src = _arrow(300, 1)
    t = DeviceTable.from_host(HostTable.from_arrow(src), 8, _CPU)
    a.publish_table(BlockId(7, 0, 0), t)
    assert a.bytes_wired == 0 and a.tcp.store.lazy_depth() == 1
    got = dict(b.fetch_tables([BlockId(7, 0, 0)]))[BlockId(7, 0, 0)]
    assert got.to_host().to_arrow().equals(src)
    assert a.bytes_wired > 0 and a.tcp.store.lazy_depth() == 0
    wired = a.bytes_wired
    dict(b.fetch_tables([BlockId(7, 0, 0)]))
    assert a.bytes_wired == wired    # served from the store, not again
    local = dict(a.fetch_tables([BlockId(7, 0, 0)]))[BlockId(7, 0, 0)]
    assert local is t
    phases = [e["phase"] for e in obs.drain_ring() if e["tier"] == "dcn"]
    assert phases[:4] == ["enqueue", "serialize", "fetch", "deserialize"]
    a.remove_shuffle(7)
    with pytest.raises(ShuffleFetchFailedException):
        list(b.fetch_tables([BlockId(7, 0, 0)]))


def test_the_dcn_fault_points_fire(tcp_pair):
    a, b = tcp_pair
    t = DeviceTable.from_host(HostTable.from_arrow(_arrow()), 8, _CPU)
    faults.configure_faults(RapidsConf({
        "spark.rapids.tpu.faults.enabled": True,
        "spark.rapids.tpu.faults.spec":
        "dcn.publish:times=1;dcn.fetch:times=1"}))
    with pytest.raises(faults.FaultInjectedError, match="dcn.publish"):
        a.publish_table(BlockId(2, 0, 0), t)
    a.publish_table(BlockId(2, 0, 0), t)
    with pytest.raises(faults.FaultInjectedError, match="dcn.fetch"):
        list(b.fetch_tables([BlockId(2, 0, 0)]))
    got = dict(b.fetch_tables([BlockId(2, 0, 0)]))[BlockId(2, 0, 0)]
    assert got.to_host().to_arrow().equals(_arrow())


@pytest.mark.parametrize("codec", ["lz4", "zlib"])
def test_a_jax_dcn_client_fetches_from_a_port_dcn_server(codec):
    """The DCN tier's wire is the JAX package's: a JAX
    ``TcpDcnShuffleTransport`` fetches the port's lazily serialised block
    and reads the port's rows."""
    a = TcpDcnShuffleTransport(None, "cpu", codec=codec)
    b = JTcpDcn()
    try:
        b.add_peer(*a.address)
        src = _arrow(200, 3)
        a.publish_table(BlockId(4, 0, 1), DeviceTable.from_host(
            HostTable.from_arrow(src), 8, _CPU))
        got = dict(b.fetch_tables([BlockId(4, 0, 1)]))[BlockId(4, 0, 1)]
        assert got.to_host().to_arrow().equals(src)
    finally:
        a.close()
        b.close()


def test_a_broadcast_builds_once_and_the_other_executor_fetches():
    """Executor 0 builds and publishes; executor 1 fetches over TCP and
    uploads to its device, registered at broadcast priority; neither runs
    the build twice."""
    conf = RapidsConf({})
    ta, tb = TcpShuffleTransport(conf), TcpShuffleTransport(conf)
    try:
        tb.add_peer(*ta.address)
        cat = BufferCatalog(device_limit=1 << 30, host_limit=1 << 30)
        mine = BroadcastManager(ta, None, 8, "cpu")
        theirs = BroadcastManager(tb, cat, 8, "cpu")
        src = _arrow(40, 5)
        builds = []

        def build():
            builds.append(1)
            return DeviceTable.from_host(HostTable.from_arrow(src), 8, _CPU)
        t0 = mine.build_and_publish(99, build)
        assert mine.build_and_publish(99, build) is t0
        got = theirs.get(99)
        assert got.to_host().to_arrow().equals(src)
        assert theirs.get(99) is got
        assert (mine.builds, mine.fetches) == (1, 0)
        assert (theirs.builds, theirs.fetches) == (0, 1)
        assert builds == [1]
        assert cat.device.used_bytes == got.nbytes()
        with pytest.raises(ShuffleFetchFailedException):
            theirs.get(100)
        assert theirs.get_or_build(100, build).to_host().num_rows == 40
        assert theirs.builds == 1
        theirs.close()
        assert cat.device.used_bytes == 0
        assert SpillPriorities.BROADCAST > SpillPriorities.OUTPUT_FOR_SHUFFLE
    finally:
        ta.close()
        tb.close()
