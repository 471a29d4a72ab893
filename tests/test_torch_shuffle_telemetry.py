"""The port's shuffle observatory (shuffle/telemetry.py) against the JAX
package's, in the cases of the JAX package's tests/test_shuffle_observatory.py
(the zero-overhead pin, the bounded ring over exact aggregates, the
straggler, the stitch, the TCP tier's notes) and at the tiers' sites: the
manager's transport and cached tiers and the device exchanges, whose
enqueue bytes equal the ``shuffleBytes`` metric (the DCN tier's notes:
tests/test_torch_dcn.py).

Tolerances: none; counts and bytes equal, walls only ordered."""
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.shuffle import telemetry as jtelemetry
from spark_rapids_tpu.shuffle.tcp import TcpShuffleTransport as JTcp
from spark_rapids_tpu.utils.tracing import (TraceContext,
                                            activate_trace_context)

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.shuffle import telemetry
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.shuffle.tcp import TcpShuffleTransport
from spark_rapids_tpu_torch.shuffle.transport import (BlockId,
                                                      LocalShuffleTransport)

_CPU = torch.device("cpu")
_ON = {"spark.rapids.tpu.shuffle.telemetry.enabled": True}


@pytest.fixture
def observatory():
    obs = telemetry.configure_shuffle_telemetry(RapidsConf(_ON))
    yield obs
    telemetry.reset_shuffle_telemetry()


def test_zero_overhead_when_off_bytecode_pin():
    telemetry.reset_shuffle_telemetry()
    for fn in (telemetry.clock, telemetry.note_transfer):
        assert fn.__code__.co_names[0] == "_OBSERVATORY", fn.__name__
    assert telemetry.active() is None
    telemetry.note_transfer("ici", "dispatch", shuffle_id=0,
                            logical_bytes=lambda: 1 / 0)  # never called
    assert telemetry.clock() == 0.0
    assert telemetry.drain_ring() == []
    assert telemetry.query_summary(0) is None
    assert telemetry.shuffle_telemetry_stats() == {}
    assert telemetry.configure_shuffle_telemetry(RapidsConf({})) is None


def _notes():
    """One sequence of notes over every tier, query and phase."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(100):
        tier = telemetry.TIERS[i % 5]
        out.append(dict(tier=tier, phase=("enqueue", "fetch", "serve")[i % 3],
                        shuffle_id=i % 3, map_id=i % 2, partition=i % 4,
                        logical_bytes=int(rng.integers(0, 1000)),
                        wire_bytes=int(rng.integers(0, 1000)),
                        retries=i % 2, queue_depth=i % 7, query_id=i % 2))
    return out


def _strip_walls(x):
    if isinstance(x, dict):
        return {k: _strip_walls(v) for k, v in x.items()
                if not k.endswith("wall_s") and k != "phases"}
    if isinstance(x, list):
        return [_strip_walls(v) for v in x]
    return x


def test_ring_bound_and_exact_aggregates_equal_the_jax_observatory():
    """The same 100 notes into a 16-event ring of each package: 16 events
    kept, every total and per-query, per-tier and per-shuffle aggregate
    equal to the JAX observatory's (walls aside: none is timed)."""
    conf = {**_ON, "spark.rapids.tpu.shuffle.telemetry.ringSize": 16}
    mine = telemetry.configure_shuffle_telemetry(RapidsConf(conf))
    theirs = jtelemetry.configure_shuffle_telemetry(JConf(conf))
    try:
        for n in _notes():
            mine.note(**n)
            theirs.note(**n)
        assert len(mine.drain_ring()) == len(theirs.drain_ring()) == 16
        assert mine.totals() == theirs.totals()
        assert mine.totals()["transfers"] == 100
        assert _strip_walls(mine.tier_aggregate()) == \
            _strip_walls(theirs.tier_aggregate())
        for q in (0, 1):
            assert _strip_walls(mine.query_summary(q)) == \
                _strip_walls(theirs.query_summary(q))
        assert mine.query_summary(0)["totals"]["transfers"] == 0  # drained
    finally:
        telemetry.reset_shuffle_telemetry()
        jtelemetry.reset_shuffle_telemetry()


def test_straggler_slowest_partition_vs_p50(observatory):
    for p, wall in ((0, 0.01), (1, 0.01), (2, 0.012), (3, 0.1)):
        observatory.note("transport", "fetch", shuffle_id=9, partition=p,
                         t0=time.perf_counter() - wall, query_id=5)
    st = observatory.query_summary(5)["straggler"]
    assert st["worst"] == {"shuffle_id": 9, "partition": 3,
                           "tier": "transport",
                           "wall_s": pytest.approx(st["slowest_wall_s"])}
    assert st["slowest_wall_s"] == pytest.approx(0.1, rel=0.3)
    assert st["skew"] == pytest.approx(st["slowest_wall_s"]
                                       / st["p50_wall_s"])
    assert st["skew"] > 4


def test_the_stitch_pairs_two_halves_as_the_jax_observatory(observatory):
    for side, wall in (("send", 0.01), ("recv", 0.02)):
        observatory.note("transport", "serve" if side == "send" else "recv",
                         shuffle_id=3, map_id=1, partition=2, wire_bytes=64,
                         t0=time.perf_counter() - wall, side=side,
                         trace_id="0123456789abcdef", query_id=42)
    (pair,) = observatory.stitched()
    assert (pair["shuffle_id"], pair["map_id"], pair["partition"]) == \
        (3, 1, 2)
    assert pair["send_bytes"] == pair["recv_bytes"] == 64
    assert observatory.query_summary(42)["totals"]["stitched"] == 1


@pytest.mark.parametrize("client", ["port", "jax"])
def test_the_tcp_tier_notes_its_phases(observatory, client):
    """A port server fetched by a port client notes connect, send, recv and
    serve; a JAX client's traced header reaches the port server, which
    serves it (the port's half carries no trace id, so nothing
    stitches)."""
    a = TcpShuffleTransport(RapidsConf({
        "spark.rapids.tpu.shuffle.tcp.chunkBytes": 4096}))
    b = TcpShuffleTransport() if client == "port" else JTcp(JConf({}))
    try:
        b.add_peer(*a.address)
        payload = bytes(range(256)) * 64
        a.publish(BlockId(3, 1, 2), payload)
        with activate_trace_context(TraceContext("0123456789abcdef", 1,
                                                 query_id=42)):
            got = dict(b.fetch([BlockId(3, 1, 2)]))
        assert got[BlockId(3, 1, 2)] == payload
        ring = observatory.drain_ring()
        serve = [e for e in ring if e["phase"] == "serve"]
        assert sum(e["wire_bytes"] for e in serve) == len(payload)
        assert len(serve) == 4     # 16 KiB in 4 KiB windows
        if client == "port":
            assert {"connect", "send", "recv"} <= {e["phase"] for e in ring}
            assert sum(e["wire_bytes"] for e in ring
                       if e["phase"] == "recv") == len(payload)
        assert observatory.stitched() == []
    finally:
        a.close()
        b.close()


def _batch(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return DeviceTable.from_host(HostTable.from_arrow(pa.table({
        "k": rng.integers(0, 10, n), "v": rng.uniform(0, 1, n)})), 8, _CPU)


@pytest.mark.parametrize("tier", ["cached", "transport"])
def test_the_managers_tiers_note_every_block(observatory, tier):
    """One map task into 4 partitions and the 4 reads: each block noted
    once at publish (and serialize) and once at fetch (and deserialize),
    the wire bytes the block sizes the writer returned."""
    conf = RapidsConf({"spark.rapids.tpu.shuffle.cacheWrites":
                       "on" if tier == "cached" else "off",
                       "spark.rapids.shuffle.compression.codec": "lz4"})
    mgr = ShuffleManager(conf, LocalShuffleTransport(), _CPU)
    sizes = mgr.write_partition(0, 0, iter([_batch()]), ["k"], 4)
    for p in range(4):
        list(mgr.read_partition(0, 1, p, 8))
    ring = observatory.drain_ring()
    assert {e["tier"] for e in ring} == {tier}
    by_phase = {}
    for e in ring:
        by_phase.setdefault(e["phase"], []).append(e)
    want = {"publish", "fetch"} | ({"serialize", "deserialize"}
                                   if tier == "transport" else set())
    assert set(by_phase) == want
    for phase in want:
        assert sorted(e["partition"] for e in by_phase[phase]) == \
            [0, 1, 2, 3]
    assert sum(e["wire_bytes"] for e in by_phase["publish"]) == sum(sizes)
    assert sum(e["wire_bytes"] for e in by_phase["fetch"]) == sum(sizes)


def test_the_device_exchanges_enqueue_their_shuffle_bytes(observatory):
    """Q1 on a 2-shard virtual mesh (its exchange across the mesh) and on
    the local tier: the ici enqueue bytes equal the exchange's
    ``shuffleBytes`` metric, a dispatch is noted for each chunk, and the
    local tier notes each batch it forwards."""
    from spark_rapids_tpu_torch.exec.exchange import (SHUFFLE_BYTES,
                                                      TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
    from spark_rapids_tpu_torch.plan.aqe import walk_plan
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    tables = tpch.gen_all(0, tiny=True)
    conf = {**_ON, "spark.rapids.tpu.aqe.enabled": False,
            "spark.rapids.tpu.mesh.stageExecution.enabled": False,
            "spark.rapids.tpu.batchRowsMinBucket": 8}
    sess = TorchSession(conf, device="cpu").attach_mesh(
        virtual_mesh(2, "cpu"))
    obs = telemetry.active()
    q = tpch.q1(tpch.build_dataframes(sess, tables, 2))
    plan = sess._physical(q.logical)
    for p in range(plan.num_partitions):
        list(plan.execute(p))
    exchanges = [n for n in walk_plan(plan)
                 if isinstance(n, TpuShuffleExchangeExec)]
    assert exchanges
    ring = obs.drain_ring()
    for ex in exchanges:
        mine = [e for e in ring if e["shuffle_id"] == ex.telemetry_sid
                and e["tier"] == "ici"]
        assert sum(e["logical_bytes"] for e in mine
                   if e["phase"] == "enqueue") == ex.metrics[SHUFFLE_BYTES]
        assert sum(e["phase"] == "dispatch" for e in mine) == \
            sum(e["phase"] == "enqueue" for e in mine) > 0
    local = TorchSession(conf, device="cpu")
    obs = telemetry.active()
    q = tpch.q1(tpch.build_dataframes(local, tables, 2))
    q.collect()
    ring = obs.drain_ring()
    enq = [e for e in ring if (e["tier"], e["phase"]) == ("local",
                                                          "enqueue")]
    assert enq and all(e["logical_bytes"] > 0 for e in enq)
