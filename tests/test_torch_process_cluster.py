"""The port's executors as processes (parallel/runtime.py ``ProcessCluster``)
on the CPU, against the JAX package: the cases of the JAX package's
tests/test_process_cluster.py and tests/test_faults.py:495-585. Shuffle
writes and reads across two worker processes over TCP with each codec
(float keys: NaN of two payloads, -0.0 beside 0.0), a broadcast built once,
the DCN tier between workers, TPC-H Q1 fanned over the workers against the
JAX package's ``_query_plan`` rows, with and without an injected worker
kill, the split of a card's budget between its workers, and the executor
tier's default device (the card).

One module-scoped ``ProcessCluster(2, device="cpu")`` serves the shuffle,
broadcast, DCN and query tests; the kill tests start their own. The Q3/Q5
kill matrix and the kill-and-recompute cases are ``slow``, as in the JAX
package.

Tolerances: rows exactly, doubles at rel 1e-9 (tests/harness.py)."""
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from harness import assert_tables_equal

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.parallel.executor import ExecutorContext
from spark_rapids_tpu_torch.parallel.runtime import (
    LocalCluster, ProcessCluster, TaskFailedError, broadcast_build_task,
    broadcast_probe_task, configure_faults_task, dcn_add_peer_task,
    dcn_address_task, dcn_fetch_task, dcn_publish_task, launch_counts_task,
    metrics_text_task, shuffle_read_recompute_task, shuffle_read_task,
    shuffle_write_task, worker_conf, worker_info_task)
from spark_rapids_tpu_torch.shuffle.broadcast import BroadcastManager
from spark_rapids_tpu_torch.shuffle.dcn import (DcnShuffleTransport,
                                                MockDcnFabric,
                                                TcpDcnShuffleTransport)
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_table,
                                                       serialize_table)
from spark_rapids_tpu_torch.shuffle.transport import LocalShuffleTransport
from spark_rapids_tpu_torch.utils import faults

_CPU = torch.device("cpu")
_SHUFFLE = {"spark.rapids.tpu.shuffle.partitions": 2}
_NAN_PAYLOAD = np.array([0x7FF8000000003039], dtype=np.uint64).view(
    np.float64)[0]


@pytest.fixture(scope="module")
def cluster():
    with ProcessCluster(2, {**_SHUFFLE, "spark.rapids.tpu.task.timeout": 240},
                        device="cpu") as c:
        yield c


@pytest.fixture(autouse=True)
def _pristine_faults():
    faults.reset_faults()
    faults.reset_recovery()
    yield
    faults.reset_faults()
    faults.reset_recovery()


def _fault_conf(spec, **extra):
    return {"spark.rapids.tpu.faults.enabled": True,
            "spark.rapids.tpu.faults.seed": 7,
            "spark.rapids.tpu.faults.spec": spec, **extra}


def _float_table(m: int, n: int = 96) -> HostTable:
    """Float keys: 0.0, -0.0, NaN, a NaN of another payload and values."""
    rng = np.random.default_rng(m)
    keys = np.concatenate([np.repeat([0.0, -0.0, np.nan, _NAN_PAYLOAD], 8),
                           rng.integers(0, 20, n - 32).astype(np.float64)])
    return HostTable.from_arrow(pa.table({
        "f": keys, "v": np.arange(n, dtype=np.int64) + 1000 * m}))


def _norm(k: float) -> float:
    return 0.0 if k == 0 else (np.inf if np.isnan(k) else k)


def test_workers_are_processes_on_the_cpu_with_a_split_budget(cluster):
    """Two processes, neither the driver, each on the CPU, each catalog
    holding half the budget of the device they share."""
    infos = [cluster.run_on(w, worker_info_task) for w in range(2)]
    assert {i["device"] for i in infos} == {"cpu"}
    pids = {i["pid"] for i in infos}
    assert len(pids) == 2 and os.getpid() not in pids
    want = int(8 * 1024 ** 3 * 0.9 / 2)
    assert all(abs(i["catalog_budget"] - want) <= 1 for i in infos)
    assert cluster.devices == ["cpu", "cpu"]
    assert set(cluster.startup["workers"]) == {0, 1}
    assert all(w["startup_s"] > 0 for w in cluster.startup["workers"].values())
    assert set(cluster.clock_offsets) == {0, 1}


def test_worker_conf_splits_a_cards_budget_among_its_workers():
    devices = ["cuda:0", "cuda:1", "cuda:0"]
    key = "spark.rapids.memory.gpu.allocFraction"
    assert worker_conf({}, devices, 0)[key] == pytest.approx(0.45)
    assert key not in worker_conf({}, devices, 1)
    capped = worker_conf({"spark.rapids.memory.gpu.maxAllocFraction": 0.5},
                         devices, 2)
    assert capped[key] == pytest.approx(0.25)
    fixed = {"spark.rapids.tpu.memory.pool.size": 1 << 30}
    assert worker_conf(fixed, devices, 0) == fixed


@pytest.mark.parametrize("codec", ["none", "zlib", "lz4"])
def test_a_shuffle_crosses_the_processes_over_tcp(cluster, codec):
    """Map 0 written on worker 0, map 1 on worker 1, every reduce partition
    read on worker 1 (map 0's blocks fetched over the socket): the rows are
    the input's, each float key (0.0 and -0.0; every NaN) in one partition,
    and each partition holds the rows an in-process manager gives it."""
    sid = {"none": 10, "zlib": 11, "lz4": 12}[codec]
    tables = [_float_table(m) for m in range(2)]
    for m in range(2):
        cluster.run_on(m, shuffle_write_task, sid, m,
                       serialize_table(tables[m]), ["f"], 4, codec)
    local = ShuffleManager(RapidsConf({"spark.rapids.tpu.shuffle.cacheWrites":
                                       "off"}), LocalShuffleTransport(), _CPU)
    for m in range(2):
        local.write_partition(sid, m, iter([DeviceTable.from_host(
            tables[m], 8, _CPU)]), ["f"], 4)
    seen, rows = {}, []
    for p in range(4):
        out = cluster.run_on(1, shuffle_read_task, sid, 2, p)
        got = deserialize_table(out).to_arrow() if out is not None \
            else None
        want = [b.to_host().to_arrow() for b in
                local.read_partition(sid, 2, p, 8)]
        want_rows = sum(t.num_rows for t in want)
        assert (got.num_rows if got is not None else 0) == want_rows
        if want_rows:
            assert_tables_equal(got, pa.concat_tables(want))
            rows += got.column("v").to_pylist()
            for k in got.column("f").to_numpy():
                assert seen.setdefault(_norm(k), p) == p, (k, p)
    assert sorted(rows) == sorted(v for t in tables
                                  for v in t.column("v").values.tolist())
    assert seen[0.0] is not None and np.inf in seen


def test_the_workers_report_their_counters(cluster):
    """Each worker's kernel launches (0 on the CPU: the wrappers run their
    plain versions there), read and reset, and its counters as Prometheus
    text."""
    for w in range(2):
        counts = cluster.run_on(w, launch_counts_task, True)
        assert set(counts) >= {"partition_ids", "counting_order", "axpy"}
        assert set(cluster.run_on(w, launch_counts_task).values()) == {0}
    text = cluster.run_on(0, metrics_text_task)
    assert "# TYPE spark_rapids_tpu_kernel_launches_partition_ids gauge" \
        in text
    assert "spark_rapids_tpu_recovery_worker_deaths 0" in text
    assert "spark_rapids_tpu_shuffle_writes_transport_tier" in text


def test_a_workers_faults_are_configured_at_run_time(cluster):
    """``configure_faults_task`` installs a worker's injector: its next
    task raises the injected fault (through the driver), the one after
    runs, and an empty conf turns injection off again."""
    cluster.run_on(0, configure_faults_task,
                   _fault_conf("worker.task:times=1"))
    with pytest.raises(RuntimeError, match="injected fault 'worker.task'"):
        cluster.run_on(0, worker_info_task)
    assert cluster.run_on(0, worker_info_task)["device"] == "cpu"
    cluster.run_on(0, configure_faults_task, {})
    assert faults.recovery_counters()["worker_deaths"] == 0


def test_a_broadcast_builds_once_and_every_other_worker_fetches(cluster):
    rng = np.random.default_rng(3)
    build = HostTable.from_arrow(pa.table({"k": np.arange(0, 40, 2),
                                           "v": np.arange(0, 40, 2)}))
    probes = {w: HostTable.from_arrow(pa.table({
        "k": rng.integers(0, 40, 30), "v": rng.integers(0, 40, 30)}))
        for w in range(2)}
    assert cluster.run_on(0, broadcast_build_task, 99,
                          serialize_table(build)) == (1, 0)
    build_keys = set(build.column("k").values.tolist())
    for w, want_counts in ((0, (1, 0)), (1, (0, 1))):
        payload, b, f = cluster.run_on(w, broadcast_probe_task, 99,
                                       serialize_table(probes[w]), "k")
        assert (b, f) == want_counts
        got = deserialize_table(payload).column("k").values.tolist()
        assert got == [k for k in probes[w].column("k").values.tolist()
                       if k in build_keys]


def test_the_dcn_tier_moves_a_block_between_workers(cluster):
    """A block published resident on worker 0's device is fetched by worker
    1 onto its own (host bytes only on the wire); a block no worker holds
    is a fetch failure."""
    addrs = {w: cluster.run_on(w, dcn_address_task) for w in range(2)}
    for w in range(2):
        cluster.run_on(w, dcn_add_peer_task, *addrs[1 - w])
    src = HostTable.from_arrow(pa.table({
        "v": np.random.default_rng(1).integers(0, 10_000, 300),
        "s": [f"r{i}" for i in range(300)]}))
    assert cluster.run_on(0, dcn_publish_task, 7, 0, 0,
                          serialize_table(src)) == 300
    got = deserialize_table(cluster.run_on(1, dcn_fetch_task, 7, 0, 0))
    assert got.to_arrow().equals(src.to_arrow())
    with pytest.raises(RuntimeError, match="ShuffleFetchFailed"):
        cluster.run_on(1, dcn_fetch_task, 7, 5, 0)


def _jax_rows(query: str):
    """The JAX package's sequential rows of a query (its worker plan)."""
    from spark_rapids_tpu.columnar.host import HostTable as JHost
    from spark_rapids_tpu.parallel.runtime import _query_plan
    _sess, plan = _query_plan(query, 0.01, True, 2,
                              {"spark.rapids.tpu.shuffle.partitions": "2"})
    parts = [t for p in range(plan.num_partitions) for t in plan.execute(p)]
    return JHost.concat(parts).to_arrow()


def test_q1_over_the_workers_equals_the_jax_query_plan(cluster):
    got = cluster.run_tpch_query("q1", sf=0.01, tiny=True, num_partitions=2,
                                 timeout_s=240)
    want = _jax_rows("q1")
    assert got.num_rows == want.num_rows > 0
    assert_tables_equal(got, want)
    # the workers dropped the query's plans, and its exchanges' outputs
    assert [cluster.run_on(w, worker_info_task)["query_plans"]
            for w in range(2)] == [0, 0]


def test_a_worker_kill_resubmits_and_q1_reaches_parity():
    """``worker.task:after=1:times=1:action=kill``: worker 0's partition
    task kills its process (its first task, the partition count, passes);
    supervision respawns it and resubmits the task, and the rows equal the
    JAX package's sequential ones."""
    conf = _fault_conf("worker.task:after=1:times=1:action=kill",
                       **{"spark.rapids.tpu.task.timeout": 240,
                          "spark.rapids.tpu.task.heartbeatInterval": 0.5,
                          **_SHUFFLE})
    with ProcessCluster(2, conf, device="cpu") as c:
        got = c.run_tpch_query("q1", sf=0.01, tiny=True, num_partitions=2,
                               timeout_s=240)
        assert c.live_workers() == [0, 1]
    counters = faults.recovery_counters()
    assert counters["worker_deaths"] >= 1
    assert counters["worker_respawns"] >= 1
    assert counters["task_resubmissions"] >= 1
    assert_tables_equal(got, _jax_rows("q1"))


def test_exhausted_max_failures_is_structured_not_a_hang():
    """Every task kills its worker and respawn is off: the task fails fast
    with a TaskFailedError naming the fault and the exhausted budget."""
    conf = _fault_conf("worker.task:action=kill",
                       **{"spark.rapids.tpu.task.maxFailures": 2,
                          "spark.rapids.tpu.task.respawnWorkers": False,
                          "spark.rapids.tpu.task.timeout": 60})
    with ProcessCluster(2, conf, device="cpu") as c:
        with pytest.raises(TaskFailedError) as ei:
            c.run_on(0, worker_info_task, timeout_s=60)
    e = ei.value
    assert "maxFailures=2" in str(e) or "no live workers" in str(e)
    assert e.attempts >= 1 and e.task_id is not None and e.history
    assert e.fault and "worker.task" in e.fault
    assert faults.recovery_counters()["task_failures"] >= 1
    assert faults.recovery_counters()["worker_exclusions"] >= 1


@pytest.mark.slow
def test_a_killed_mapper_recomputes_from_lineage():
    """Worker 0 (map 0's blocks) killed: a plain read fails loudly, a read
    with the recompute hook re-runs map 0 on the reader and gives every
    row."""
    rng = np.random.default_rng(0)
    payloads, want = {}, []
    for m in range(2):
        t = HostTable.from_arrow(pa.table({
            "k": rng.integers(0, 50, 200), "v": rng.integers(0, 10_000, 200)}))
        payloads[m] = serialize_table(t)
        want += t.column("v").values.tolist()
    with ProcessCluster(3, device="cpu") as c:
        for m in range(2):
            c.run_on(m, shuffle_write_task, 0, m, payloads[m], ["k"], 3)
        got = [v for r in range(3) for v in deserialize_table(c.run_on(
            2, shuffle_read_task, 0, 2, r)).column("v").values.tolist()]
        assert sorted(got) == sorted(want)
        c.kill(0)
        with pytest.raises(RuntimeError, match="ShuffleFetchFailed"):
            c.run_on(2, shuffle_read_task, 0, 2, 0)
        got = [v for r in range(3) for v in deserialize_table(c.run_on(
            2, shuffle_read_recompute_task, 0, 2, r, payloads, ["k"],
            3)).column("v").values.tolist()]
        assert sorted(got) == sorted(want)


@pytest.mark.slow
def test_a_killed_dcn_publisher_is_a_fetch_failure():
    src = serialize_table(HostTable.from_arrow(pa.table({"v": np.arange(50)})))
    with ProcessCluster(2, device="cpu") as c:
        addrs = {w: c.run_on(w, dcn_address_task) for w in range(2)}
        for w in range(2):
            c.run_on(w, dcn_add_peer_task, *addrs[1 - w])
        c.run_on(0, dcn_publish_task, 8, 0, 0, src)
        c.kill(0)
        with pytest.raises(RuntimeError, match="ShuffleFetchFailed"):
            c.run_on(1, dcn_fetch_task, 8, 0, 0)


@pytest.mark.slow
@pytest.mark.parametrize("query", ["q3", "q5"])
def test_worker_kill_parity_q3_q5(query):
    conf = _fault_conf("worker.task:after=1:times=1:action=kill",
                       **{"spark.rapids.tpu.task.timeout": 240,
                          "spark.rapids.tpu.task.heartbeatInterval": 0.5,
                          **_SHUFFLE})
    with ProcessCluster(2, conf, device="cpu") as c:
        got = c.run_tpch_query(query, sf=0.01, tiny=True, num_partitions=2,
                               timeout_s=240)
    assert faults.recovery_counters()["worker_deaths"] >= 1
    assert_tables_equal(got, _jax_rows(query))


def test_the_executor_tier_runs_on_the_card_unless_asked():
    """``LocalCluster``, ``ExecutorContext``, ``ShuffleManager``,
    ``ProcessCluster``, ``BroadcastManager`` and both DCN transports default
    to CUDA, and raise without a CUDA device as ``TorchSession`` does;
    ``device="cpu"`` runs them on the CPU."""
    local = LocalShuffleTransport()
    makers = {"LocalCluster": lambda: LocalCluster(1),
              "ExecutorContext": lambda: ExecutorContext(0),
              "ShuffleManager": lambda: ShuffleManager(),
              "ProcessCluster": lambda: ProcessCluster(1),
              "BroadcastManager": lambda: BroadcastManager(local),
              "DcnShuffleTransport":
                  lambda: DcnShuffleTransport(MockDcnFabric(), "host-a"),
              "TcpDcnShuffleTransport": lambda: TcpDcnShuffleTransport()}
    if torch.cuda.is_available():
        assert ExecutorContext(0).device.type == "cuda"
        assert ShuffleManager().device.type == "cuda"
        assert BroadcastManager(local).device.type == "cuda"
        assert DcnShuffleTransport(MockDcnFabric(),
                                   "host-a").device.type == "cuda"
    else:
        for who, make in makers.items():
            with pytest.raises(RuntimeError,
                               match=rf"^{who}: no CUDA device is available; "
                               r"pass device='cpu' to run the engine on the "
                               r"CPU$"):
                make()
    with LocalCluster(1, device="cpu") as lc:
        assert lc.executors[0].device == _CPU
        assert lc.executors[0].shuffle.device == _CPU
        assert lc.executors[0].broadcast.device == _CPU
    assert ExecutorContext(0, device="cpu").device == _CPU
    assert ShuffleManager(device="cpu").device == _CPU
    assert BroadcastManager(local, device="cpu").device == _CPU
    assert DcnShuffleTransport(MockDcnFabric(), "host-a",
                               device="cpu").device == _CPU
    tcp_dcn = TcpDcnShuffleTransport(device="cpu")
    try:
        assert tcp_dcn.device == _CPU
    finally:
        tcp_dcn.close()
