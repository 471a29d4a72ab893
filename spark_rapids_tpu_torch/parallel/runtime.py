"""The control plane, the in-process cluster and the cluster of executor
processes — the port of ``spark_rapids_tpu/parallel/runtime.py``.

- ``DriverRuntime`` ~ RapidsDriverPlugin (Plugin.scala:146-178): the
  failure detector, executor ids, the executors it knows.
- ``LocalCluster`` ~ Spark's ``local-cluster[N, ...]``: ``n`` executor
  contexts in one process sharing one ``LocalShuffleTransport`` (and one
  shuffle buffer catalog, as readers of each other's cached blocks). A
  query's partitions run round-robin on the executors' worker threads,
  each holding its executor's semaphore, and while the cluster runs a
  query every hash exchange of the query goes through the executors'
  ``ShuffleManager``s (``TpuManagedExchangeExec``): map task ``m`` writes
  on executor ``m mod n``, reduce partition ``p`` reads on executor ``p mod
  n``, through the cached tier or the transport tier with its codec.
- ``ProcessCluster``: executors as OS processes, the deployment Spark
  users run (one executor process a GPU). Worker ``i`` is a ``spawn``-ed
  process that owns ``cuda:(i mod device_count)`` (or the CPU, when asked),
  an ``ExecutorContext`` and a ``TcpShuffleTransport`` server peered with
  every other worker's. The driver sends module-level task functions
  (pickled by reference) on a queue a worker and supervises: heartbeats,
  wedge detection, respawn, exclusion, resubmission under
  ``task.maxFailures``, and a clock handshake. Workers sharing a card split
  its spill-catalog budget (``allocFraction / workers on the card``)
  unless ``memory.pool.size`` is set. The tasks below this class are the
  shuffle write and read (with lineage recompute), the DCN tier's, the
  broadcast build and probe, TPC-H partitions and the worker's counters.

Not ported: the distributed trace collection (``collect_traces``,
``dump_traces``, ``trace_flush_task``, ``trace_probe_task`` and the
workers' trace epochs), which comes with ``utils/tracing.py`` (ROADMAP
Queue 1: breadth).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import pyarrow as pa
import torch

from ..columnar.device import DeviceTable, resolve_device
from ..columnar.host import HostTable
from ..conf import (DEVICE_POOL_BYTES, DEVICE_POOL_FRACTION,
                    DEVICE_POOL_MAX_FRACTION, TASK_HEARTBEAT_INTERVAL,
                    TASK_HEARTBEAT_TIMEOUT, TASK_MAX_FAILURES,
                    TASK_MAX_WORKER_RESPAWNS, TASK_RESPAWN_WORKERS,
                    TASK_TIMEOUT, RapidsConf)
from ..exec.base import TpuExec
from ..plan.physical import PhysicalPlan, empty_result_table
from ..shuffle.buffer_catalog import ShuffleBufferCatalog
from ..shuffle.transport import LocalShuffleTransport, ShuffleTransport
from ..utils import faults
from .executor import ExecutorContext, FailureDetector

__all__ = ["DriverRuntime", "LocalCluster", "ProcessCluster",
           "TpuManagedExchangeExec", "TaskFailedError", "TaskTimeoutError",
           "active_cluster", "worker_devices", "worker_conf"]

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional["LocalCluster"] = None


def active_cluster() -> Optional["LocalCluster"]:
    """The cluster running a query now (the planner routes hash exchanges
    through its shuffle managers), or None."""
    return _ACTIVE


class DriverRuntime:
    """Driver-side control plane."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 heartbeat_timeout_s: float = 60.0):
        self.conf = conf or RapidsConf()
        self.detector = FailureDetector(heartbeat_timeout_s)
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.executors: Dict[int, ExecutorContext] = {}

    def register_executor(self, ctx: ExecutorContext) -> int:
        with self._lock:
            self.executors[ctx.executor_id] = ctx
        self.detector.heartbeat(ctx.executor_id)
        return ctx.executor_id

    def next_executor_id(self) -> int:
        return next(self._ids)

    def heartbeat(self, executor_id: int) -> None:
        self.detector.heartbeat(executor_id)


class TpuManagedExchangeExec(TpuExec):
    """A hash exchange through the cluster's shuffle managers. The map side
    runs once (its tasks on the pipeline's pool, each on its executor);
    reduce partition ``p`` reads its blocks on executor ``p mod n``, and a
    lost block reruns its map task once."""

    def __init__(self, child: PhysicalPlan, partitioning,
                 cluster: "LocalCluster", min_bucket: Optional[int] = None):
        super().__init__()
        self.child = child
        self.children = (child,)
        self.partitioning = partitioning
        self.cluster = cluster
        self.min_bucket = min_bucket
        self.schema = child.schema
        self._sid: Optional[int] = None
        self._sizes: Optional[List[List[int]]] = None
        self._lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_parts

    def node_desc(self) -> str:
        return (f"managed keys={self.partitioning.key_names} "
                f"n={self.num_partitions}")

    def _map_task(self, m: int) -> List[int]:
        ctx = self.cluster.executor_for(m)
        ctx.heartbeat()
        with ctx.semaphore.held():
            return ctx.shuffle.write_partition(
                self._sid, m, self.child_device_batches(m),
                list(self.partitioning.key_names), self.num_partitions)

    def _materialize(self) -> None:
        with self._lock:
            if self._sizes is not None:
                return
            from .pipeline import exempt_admission, parallel_map
            self._sid = self.cluster.new_shuffle_id()
            with exempt_admission():
                self._sizes = parallel_map(
                    self._map_task, range(self.child.num_partitions),
                    max_workers=len(self.cluster.executors),
                    stage="shuffle_map")

    def stage_stats(self):
        """Rows and bytes of each reduce partition, from the writers."""
        self._materialize()
        rows = [0] * self.num_partitions
        nbytes = [0] * self.num_partitions
        for ctx in self.cluster.executors:
            st = ctx.shuffle.shuffle_skew_stats(self._sid)
            if st is None:
                continue
            for p in range(self.num_partitions):
                rows[p] += st["rows"][p]
                nbytes[p] += st["bytes"][p]
        return rows, nbytes

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        self._materialize()
        ctx = self.cluster.executor_for(pidx)
        for b in ctx.shuffle.read_partition(
                self._sid, self.child.num_partitions, pidx, self.min_bucket,
                recompute=self._map_task):
            self.account_batch()
            yield b


class LocalCluster:
    """``n`` executors in one process sharing one transport; a query's
    partitions run round-robin across them on worker threads."""

    def __init__(self, n_executors: int, conf: Optional[RapidsConf] = None,
                 device="cuda", transport: Optional[ShuffleTransport] = None):
        device = resolve_device(device, "LocalCluster")
        self.conf = conf or RapidsConf()
        self.driver = DriverRuntime(self.conf)
        self.transport = transport or LocalShuffleTransport(self.conf)
        self.buffer_catalog = ShuffleBufferCatalog()
        self.executors: List[ExecutorContext] = []
        for _ in range(n_executors):
            ctx = ExecutorContext(self.driver.next_executor_id(), self.conf,
                                  transport=self.transport, device=device,
                                  buffer_catalog=self.buffer_catalog)
            ctx.initialize()
            self.driver.register_executor(ctx)
            self.executors.append(ctx)
        self._sids = itertools.count()
        self._pool = ThreadPoolExecutor(max_workers=n_executors,
                                        thread_name_prefix="srt-exec")

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for ctx in self.executors:
            ctx.shutdown()
        self.transport.close()

    def executor_for(self, task: int) -> ExecutorContext:
        return self.executors[task % len(self.executors)]

    def new_shuffle_id(self) -> int:
        return next(self._sids)

    @contextmanager
    def _running(self):
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a LocalCluster is already running a "
                                   "query in this process")
            _ACTIVE = self
        try:
            yield
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE = None

    def run(self, df, device: bool = True) -> pa.Table:
        """Run a DataFrame with its partitions spread over the executors
        (one task a partition, each holding its executor's semaphore), its
        hash exchanges through the shuffle managers."""
        with self._running():
            plan = df.session._physical(df.logical, device=device)
            try:
                n_parts = plan.num_partitions

                def run_partition(pidx: int) -> List[HostTable]:
                    ctx = self.executor_for(pidx)
                    ctx.heartbeat()
                    self.driver.heartbeat(ctx.executor_id)
                    with ctx.semaphore.held():
                        return list(plan.execute(pidx))

                futures = [self._pool.submit(run_partition, p)
                           for p in range(n_parts)]
                tables = [t for f in futures for t in f.result()]
            finally:
                plan.release_spill_handles()
        if not tables:
            return empty_result_table(plan.schema).to_arrow()
        return HostTable.concat(tables).to_arrow()


# ---------------------------------------------------------------------------
# Executors as OS processes over the TCP transport (reference: real Spark
# executors with RapidsShuffleServer/Client between them)
# ---------------------------------------------------------------------------
class TaskFailedError(RuntimeError):
    """A ProcessCluster task failed terminally: its worker(s) died and the
    task exhausted resubmission, or no live worker remains. Carries the
    forensics: attempts, the failure history, the injected fault that
    killed a worker, the last heartbeat's age, the queue depth."""

    def __init__(self, message: str, *, task_id: Optional[int] = None,
                 worker: Optional[int] = None, attempts: int = 0,
                 history: Tuple[str, ...] = (),
                 fault: Optional[str] = None,
                 last_heartbeat_age_s: Optional[float] = None,
                 pending_tasks: Optional[int] = None,
                 exitcode: Optional[int] = None):
        super().__init__(message)
        self.task_id = task_id
        self.worker = worker
        self.attempts = attempts
        self.history = tuple(history)
        self.fault = fault
        self.last_heartbeat_age_s = last_heartbeat_age_s
        self.pending_tasks = pending_tasks
        self.exitcode = exitcode


class TaskTimeoutError(TaskFailedError):
    """The task.timeout deadline expired while a task was in flight."""


def worker_devices(n: int, device) -> List[str]:
    """The device of each of ``n`` workers: ``"cuda"`` spreads them over
    the visible cards (worker ``i`` on ``cuda:(i mod device_count)``), a
    device with an index or the CPU is every worker's. Raises without a
    CUDA device unless given ``device="cpu"``."""
    dev = resolve_device(device, "ProcessCluster")
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [f"cuda:{i % count}" for i in range(n)]
    return [str(dev)] * n


def worker_conf(conf_values: dict, devices: List[str], worker: int) -> dict:
    """The conf a worker runs: the cluster's, with the spill catalog's
    device budget split between the workers sharing the worker's device
    (each catalog sizes its pool from the whole card: ``allocFraction``,
    capped by ``maxAllocFraction``, of its memory), unless
    ``memory.pool.size`` sets the budget."""
    values = dict(conf_values)
    conf = RapidsConf(values)
    share = devices.count(devices[worker])
    if not conf.get(DEVICE_POOL_BYTES) and share > 1:
        frac = min(float(conf.get(DEVICE_POOL_FRACTION)),
                   float(conf.get(DEVICE_POOL_MAX_FRACTION)))
        values[DEVICE_POOL_FRACTION.key] = frac / share
    return values


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """The launches of every kernel wrapper in this process (each wrapper
    counts where it launches its kernel); ``reset`` sets them to 0 after
    the read."""
    from ..exec import window_kernels
    from ..expr import decimal128
    from ..io import parquet_kernels
    from ..shuffle import manager
    from ..udf import kernels
    fns = [kernels.axpy, kernels.nfa_match, parquet_kernels.pq_expand_hybrid,
           parquet_kernels.pq_gather_fixed,
           parquet_kernels.pq_gather_byte_array, decimal128.d128_mul_rescaled,
           decimal128.d128_rescale, decimal128.d128_segment_sum,
           window_kernels.seg_scan, window_kernels.frame_bounds,
           window_kernels.frame_reduce, manager.partition_ids,
           manager.counting_order]
    out = {fn.__name__: fn.launches for fn in fns}
    if reset:
        for fn in fns:
            fn.launches = 0
    return out


def _worker_main(worker_id: int, conf_values: dict, device: str,
                 spawned_at: float, addr_q, task_q, result_q) -> None:
    """A worker process: sets up its device, its transport and (on the
    driver's "peers" message) its executor, then runs tasks until the
    ``None`` sentinel. The startup times go back with the address:
    ``import_s`` from the spawn (wall clock) to here (the interpreter's
    start, the imports of torch and the package), ``device_context_s``
    the device's context, ``startup_s`` the spawn to the address."""
    import_s = time.time() - spawned_at
    from ..host_native import load_host_native
    from ..shuffle.tcp import TcpShuffleTransport
    from ..utils import faults as wfaults

    dev = torch.device(device)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)   # the CUDA context
    t_context = time.perf_counter() - t1
    if dev.type == "cuda":
        from .. import native
        native.load_kernels()   # the driver built it: a load, or a raise
    load_host_native()
    conf = RapidsConf(conf_values)
    # the worker id as a seed offset decorrelates the workers' fault
    # streams while keeping each process deterministic
    wfaults.configure_faults(conf, seed_offset=worker_id)
    transport = TcpShuffleTransport(conf)
    addr_q.put((worker_id, transport.address,
                {"import_s": import_s, "device_context_s": t_context,
                 "startup_s": time.time() - spawned_at}))

    # heartbeats: the driver tells a busy worker from a wedged one by them
    hb_stop = threading.Event()
    hb_interval = float(conf.get(TASK_HEARTBEAT_INTERVAL))

    def heartbeat_loop():
        while not hb_stop.is_set():
            try:
                result_q.put((-1, "hb", (worker_id, time.time())))
            except (OSError, ValueError):  # the queue closed at shutdown
                return
            hb_stop.wait(hb_interval)

    threading.Thread(target=heartbeat_loop, daemon=True,
                     name=f"srt-worker-hb-{worker_id}").start()
    ctx = None
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            tid, kind, payload = task
            if kind == "peers":
                for host, port in payload:
                    transport.add_peer(host, port)
                ctx = ExecutorContext(worker_id, conf, transport=transport,
                                      device=dev).initialize()
                result_q.put((tid, "ok", None))
                continue
            if kind == "addpeer":
                # a respawned worker's new address; the stale one stays in
                # the peer list and fails fast on the next fetch
                transport.add_peer(*payload)
                result_q.put((tid, "ok", None))
                continue
            if kind == "clock":
                result_q.put((tid, "ok", time.time()))
                continue
            if kind == "release":
                result_q.put((tid, "ok", release_query_plans()))
                continue
            fn, args = payload
            try:
                action = wfaults.fire("worker.task")
                if action == "kill":
                    # abrupt worker loss; first the driver learns which
                    # fault it was, and the queue's feeder flushes it
                    result_q.put((tid, "dying", "injected fault "
                                  "'worker.task' (action=kill)"))
                    result_q.close()
                    result_q.join_thread()
                    os._exit(13)
                if action is not None:
                    raise wfaults.FaultInjectedError("worker.task", action)
                result_q.put((tid, "ok", fn(ctx, *args)))
            except Exception as e:  # noqa: BLE001 - to the driver
                result_q.put((tid, "err", f"{type(e).__name__}: {e}"))
    finally:
        hb_stop.set()
        if ctx is not None:
            ctx.shutdown()
        transport.close()


class ProcessCluster:
    """``n`` executor processes, each with a ``TcpShuffleTransport`` server,
    all peered with each other. Task functions must be module-level (they
    pickle by reference) and take the worker's ``ExecutorContext`` first.

    ``device="cuda"`` (the default) puts worker ``i`` on ``cuda:(i mod
    device_count)``; ``device="cpu"`` runs every worker on the CPU. The
    driver builds the CUDA kernels and the host library before spawning,
    so the workers load the built libraries. ``startup`` holds the wall of
    the start and each worker's import, device-context and startup seconds
    (``_worker_main``); ``clock_offsets`` each worker's estimated
    wall-clock offset."""

    def __init__(self, n_executors: int, conf: Optional[dict] = None,
                 device="cuda", start_timeout_s: float = 120.0,
                 clock_probes: int = 5):
        import multiprocessing as mp
        t0 = time.perf_counter()
        self.devices = worker_devices(n_executors, device)
        from ..host_native import load_host_native
        load_host_native()
        if any(d.startswith("cuda") for d in self.devices):
            from .. import native
            native.load_kernels()
        self._mp = mp.get_context("spawn")
        self._addr_q = self._mp.Queue()
        self._result_q = self._mp.Queue()
        self._task_qs = [self._mp.Queue() for _ in range(n_executors)]
        self._conf_values = dict(conf or {})
        rconf = RapidsConf(self._conf_values)
        self._clock_probes = clock_probes
        self._task_timeout = float(rconf.get(TASK_TIMEOUT))
        self._max_failures = int(rconf.get(TASK_MAX_FAILURES))
        self._respawn_enabled = bool(rconf.get(TASK_RESPAWN_WORKERS))
        self._max_respawns = int(rconf.get(TASK_MAX_WORKER_RESPAWNS))
        self._hb_timeout = float(rconf.get(TASK_HEARTBEAT_TIMEOUT))
        self._start_timeout = float(start_timeout_s)
        #: wedge detection over the workers' heartbeats (reference:
        #: heartbeat-driven executor exclusion, Plugin.scala:149-161)
        self.detector = FailureDetector(self._hb_timeout)
        self._inflight: Dict[int, dict] = {}
        self._excluded: set = set()
        self._respawns: Dict[int, int] = {}
        self._last_hb: Dict[int, float] = {}
        self._closing = False
        self._recovering = False
        self._tids = itertools.count()
        self._done: Dict[int, tuple] = {}
        self.procs = [self._spawn_process(i) for i in range(n_executors)]
        for p in self.procs:
            p.start()
        self.addresses: List[tuple] = [None] * n_executors
        self.startup: Dict = {"workers": {}}
        try:
            for _ in range(n_executors):
                wid, addr, times = self._addr_q.get(timeout=start_timeout_s)
                self.addresses[wid] = addr
                self.startup["workers"][wid] = times
            for i in range(n_executors):
                peers = [a for j, a in enumerate(self.addresses) if j != i]
                self._wait(self._submit(i, "peers", peers))
            #: worker id -> estimated (worker wall - driver wall) seconds
            self.clock_offsets: Dict[int, float] = {
                i: self._estimate_clock_offset(i) for i in range(n_executors)}
        except BaseException:
            self.close()
            raise
        self.startup["wall_s"] = time.perf_counter() - t0

    def _spawn_process(self, worker: int):
        return self._mp.Process(
            target=_worker_main,
            args=(worker, worker_conf(self._conf_values, self.devices, worker),
                  self.devices[worker], time.time(), self._addr_q,
                  self._task_qs[worker], self._result_q), daemon=True)

    def live_workers(self) -> List[int]:
        return [i for i, p in enumerate(self.procs)
                if i not in self._excluded and p.is_alive()]

    def _estimate_clock_offset(self, worker: int) -> float:
        """NTP-style: bracket clock round trips and keep the probe of the
        smallest round trip (queue latency inflates it symmetrically)."""
        best_rtt, offset = float("inf"), 0.0
        for _ in range(max(1, self._clock_probes)):
            t0 = time.time()
            t1 = self._wait(self._submit(worker, "clock", None))
            t2 = time.time()
            if t2 - t0 < best_rtt:
                best_rtt, offset = t2 - t0, t1 - (t0 + t2) / 2.0
        return offset

    def _submit(self, worker: int, kind: str, payload) -> int:
        tid = next(self._tids)
        self._inflight[tid] = {"worker": worker, "kind": kind,
                               "payload": payload, "attempts": 1,
                               "history": [], "fault": None}
        self._task_qs[worker].put((tid, kind, payload))
        return tid

    def submit(self, worker: int, fn, *args) -> int:
        """Run ``fn(ctx, *args)`` on a worker; returns a task id."""
        return self._submit(worker, "call", (fn, args))

    def _wait(self, tid: int, timeout_s: Optional[float] = None):
        budget = self._task_timeout if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + budget
        # wedge detection measures heartbeat silence during this wait only:
        # nobody drains the result queue while the driver is idle
        for w in self.live_workers():
            self.detector.heartbeat(w)
        while tid not in self._done:
            try:
                got_tid, status, value = self._result_q.get(timeout=0.2)
            except queue.Empty:
                self._check_workers()
                if time.monotonic() >= deadline:
                    self._raise_timeout(tid, budget)
                continue
            if status == "hb":
                wid, _ts = value
                self.detector.heartbeat(wid)
                self._last_hb[wid] = time.monotonic()
                continue
            if status == "dying":
                rec = self._inflight.get(got_tid)
                if rec is not None:
                    rec["fault"] = value
                continue
            if got_tid not in self._inflight:
                # a stale answer: the task was resubmitted after its first
                # worker died mid-answer, or it failed already
                continue
            del self._inflight[got_tid]
            self._done[got_tid] = (status, value)
        status, value = self._done.pop(tid)
        if status == "failed":
            raise value
        if status == "err":
            raise RuntimeError(f"task {tid} failed on worker: {value}")
        return value

    def _raise_timeout(self, tid: int, budget: float):
        rec = self._inflight.pop(tid, None)
        faults.note_recovery("task_timeouts")
        worker = rec["worker"] if rec else None
        hb_age = depth = None
        if worker is not None:
            last = self._last_hb.get(worker)
            hb_age = None if last is None else time.monotonic() - last
            try:
                depth = self._task_qs[worker].qsize()
            except (NotImplementedError, OSError):
                depth = None
        age_txt = "never seen" if hb_age is None else f"{hb_age:.1f}s ago"
        depth_txt = "?" if depth is None else str(depth)
        raise TaskTimeoutError(
            f"task {tid} timed out after {budget:.1f}s on worker {worker} "
            f"(last heartbeat {age_txt}, ~{depth_txt} pending tasks); raise "
            "spark.rapids.tpu.task.timeout if the task is legitimately slow",
            task_id=tid, worker=worker,
            attempts=rec["attempts"] if rec else 0,
            history=tuple(rec["history"]) if rec else (),
            fault=rec.get("fault") if rec else None,
            last_heartbeat_age_s=hb_age, pending_tasks=depth)

    # -- worker supervision ---------------------------------------------------
    def _check_workers(self):
        """Find dead or wedged workers and recover. Runs inside _wait's
        poll loop; the _recovering latch cuts re-entry (recovery itself
        waits on control tasks)."""
        if self._closing or self._recovering:
            return
        self._recovering = True
        try:
            for i, p in enumerate(self.procs):
                if i not in self._excluded and not p.is_alive():
                    self._on_worker_death(
                        i, f"worker {i} process exited "
                           f"(exitcode={p.exitcode})")
            for wid in self.detector.check():
                if wid in self._excluded or wid >= len(self.procs):
                    continue
                p = self.procs[wid]
                if p.is_alive():
                    # alive but silent past heartbeatTimeout: wedged
                    p.terminate()
                    p.join(timeout=10)
                    self._on_worker_death(
                        wid, f"worker {wid} wedged (no heartbeat for "
                             f"{self._hb_timeout:.0f}s)")
        finally:
            self._recovering = False

    def _on_worker_death(self, worker: int, reason: str,
                         allow_respawn: bool = True):
        faults.note_recovery("worker_deaths")
        orphans = [t for t, r in self._inflight.items()
                   if r["worker"] == worker]
        respawned = False
        if (allow_respawn and self._respawn_enabled and not self._closing
                and self._respawns.get(worker, 0) < self._max_respawns):
            try:
                self._respawn_worker(worker)
                respawned = True
                faults.note_recovery("worker_respawns")
            except (OSError, RuntimeError, queue.Empty) as e:
                reason += f"; respawn failed: {type(e).__name__}: {e}"
        if not respawned:
            self._excluded.add(worker)
            faults.note_recovery("worker_exclusions")
        for t in orphans:
            self._resubmit_or_fail(t, reason)

    def _respawn_worker(self, worker: int):
        """A fresh process on the dead worker's slot: a fresh task queue
        (the old may hold stale envelopes), its new address told to every
        live peer, its clock offset estimated again."""
        self._respawns[worker] = self._respawns.get(worker, 0) + 1
        old_q = self._task_qs[worker]
        self._task_qs[worker] = self._mp.Queue()
        p = self._spawn_process(worker)
        self.procs[worker] = p
        p.start()
        while True:
            wid, addr, times = self._addr_q.get(timeout=self._start_timeout)
            if wid == worker:
                break
        self.addresses[worker] = addr
        self.startup["workers"][worker] = times
        peers = [a for j, a in enumerate(self.addresses)
                 if j != worker and j not in self._excluded
                 and self.procs[j].is_alive()]
        self._wait(self._submit(worker, "peers", peers),
                   timeout_s=self._start_timeout)
        for j in self.live_workers():
            if j != worker:
                self._wait(self._submit(j, "addpeer", addr),
                           timeout_s=self._start_timeout)
        self.clock_offsets[worker] = self._estimate_clock_offset(worker)
        old_q.close()

    def _resubmit_or_fail(self, tid: int, reason: str):
        """Another attempt of a task whose worker died; a control task or
        an exhausted one becomes a TaskFailedError its _wait raises."""
        rec = self._inflight.get(tid)
        if rec is None:
            return
        rec["history"].append(reason)
        live = self.live_workers()
        terminal = None
        if rec["kind"] != "call":
            terminal = "control task cannot be resubmitted"
        elif rec["attempts"] >= self._max_failures:
            terminal = (f"exhausted spark.rapids.tpu.task.maxFailures="
                        f"{self._max_failures}")
        elif not live:
            terminal = "no live workers remain"
        if terminal is not None:
            del self._inflight[tid]
            faults.note_recovery("task_failures")
            fault = rec.get("fault")
            msg = (f"task {tid} failed after {rec['attempts']} attempt(s): "
                   f"{terminal}; failures: {'; '.join(rec['history'])}")
            if fault:
                msg += f"; fault: {fault}"
            self._done[tid] = ("failed", TaskFailedError(
                msg, task_id=tid, worker=rec["worker"],
                attempts=rec["attempts"], history=tuple(rec["history"]),
                fault=fault))
            return
        rec["attempts"] += 1
        target = live[rec["attempts"] % len(live)]
        rec["worker"] = target
        faults.note_recovery("task_resubmissions")
        self._task_qs[target].put((tid, rec["kind"], rec["payload"]))

    def run_on(self, worker: int, fn, *args,
               timeout_s: Optional[float] = None):
        return self._wait(self.submit(worker, fn, *args), timeout_s)

    def run_tpch_query(self, query: str, sf: float = 0.01,
                       tiny: bool = True, num_partitions: int = 4,
                       timeout_s: Optional[float] = None) -> pa.Table:
        """One TPC-H query's output partitions fanned over the live workers
        and merged: each worker plans the query for its own device, on
        tables it generates from the seeds. A worker killed mid-query gives
        the same rows, through supervision and resubmission."""
        from ..shuffle.serializer import deserialize_table
        live = self.live_workers()
        if not live:
            raise TaskFailedError("no live workers to plan the query on")
        try:
            n_parts = self.run_on(live[0], query_num_partitions_task, query,
                                  sf, tiny, num_partitions, self._conf_values,
                                  timeout_s=timeout_s)
            tids = []
            for pidx in range(n_parts):
                live = self.live_workers()
                if not live:
                    raise TaskFailedError(
                        f"no live workers remain for partition {pidx}")
                tids.append(self.submit(live[pidx % len(live)],
                                        run_query_task, query, sf, tiny,
                                        num_partitions, pidx,
                                        self._conf_values))
            parts = [deserialize_table(p) for p in
                     (self._wait(t, timeout_s) for t in tids)
                     if p is not None]
        finally:
            # the query is over: no worker keeps its plan, nor the device
            # tables its exchanges materialised
            for w in self.live_workers():
                self._wait(self._submit(w, "release", None), timeout_s)
        if not parts:
            return pa.table({})
        return HostTable.concat(parts).to_arrow()

    def kill(self, worker: int):
        """Hard-kill one worker (deliberate failure injection). Its slot is
        excluded, never respawned, and its in-flight tasks go to the
        surviving workers."""
        self.procs[worker].terminate()
        self.procs[worker].join(timeout=30)
        self._on_worker_death(worker, f"worker {worker} killed by driver",
                              allow_respawn=False)

    def close(self):
        """Stop every worker: the sentinel, then a join that keeps draining
        the result queue (a worker's queue feeder must flush before the
        process can exit), then terminate what is left."""
        self._closing = True
        for i, p in enumerate(self.procs):
            if p.is_alive():
                self._task_qs[i].put(None)
        deadline = time.monotonic() + 30
        for p in self.procs:
            while p.is_alive() and time.monotonic() < deadline:
                p.join(timeout=0.1)
                self._drain_results()
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._drain_results()
        for q in (self._addr_q, self._result_q, *self._task_qs):
            q.close()
            q.join_thread()

    def _drain_results(self) -> None:
        try:
            while True:
                self._result_q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "ProcessCluster":
        return self

    def __exit__(self, *exc):
        self.close()


# -- task functions (module-level, so they pickle by reference) --------------
def _worker_counters() -> Dict[str, float]:
    from ..shuffle.manager import shuffle_stats
    from ..shuffle.telemetry import shuffle_telemetry_stats
    out: Dict[str, float] = {f"kernel_launches_{k}": v
                             for k, v in launch_counts().items()}
    out.update({f"shuffle_{k}": v for k, v in shuffle_stats().items()})
    out.update({f"recovery_{k}": v
                for k, v in faults.recovery_counters().items()})
    out.update({f"shuffle_telemetry_{k}": v
                for k, v in shuffle_telemetry_stats().items()})
    return out


def metrics_text_task(ctx: ExecutorContext) -> str:
    """This worker's counters as Prometheus text (gauges): every kernel
    wrapper's launches, the shuffle manager's blocks and bytes, the
    recovery ledger and the shuffle observatory's totals."""
    lines = []
    for key, val in sorted(_worker_counters().items()):
        name = "spark_rapids_tpu_" + key.replace(".", "_")
        lines += [f"# TYPE {name} gauge", f"{name} {val}"]
    return "\n".join(lines) + "\n"


def worker_info_task(ctx: ExecutorContext) -> Dict[str, object]:
    """This worker's process id, device, spill-catalog device budget and
    the query plans it holds."""
    return {"pid": os.getpid(), "device": str(ctx.device),
            "catalog_budget": ctx.catalog.device.limit_bytes,
            "query_plans": len(_QUERY_PLANS)}


def configure_faults_task(ctx: ExecutorContext, conf_values: dict) -> None:
    """Install this worker's fault injector from ``conf_values`` (the
    worker id its seed offset), as a worker's start does from the
    cluster's conf; a worker respawned later starts from the cluster's
    conf again."""
    faults.configure_faults(RapidsConf(conf_values),
                            seed_offset=ctx.executor_id)


def launch_counts_task(ctx: ExecutorContext,
                       reset: bool = False) -> Dict[str, int]:
    """This worker's kernel launches (``launch_counts``)."""
    return launch_counts(reset)


def shuffle_write_task(ctx: ExecutorContext, shuffle_id: int, map_id: int,
                       payload: bytes, key_names: List[str], num_parts: int,
                       codec: Optional[str] = None) -> List[int]:
    """Upload a serialised table to the worker's device and write it
    through the worker's shuffle manager (the partition-id and counting-
    order kernels on the card) -> the bytes of each block. ``codec``
    overrides the cluster's ``spark.rapids.shuffle.compression.codec`` for
    this write (readers take a block's codec from its frame)."""
    from ..conf import SHUFFLE_COMPRESSION_CODEC
    from ..shuffle.manager import ShuffleManager
    from ..shuffle.serializer import deserialize_table
    mgr = ctx.shuffle if codec is None else ShuffleManager(
        ctx.conf.set(SHUFFLE_COMPRESSION_CODEC.key, codec),
        ctx.shuffle.transport, ctx.device)
    table = DeviceTable.from_host(deserialize_table(payload), 8, ctx.device)
    return mgr.write_partition(shuffle_id, map_id, iter([table]), key_names,
                               num_parts)


def _read(ctx: ExecutorContext, shuffle_id: int, num_maps: int,
          reduce_id: int, recompute=None) -> Optional[bytes]:
    from ..shuffle.serializer import serialize_table
    out = [b.to_host() for b in ctx.shuffle.read_partition(
        shuffle_id, num_maps, reduce_id, 8, recompute=recompute)]
    if not out:
        return None
    return serialize_table(HostTable.concat(out))


def shuffle_read_task(ctx: ExecutorContext, shuffle_id: int, num_maps: int,
                      reduce_id: int) -> Optional[bytes]:
    """Fetch one reduce partition over the transport -> its rows,
    serialised (None when no map wrote a column)."""
    return _read(ctx, shuffle_id, num_maps, reduce_id)


def shuffle_read_recompute_task(ctx: ExecutorContext, shuffle_id: int,
                                num_maps: int, reduce_id: int,
                                map_payloads: Dict[int, bytes],
                                key_names: List[str],
                                num_parts: int) -> Optional[bytes]:
    """A read whose fetch-failed map task re-runs here from its input (the
    lineage recompute of Spark's stage retry)."""
    def recompute(map_id: int):
        shuffle_write_task(ctx, shuffle_id, map_id, map_payloads[map_id],
                           key_names, num_parts)
    return _read(ctx, shuffle_id, num_maps, reduce_id, recompute)


def dcn_address_task(ctx: ExecutorContext) -> tuple:
    """Start (if needed) the worker's DCN-tier transport -> (host, port)."""
    return ctx.dcn_transport().address


def dcn_add_peer_task(ctx: ExecutorContext, host: str, port: int) -> None:
    ctx.dcn_transport().add_peer(host, port)


def dcn_publish_task(ctx: ExecutorContext, shuffle_id: int, map_id: int,
                     reduce_id: int, payload: bytes) -> int:
    """Upload the table and publish it resident on this worker's device
    (serialised for the wire only when a peer asks) -> its rows."""
    from ..shuffle.serializer import deserialize_table
    from ..shuffle.transport import BlockId
    host = deserialize_table(payload)
    ctx.dcn_transport().publish_table(
        BlockId(shuffle_id, map_id, reduce_id),
        DeviceTable.from_host(host, 8, ctx.device))
    return host.num_rows


def dcn_fetch_task(ctx: ExecutorContext, shuffle_id: int, map_id: int,
                   reduce_id: int) -> bytes:
    """Fetch one block over the DCN tier onto this worker's device -> its
    rows, serialised (for the caller's check), and the device it landed
    on."""
    from ..shuffle.serializer import serialize_table
    from ..shuffle.transport import BlockId
    bid = BlockId(shuffle_id, map_id, reduce_id)
    table = dict(ctx.dcn_transport().fetch_tables([bid]))[bid]
    if table.device != ctx.device:
        raise RuntimeError(f"DCN block landed on {table.device}, not the "
                           f"worker's {ctx.device}")
    return serialize_table(table.to_host())


def broadcast_build_task(ctx: ExecutorContext, bcast_id: int,
                         payload: bytes) -> Tuple[int, int]:
    """The designated builder of a broadcast (reference: the driver-side
    relationFuture, GpuBroadcastExchangeExec.scala:336) -> (builds,
    fetches) of this worker."""
    from ..shuffle.serializer import deserialize_table
    ctx.broadcast.build_and_publish(
        bcast_id, lambda: DeviceTable.from_host(deserialize_table(payload), 8,
                                                ctx.device))
    return ctx.broadcast.builds, ctx.broadcast.fetches


def broadcast_probe_task(ctx: ExecutorContext, bcast_id: int,
                         probe_payload: bytes, key: str
                         ) -> Tuple[bytes, int, int]:
    """The probe side: the build from the local cache or a peer's bytes
    (never re-run), on this worker's device, and the local probe rows whose
    ``key`` it holds -> (rows, builds, fetches)."""
    import numpy as np
    from ..shuffle.serializer import deserialize_table, serialize_table
    build = ctx.broadcast.get(bcast_id)
    if build.device != ctx.device:
        raise RuntimeError(f"broadcast build on {build.device}, not the "
                           f"worker's {ctx.device}")
    bk = np.sort(build.to_host().column(key).values)
    probe = deserialize_table(probe_payload)
    pk = probe.column(key).values
    if len(bk):
        pos = np.clip(np.searchsorted(bk, pk), 0, len(bk) - 1)
        hit = bk[pos] == pk
    else:
        hit = np.zeros(len(pk), dtype=bool)
    joined = probe.take(np.nonzero(hit)[0])
    return (serialize_table(joined), ctx.broadcast.builds,
            ctx.broadcast.fetches)


#: (query, sf, tiny, partitions, device, conf) -> (session, physical plan):
#: each worker plans a query once for all its partition tasks, and drops
#: the plan when the driver's ``run_tpch_query`` ends (release_query_plans)
_QUERY_PLANS: Dict[tuple, tuple] = {}


def release_query_plans() -> int:
    """Drop every plan this process cached and close the spill handles of
    its outputs (the exchanges' shards, broadcast builds), so a worker
    holds no device memory of a finished query -> the plans dropped."""
    plans = list(_QUERY_PLANS.values())
    _QUERY_PLANS.clear()
    for _sess, plan in plans:
        plan.release_spill_handles()
    return len(plans)


def _query_plan(query: str, sf: float, tiny: bool, num_partitions: int,
                conf_overrides: Optional[dict], device="cuda"):
    """The device plan of a TPC-H query for ``device`` over tables
    generated from the seeds (cached in the process)."""
    from ..session import TorchSession
    from ..tools import tpch
    key = (query, sf, tiny, num_partitions, str(device),
           tuple(sorted((conf_overrides or {}).items())))
    cached = _QUERY_PLANS.get(key)
    if cached is None:
        # a session configures the process's fault injector from the
        # plain seed: keep this worker's offset injector
        prev = faults.active()
        sess = TorchSession(dict(conf_overrides or {}), device=device)
        faults.install(prev)
        dfs = tpch.build_dataframes(sess, tpch.gen_all(sf, tiny=tiny),
                                    num_partitions=num_partitions)
        df = tpch.QUERIES[query](dfs)
        cached = (sess, sess._physical(df.logical, device=True))
        _QUERY_PLANS[key] = cached
    return cached


def query_num_partitions_task(ctx: ExecutorContext, query: str, sf: float,
                              tiny: bool, num_partitions: int,
                              conf_overrides: Optional[dict] = None) -> int:
    """Plan (and cache) the query on this worker -> its output partitions,
    over which the driver fans run_query_task."""
    _sess, plan = _query_plan(query, sf, tiny, num_partitions,
                              _worker_conf_of(ctx, conf_overrides), ctx.device)
    return int(plan.num_partitions)


def run_query_task(ctx: ExecutorContext, query: str, sf: float, tiny: bool,
                   num_partitions: int, pidx: int,
                   conf_overrides: Optional[dict] = None) -> Optional[bytes]:
    """One output partition of a TPC-H query on this worker's device ->
    its rows, serialised. Every worker generates the tables and runs its
    own exchanges: duplicated work, but each partition's rows are the
    single-process run's."""
    from ..shuffle.serializer import serialize_table
    _sess, plan = _query_plan(query, sf, tiny, num_partitions,
                              _worker_conf_of(ctx, conf_overrides), ctx.device)
    with ctx.semaphore.held():
        out = list(plan.execute(pidx))
    if not out:
        return None
    return serialize_table(HostTable.concat(out))


def _worker_conf_of(ctx: ExecutorContext,
                   conf_overrides: Optional[dict]) -> dict:
    """``conf_overrides`` with the worker's split device budget (its
    catalog's ``allocFraction``), so a session the worker makes keeps the
    worker's catalog."""
    values = dict(conf_overrides or {})
    values[DEVICE_POOL_FRACTION.key] = ctx.conf.get(DEVICE_POOL_FRACTION)
    return values
