"""The control plane and the in-process cluster — the port of
``DriverRuntime`` and ``LocalCluster`` from
``spark_rapids_tpu/parallel/runtime.py``.

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

The cross-process cluster (``ProcessCluster`` over the TCP transport) is
ROADMAP Queue 1: multi-GPU across processes.
"""
from __future__ import annotations

import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import pyarrow as pa

from ..columnar.device import DeviceTable
from ..columnar.host import HostTable
from ..conf import RapidsConf
from ..exec.base import TpuExec
from ..plan.physical import PhysicalPlan, empty_result_table
from ..shuffle.buffer_catalog import ShuffleBufferCatalog
from ..shuffle.transport import LocalShuffleTransport, ShuffleTransport
from .executor import ExecutorContext, FailureDetector

__all__ = ["DriverRuntime", "LocalCluster", "TpuManagedExchangeExec",
           "active_cluster"]

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
                 device="cpu", transport: Optional[ShuffleTransport] = None):
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
