"""The pipelined executor — the port of
``spark_rapids_tpu/parallel/pipeline.py``.

- ``pipelined_collect(plan, conf)`` drains the partitions of a plan
  concurrently from a bounded task pool (``spark.rapids.tpu.pipeline
  .taskPool``), each task holding the task semaphore (memory/semaphore.py)
  while it drives device work, and concatenates the results in partition
  order: host work of one partition overlaps device work of another.
- ``prefetched(make_iter, ...)`` runs an iterator chain on a worker thread
  behind a BOUNDED queue (``prefetchDepth``), so a stage boundary (the
  exchange's map side) is double-buffered; ``maybe_prefetched`` is the one
  switch every boundary goes through.
- ``parallel_map`` applies a function on the bounded pool, results in input
  order.

Admission is task-scoped: the partition's task thread holds the semaphore;
the workers it spawns run under that admission (``semaphore_exempt``) and
never take a permit of their own, or a task waiting on its worker while the
worker waits on the task's permit would deadlock at one permit.
``exempt_admission`` is the same scope for a thread that holds a shared
materialization lock; ``task_admission`` the inverse, for a thread that is
a task.

Streams: a worker thread starts on device 0 and on that device's default
stream, like every thread; the kernels take their device from their input
tensors (native.py ``launch``), and PyTorch's allocator orders a tensor's
reuse on the stream it was made on. Every thread here stays on the default
stream, so a batch made by one thread and read by another needs no event.

A worker's exception crosses the queue and re-raises in the consumer, with
the stage named in its notes; every queue wait is bounded by the query
deadline (utils/deadline.py). ``pipeline.enabled=false`` restores strictly
sequential execution.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional, Sequence, TypeVar

from ..conf import (PIPELINE_ENABLED, PIPELINE_PREFETCH_DEPTH,
                    PIPELINE_TASK_POOL)

__all__ = ["configure_pipeline", "pipeline_enabled", "prefetch_depth",
           "task_pool_size", "prefetched", "maybe_prefetched",
           "pipelined_collect", "parallel_map", "active_workers",
           "semaphore_exempt", "exempt_admission", "task_admission"]

_WORKER_TLS = threading.local()


def semaphore_exempt() -> bool:
    """True on pipeline worker threads: device admission was granted to
    the owning task (memory/semaphore.py consults this)."""
    return getattr(_WORKER_TLS, "exempt", False)


@contextmanager
def _exempt(flag: bool):
    prev = getattr(_WORKER_TLS, "exempt", False)
    _WORKER_TLS.exempt = flag
    try:
        yield
    finally:
        _WORKER_TLS.exempt = prev


def exempt_admission():
    """This thread runs under another task's admission (or holds a shared
    materialization lock): semaphore acquires and releases no-op."""
    return _exempt(True)


def task_admission():
    """This thread is a task and takes real admission."""
    return _exempt(False)


_SETTINGS_LOCK = threading.Lock()
_SETTINGS = {"enabled": bool(PIPELINE_ENABLED.default),
             "depth": int(PIPELINE_PREFETCH_DEPTH.default),
             "task_pool": int(PIPELINE_TASK_POOL.default)}

_WORKERS_LOCK = threading.Lock()
_WORKERS: dict = {}  # thread -> cancel Event
_STATS = {"workers_started": 0, "items_queued": 0, "stage_errors": 0,
          "tasks_run": 0}


def configure_pipeline(conf) -> None:
    """Apply spark.rapids.tpu.pipeline.* (the session calls it; the most
    recent session wins, as the JAX package's)."""
    with _SETTINGS_LOCK:
        _SETTINGS["enabled"] = bool(conf.get(PIPELINE_ENABLED))
        _SETTINGS["depth"] = int(conf.get(PIPELINE_PREFETCH_DEPTH))
        _SETTINGS["task_pool"] = int(conf.get(PIPELINE_TASK_POOL))


def pipeline_enabled() -> bool:
    with _SETTINGS_LOCK:
        return _SETTINGS["enabled"]


def prefetch_depth() -> int:
    with _SETTINGS_LOCK:
        return _SETTINGS["depth"]


def task_pool_size() -> int:
    with _SETTINGS_LOCK:
        return _SETTINGS["task_pool"]


def active_workers() -> int:
    """Live prefetch worker threads (0 after queries drain)."""
    with _WORKERS_LOCK:
        return sum(1 for t in _WORKERS if t.is_alive())


class _Done:
    """The producer finished."""


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _attach_context(exc: BaseException, stage: str) -> BaseException:
    """Name the stage in the exception's notes; its type stays."""
    try:
        exc.add_note(f"raised in pipeline stage {stage!r}")
    except AttributeError:
        pass  # an exception type without notes still propagates as it is
    return exc


def _queue_get(q: "queue.Queue"):
    """A blocking get that a query deadline bounds."""
    from ..utils.deadline import check_deadline, deadline_active
    if not deadline_active():
        return q.get()
    while True:
        check_deadline()
        try:
            return q.get(timeout=0.25)
        except queue.Empty:
            continue


def prefetched(make_iter: Callable[[], Iterator], *, stage: str,
               depth: Optional[int] = None) -> Iterator:
    """Run ``make_iter()`` on a worker thread behind a bounded queue; yield
    its items in order here. A consumer that stops early cancels the
    worker; a worker's exception re-raises here."""
    from ..utils.node_context import current_query, query_scope
    depth = prefetch_depth() if depth is None else max(1, int(depth))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    cancel = threading.Event()
    qid = current_query()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        _WORKER_TLS.exempt = True  # under the owning task's admission
        try:
            with query_scope(qid):
                _produce()
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            with _WORKERS_LOCK:
                _STATS["stage_errors"] += 1
            put(_Failure(_attach_context(e, stage)))

    def _produce():
        it = make_iter()
        try:
            for item in it:
                with _WORKERS_LOCK:
                    _STATS["items_queued"] += 1
                if not put(item):
                    return  # the consumer is gone
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        put(_Done)

    t = threading.Thread(target=produce, daemon=True,
                         name=f"srt-prefetch:{stage}")
    with _WORKERS_LOCK:
        _WORKERS[t] = cancel
        _STATS["workers_started"] += 1
        for dead in [w for w in _WORKERS if not w.is_alive() and w is not t]:
            _WORKERS.pop(dead, None)
    t.start()
    try:
        while True:
            item = _queue_get(q)
            if item is _Done:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        cancel.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def maybe_prefetched(make_iter: Callable[[], Iterator], *, stage: str,
                     depth: Optional[int] = None) -> Iterator:
    """``prefetched`` when pipelining is on, else the plain iterator."""
    if not pipeline_enabled():
        return make_iter()
    return prefetched(make_iter, stage=stage, depth=depth)


T = TypeVar("T")
R = TypeVar("R")


def parallel_map(fn: Callable[[T], R], items: Sequence[T],
                 max_workers: Optional[int] = None,
                 stage: str = "map") -> List[R]:
    """``fn`` over ``items`` on the bounded pool, results in input order;
    the first exception re-raises once the work in flight has settled. A
    plain loop when pipelining is off or there is one item or worker. Pool
    threads run under the caller's admission (``semaphore_exempt``)."""
    items = list(items)
    workers = task_pool_size() if max_workers is None else int(max_workers)
    workers = min(max(1, workers), len(items)) if items else 1
    if not pipeline_enabled() or workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with _WORKERS_LOCK:
        _STATS["tasks_run"] += len(items)

    def run(x):
        from ..utils.deadline import check_deadline
        check_deadline()
        with exempt_admission():
            return fn(x)

    with cf.ThreadPoolExecutor(max_workers=workers,
                               thread_name_prefix=f"srt-pipeline:{stage}"
                               ) as pool:
        futs = [pool.submit(run, x) for x in items]
        try:
            return [f.result() for f in futs]
        except BaseException as e:
            for f in futs:
                f.cancel()
            raise _attach_context(e, stage)


def pipelined_collect(plan, conf=None):
    """Drain every partition of ``plan`` concurrently (at most ``taskPool``
    at a time) and concatenate in partition order: the pipelined
    replacement for ``PhysicalPlan.collect``. Each task holds the task
    semaphore for its drain; nodes that materialize shared work (exchanges,
    AQE, broadcast builds) run it once behind their own locks."""
    from ..columnar.host import HostTable
    from ..memory.semaphore import get_semaphore
    from ..plan.physical import empty_result_table
    from ..utils.node_context import current_query, query_scope

    n = plan.num_partitions
    if not pipeline_enabled() or n <= 1:
        return plan.collect()
    sem = get_semaphore(conf)
    # num_partitions may have run AQE's stages on this thread: shed every
    # hold it left, or the drains below starve at one permit
    sem.release_all()
    qid = current_query()

    def drain(p: int):
        # the query's identity is thread-local (the deadline is not): carry
        # it, so the memory profiler attributes the drain to its query
        with query_scope(qid), task_admission(), sem.task_scope():
            it = plan.execute(p)
            try:
                return list(it)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

    try:
        # the pool's threads are tasks here, not stage workers: parallel_map
        # makes them exempt, and drain() opts back into admission
        per_part = parallel_map(drain, range(n),
                                max_workers=min(task_pool_size(), n),
                                stage="collect")
    finally:
        sem.release_all()
    batches = [b for part in per_part for b in part]
    if not batches:
        return empty_result_table(plan.schema)
    return HostTable.concat(batches)
