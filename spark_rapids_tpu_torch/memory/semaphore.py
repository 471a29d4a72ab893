"""The task semaphore: per-device task admission control — the port of
``spark_rapids_tpu/memory/semaphore.py`` (reference:
GpuSemaphore.scala:27,58,74 and spark.rapids.sql.concurrentGpuTasks).

Over-admission on a GPU ends in device OOM, so a task acquires before its
first device dispatch and releases when it is done. The pipelined collect
(parallel/pipeline.py) holds ``task_scope()`` around each partition's
drain; its stage workers run under their task's admission and take none.

Every hold is attributed: the holder's thread name and acquire time are
recorded per task, final releases feed a held-duration histogram, and
``dump()`` snapshots holders and the wait queue (a query deadline's
forensics, an OOM postmortem). A new admission first parks on the OOM
arbitration gate (memory/retry.py) while a thread retries after an OOM.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from ..conf import CONCURRENT_GPU_TASKS, RapidsConf
from ..utils.metrics import Histogram
from .retry import oom_admission_gate

__all__ = ["TaskSemaphore", "get_semaphore", "peek_semaphore"]


class _Hold:
    """One task's live permit hold (reentrant depth + attribution)."""

    __slots__ = ("depth", "thread_name", "thread_id", "acquired_at")

    def __init__(self, thread_name: str, thread_id: int, acquired_at: float):
        self.depth = 1
        self.thread_name = thread_name
        self.thread_id = thread_id
        self.acquired_at = acquired_at


class TaskSemaphore:
    def __init__(self, permits: int = 1):
        self.permits = permits
        self._sem = threading.BoundedSemaphore(permits)
        self._holders: Dict[int, _Hold] = {}  # task/thread id -> hold
        self._waiters: Dict[int, Tuple[str, float]] = {}  # id -> (name, t0)
        self._lock = threading.Lock()
        self.total_wait_time = 0.0
        self.acquire_count = 0
        #: distribution of full-hold durations (acquire -> final release);
        #: a fat tail here is the first hint of a permit-hogging operator
        self.held_histogram = Histogram("semaphoreHeldSeconds")

    def acquire_if_necessary(self, task_id: Optional[int] = None):
        """Reentrant per task (reference: acquireIfNecessary semantics).
        A pipeline worker runs under its task's admission and takes none
        (parallel/pipeline.py ``semaphore_exempt``)."""
        from ..parallel.pipeline import semaphore_exempt
        if semaphore_exempt():
            return
        tid = task_id if task_id is not None else threading.get_ident()
        with self._lock:
            hold = self._holders.get(tid)
            if hold is not None:
                hold.depth += 1
                return
        # device-memory arbitration (memory/retry.py): while a thread is
        # retrying after device OOM, NEW admissions park here so the
        # retrier's final attempts get the device's memory to themselves.
        # One module-global check when no retrier is engaged.
        oom_admission_gate()
        thread = threading.current_thread()
        t0 = time.perf_counter()
        with self._lock:
            self._waiters[tid] = (thread.name, time.monotonic())
        try:
            self._sem.acquire()
        finally:
            with self._lock:
                self._waiters.pop(tid, None)
        with self._lock:
            self.total_wait_time += time.perf_counter() - t0
            self.acquire_count += 1
            self._holders[tid] = _Hold(thread.name, thread.ident or 0,
                                       time.monotonic())

    def release_if_held(self, task_id: Optional[int] = None):
        # symmetric with acquire_if_necessary: an exempt scope never drops
        # the owning task's permit
        from ..parallel.pipeline import semaphore_exempt
        if semaphore_exempt():
            return
        tid = task_id if task_id is not None else threading.get_ident()
        with self._lock:
            hold = self._holders.get(tid)
            if hold is None:
                return
            if hold.depth > 1:
                hold.depth -= 1
                return
            del self._holders[tid]
            held_s = time.monotonic() - hold.acquired_at
        self.held_histogram.observe(held_s)
        self._sem.release()

    def release_all(self, task_id: Optional[int] = None):
        """Task-completion release: drop every hold this task accumulated
        (reference: GpuSemaphore's task-completion listener releases the
        whole hold, GpuSemaphore.scala), so a thread never carries a hold
        into its next task."""
        tid = task_id if task_id is not None else threading.get_ident()
        with self._lock:
            hold = self._holders.pop(tid, None)
        if hold is not None:
            self.held_histogram.observe(time.monotonic() - hold.acquired_at)
            self._sem.release()

    @contextmanager
    def held(self, task_id: Optional[int] = None):
        self.acquire_if_necessary(task_id)
        try:
            yield
        finally:
            self.release_if_held(task_id)

    @contextmanager
    def task_scope(self, task_id: Optional[int] = None):
        """One task's admission window: acquire on entry, release ALL
        holds on exit (see release_all)."""
        self.acquire_if_necessary(task_id)
        try:
            yield
        finally:
            self.release_all(task_id)

    def drain_scope(self, task_id: Optional[int] = None):
        """A partition drain's admission: the task's scope, or, when the
        task already holds a permit (a drain inside a drain), one more
        reentrant hold, so the inner drain leaves the outer hold alone."""
        tid = task_id if task_id is not None else threading.get_ident()
        with self._lock:
            held = tid in self._holders
        return self.held(task_id) if held else self.task_scope(task_id)

    # -- introspection --------------------------------------------------------
    def holder_count(self) -> int:
        with self._lock:
            return len(self._holders)

    def waiter_count(self) -> int:
        with self._lock:
            return len(self._waiters)

    def dump(self) -> Dict:
        """Live admission state: per-holder thread name/depth/held-duration
        and the wait queue."""
        now = time.monotonic()
        with self._lock:
            holders = [{"task_id": tid, "thread": h.thread_name,
                        "thread_id": h.thread_id, "depth": h.depth,
                        "held_s": round(now - h.acquired_at, 3)}
                       for tid, h in self._holders.items()]
            waiters = [{"task_id": tid, "thread": name,
                        "waiting_s": round(now - since, 3)}
                       for tid, (name, since) in self._waiters.items()]
            out = {"permits": self.permits,
                   "available": max(0, self.permits - len(holders)),
                   "holders": holders, "waiters": waiters,
                   "total_wait_s": round(self.total_wait_time, 6),
                   "acquires": self.acquire_count}
        out["held_seconds"] = self.held_histogram.snapshot()
        return out


_GLOBAL: Optional[TaskSemaphore] = None
_LOCK = threading.Lock()


def get_semaphore(conf: Optional[RapidsConf] = None) -> TaskSemaphore:
    """The process semaphore, made on first use with the permits of
    ``conf``; a session with another ``concurrentGpuTasks`` replaces it
    once no task holds or waits for a permit."""
    global _GLOBAL
    with _LOCK:
        permits = int((conf or RapidsConf()).get(CONCURRENT_GPU_TASKS))
        if _GLOBAL is None or (conf is not None
                               and _GLOBAL.permits != permits
                               and not _GLOBAL.holder_count()
                               and not _GLOBAL.waiter_count()):
            _GLOBAL = TaskSemaphore(permits)
        return _GLOBAL


def peek_semaphore() -> Optional[TaskSemaphore]:
    """The global semaphore if one exists; never makes one."""
    with _LOCK:
        return _GLOBAL
