"""Query deadlines and cooperative cancellation — the port of
``spark_rapids_tpu/utils/deadline.py``.

``spark.rapids.tpu.query.timeoutSeconds`` arms a process-wide deadline
around each ``DataFrame.collect``. Cancellation is cooperative: the
runtime's yield points (the retry ladder's dispatch chokepoint,
memory/retry.py ``_invoke``, and the OOM arbitration gate) call
:func:`check_deadline`, one module-global truthiness check when no deadline
is armed. The first checkpoint past the deadline raises a
:class:`QueryTimeoutError`; the retry ladder passes it through untouched
(its message holds no OOM marker), the host fallback never takes it, and
``collect``'s task scope releases the semaphore.

Forensics: the first expiry writes one JSON dump (semaphore holders and
waiters, the OOM arbiter's state, and the memory profiler's postmortem
path when profiling is on) to the system temp dir
(``health.reportDir`` comes with the observability layer), and every
QueryTimeoutError raised for that deadline carries its path.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from ..conf import QUERY_TIMEOUT

__all__ = [
    "QUERY_TIMEOUT",
    "QueryTimeoutError",
    "deadline_scope",
    "check_deadline",
    "deadline_active",
    "deadline_stats",
    "reset_deadline",
]

class QueryTimeoutError(RuntimeError):
    """A query exceeded spark.rapids.tpu.query.timeoutSeconds and was
    cancelled cooperatively. The message intentionally contains no OOM
    marker substring so the retry ladder (memory/retry.py
    ``is_retryable_oom``) passes it straight through."""

    def __init__(self, timeout_s: float, elapsed_s: float,
                 forensics_path: Optional[str] = None):
        msg = (f"query exceeded its deadline: {elapsed_s:.2f}s elapsed > "
               f"spark.rapids.tpu.query.timeoutSeconds={timeout_s:g}"
               + (f"; forensics: {forensics_path}" if forensics_path else ""))
        super().__init__(msg)
        self.timeout_s = timeout_s
        self.elapsed_s = elapsed_s
        self.forensics_path = forensics_path


# module deadline state: _ACTIVE is the flag every check_deadline() call
# loads; the rest only matters while armed. The deadline is process-global:
# it guards the process-global semaphore and arbiter, and one session
# collects at a time.
_ACTIVE = False
_DEADLINE_MONO = 0.0
_TIMEOUT_S = 0.0
_STARTED_MONO = 0.0
_REPORT_DIR = ""
_FIRED_PATH: Optional[str] = None
_FIRE_LOCK = threading.Lock()
_STATS_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {"deadlines_armed": 0, "deadline_expiries": 0}


def deadline_active() -> bool:
    return _ACTIVE


def check_deadline() -> None:
    """Cooperative cancellation checkpoint. One global truthiness check
    when no deadline is armed; raises QueryTimeoutError past expiry."""
    if not _ACTIVE:
        return
    if time.monotonic() >= _DEADLINE_MONO:
        raise _timeout_error()


def _timeout_error() -> QueryTimeoutError:
    elapsed = time.monotonic() - _STARTED_MONO
    global _FIRED_PATH
    with _FIRE_LOCK:
        if _FIRED_PATH is None:
            with _STATS_LOCK:
                _COUNTS["deadline_expiries"] += 1
            _FIRED_PATH = _write_forensics(elapsed) or ""
    return QueryTimeoutError(_TIMEOUT_S, elapsed,
                             forensics_path=_FIRED_PATH or None)


def _write_forensics(elapsed_s: float) -> Optional[str]:
    """One dump per armed deadline: what a postmortem of a wedged query
    needs, gathered best-effort (forensics must never mask the timeout
    itself)."""
    dump: Dict[str, Any] = {
        "ts": time.time(),
        "timeout_s": _TIMEOUT_S,
        "elapsed_s": round(elapsed_s, 3),
    }
    try:
        from ..memory.semaphore import peek_semaphore
        sem = peek_semaphore()
        dump["semaphore"] = sem.dump() if sem is not None else None
    except Exception:
        dump["semaphore"] = None
    try:
        from ..memory.retry import arbiter_snapshot
        dump["oom_arbiter"] = arbiter_snapshot()
    except Exception:
        dump["oom_arbiter"] = None
    try:
        from . import memprof
        mp = memprof.active()
        if mp is not None:
            from ..memory.catalog import get_catalog
            dump["memprof_postmortem"] = mp.oom_postmortem(
                f"query deadline expired after {elapsed_s:.2f}s",
                get_catalog()).get("path")
        else:
            dump["memprof_postmortem"] = None
    except Exception:
        dump["memprof_postmortem"] = None
    directory = _REPORT_DIR or tempfile.gettempdir()
    path = os.path.join(directory,
                        f"deadline-{os.getpid()}-{int(time.time() * 1000)}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dump, f, indent=1, sort_keys=True)
    except OSError:
        return None
    return path


@contextmanager
def deadline_scope(timeout_s: float, report_dir: str = ""):
    """Arm the process-wide query deadline for the duration of one
    collect. ``timeout_s <= 0`` is a no-op (the common case)."""
    global _ACTIVE, _DEADLINE_MONO, _TIMEOUT_S, _STARTED_MONO, \
        _REPORT_DIR, _FIRED_PATH
    if not timeout_s or timeout_s <= 0:
        yield
        return
    now = time.monotonic()
    _TIMEOUT_S = float(timeout_s)
    _STARTED_MONO = now
    _DEADLINE_MONO = now + float(timeout_s)
    _REPORT_DIR = report_dir or ""
    _FIRED_PATH = None
    _ACTIVE = True
    with _STATS_LOCK:
        _COUNTS["deadlines_armed"] += 1
    try:
        yield
    finally:
        _ACTIVE = False
        _FIRED_PATH = None


def deadline_stats() -> Dict[str, Any]:
    """Deadline counters."""
    with _STATS_LOCK:
        out: Dict[str, Any] = dict(_COUNTS)
    out["deadline_armed"] = int(_ACTIVE)
    return out


def reset_deadline() -> None:
    """Test hook: disarm and zero counters."""
    global _ACTIVE, _FIRED_PATH
    _ACTIVE = False
    _FIRED_PATH = None
    with _STATS_LOCK:
        for k in list(_COUNTS):
            _COUNTS[k] = 0
