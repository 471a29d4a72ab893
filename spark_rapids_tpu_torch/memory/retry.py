"""Structured OOM retry: retry scopes, split-and-retry and device-memory
arbitration — the port of ``spark_rapids_tpu/memory/retry.py``.

The reference routes every device allocation failure through
``DeviceMemoryEventHandler`` (spill, then retry) and gives operators
split-and-retry (``RmmRapidsRetryIterator``: halve the input batch on the
row axis, run the halves one after the other, stitch the results), so a
query degrades under memory pressure instead of dying. Every device-work
site of the port runs under this one ladder:

**Retry scopes.** ``with_retry(fn, *args)`` wraps a device-invoking
callable with classify, spill, retry; ``with_retry_split(fn, batch,
splitter=...)`` adds the split rung: when retries are spent and the
operator declared a splitter, the input batch is halved on the row axis,
the halves run one after the other (each through the same ladder) and the
results are recombined. ``oom.maxRetries`` and ``oom.maxSplits`` bound the
rungs, and the ladder ends in a structured :class:`DeviceOomError` carrying
attempts, splits, spilled bytes and the memory profiler's postmortem.

**The dispatch chokepoint.** The port has no compile cache to hook, so
every operator's batch function goes through :func:`wrap_dispatch` (the
JAX package's ``wrap_jit``): a ``with_retry`` scope named ``jit`` that
evaluates the ``alloc.jit`` fault point, as the uploads' scope evaluates
``alloc.upload``; a JAX fault spec works unchanged.

**Classification.** ``is_retryable_oom()`` is the one OOM classifier:
``torch.OutOfMemoryError`` (the caching allocator's), a ``RuntimeError`` or
``MemoryError`` whose text carries the CUDA allocator's "CUDA out of
memory" (or a CUDA call's "CUDA error: out of memory") or the CPU
allocator's "can't allocate memory", the strict pool's "cannot fit"
``MemoryError``, and a nested :class:`DeviceOomError`, so an operator-level
scope catches the inner failure and goes straight to splitting.

**Arbitration.** On a first OOM the retrying thread engages a
process-wide arbiter: while any retrier is engaged, new task admissions
through the task semaphore park on ``oom_admission_gate()`` (one
module-global check when idle), and retriers' later attempts run under an
exclusive token, so two tasks cannot starve each other into a mutual-OOM
livelock.

**Donated inputs.** PyTorch has no donated buffers to lose, but a donating
stage drops its references to an input's planes as it consumes them
(exec/wholestage.py). Upload sites attach a rematerialiser (the retained
host origin, exec/transitions.py ``mark_exclusive``); the donating ladder
rebuilds a fresh table from it and retries, and when it gives up the
:class:`DeviceOomError` carries the rematerialiser, so an enclosing split
scope can rebuild the batch and halve it.
"""
from __future__ import annotations

import functools
import gc
import sys
import threading
import time
import traceback
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..conf import (OOM_ARBITRATION, OOM_GATE_MAX_WAIT, OOM_MAX_RETRIES,
                    OOM_MAX_SPLITS)

__all__ = [
    "DeviceOomError",
    "is_retryable_oom",
    "with_retry",
    "with_retry_split",
    "wrap_dispatch",
    "wrap_dispatch_donating",
    "InjectedDeviceFailure",
    "split_device_rows",
    "split_host_rows",
    "configure_oom_retry",
    "oom_admission_gate",
    "arbiter_snapshot",
    "retry_stats",
    "drain_oom_retry_records",
    "reset_retry_state",
]


# sticky module config (configure_oom_retry; defaults match the conf
# registrations so bare unit tests get the production ladder)
_MAX_RETRIES = 2
_MAX_SPLITS = 4
_ARBITRATION = True
_GATE_WAIT_S = 30.0


def configure_oom_retry(conf) -> None:
    """Apply spark.rapids.tpu.oom.* (TorchSession start; sticky, like
    configure_memprof)."""
    global _MAX_RETRIES, _MAX_SPLITS, _ARBITRATION, _GATE_WAIT_S
    _MAX_RETRIES = int(conf.get(OOM_MAX_RETRIES))
    _MAX_SPLITS = int(conf.get(OOM_MAX_SPLITS))
    _ARBITRATION = bool(conf.get(OOM_ARBITRATION))
    _GATE_WAIT_S = float(conf.get(OOM_GATE_MAX_WAIT))


# ---------------------------------------------------------------------------
# classification: the single process-wide device-OOM test
# ---------------------------------------------------------------------------
#: Allocator substrings that mark a RuntimeError or MemoryError as a
#: device OOM: the CUDA caching allocator's message (its
#: ``torch.OutOfMemoryError`` is matched by type as well), a CUDA call's
#: ``cudaErrorMemoryAllocation``, the CPU allocator's, and the strict-pool
#: "cannot fit" MemoryError from BufferCatalog.register, without which a
#: strict pool could never retry.
_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory",
                "can't allocate memory", "cannot fit")


class InjectedDeviceFailure(RuntimeError):
    """``action=fatal`` of the ``alloc.*`` fault points: the non-retryable
    twin of ``action=oom``. It carries no OOM marker, so the ladder passes
    it through, and exec/fallback.py classifies it (``cuda_internal``): the
    one non-OOM failure of the card's own that the host fallback takes."""


class DeviceOomError(RuntimeError):
    """Device OOM that survived the full escalation ladder. Carries the
    ladder's forensics; the message embeds the catalog's OOM dump so
    operators and tests see live memory state without re-querying."""

    def __init__(self, message: str, *, scope: str = "device",
                 attempts: int = 0, splits: int = 0, spilled_bytes: int = 0,
                 postmortem_path: Optional[str] = None,
                 rematerialize: Optional[Callable[[], Any]] = None):
        super().__init__(message)
        self.scope = scope
        self.attempts = attempts
        self.splits = splits
        self.spilled_bytes = spilled_bytes
        self.postmortem_path = postmortem_path
        #: donated-input resurrection hook: an enclosing split scope can
        #: rebuild the (consumed) batch from its host origin and halve it
        self.rematerialize = rematerialize


def is_retryable_oom(e: BaseException) -> bool:
    """True when ``e`` is a device OOM the ladder can act on. A nested
    ladder's DeviceOomError is retryable at the ENCLOSING scope (the
    outer scope skips plain retries — the inner ladder exhausted them —
    and escalates straight to split)."""
    if isinstance(e, (DeviceOomError, torch.OutOfMemoryError)):
        return True
    if not isinstance(e, (RuntimeError, MemoryError)):
        return False
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


# ---------------------------------------------------------------------------
# device-memory pressure arbitration: process-wide OOM state machine
# ---------------------------------------------------------------------------
class _OomArbiter:
    """Cooperates with the task semaphore: while >= 1 retrier is engaged, new
    admissions park on :func:`oom_admission_gate` and retriers' final
    attempts serialize on a reentrant exclusive token."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._retriers: Dict[int, int] = {}   # thread ident -> engage depth
        self._token_holder: Optional[int] = None
        self._token_depth = 0

    def engage(self) -> None:
        global _GATE_ACTIVE
        me = threading.get_ident()
        with self._cond:
            self._retriers[me] = self._retriers.get(me, 0) + 1
            _GATE_ACTIVE = True

    def disengage(self) -> None:
        global _GATE_ACTIVE
        me = threading.get_ident()
        with self._cond:
            depth = self._retriers.get(me, 0) - 1
            if depth <= 0:
                self._retriers.pop(me, None)
            else:
                self._retriers[me] = depth
            if not self._retriers:
                _GATE_ACTIVE = False
                self._cond.notify_all()

    def wait_admission(self) -> None:
        """Park the calling (non-retrier) thread until no retrier is
        engaged, bounded by oom.arbitration.maxWaitSeconds."""
        from ..utils.deadline import check_deadline
        me = threading.get_ident()
        deadline = time.monotonic() + _GATE_WAIT_S
        waited = False
        with self._cond:
            if me in self._retriers:
                return  # a retrier must never gate itself (deadlock)
            while self._retriers:
                check_deadline()  # a parked admission must honor the query deadline
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # pressure valve, not a correctness lock
                waited = True
                self._cond.wait(min(remaining, 0.25))
        if waited:
            _bump("gate_waits")

    @contextmanager
    def exclusive(self):
        """Reentrant exclusive token serializing retriers' attempts."""
        me = threading.get_ident()
        with self._cond:
            while self._token_holder is not None and self._token_holder != me:
                self._cond.wait(0.25)
            self._token_holder = me
            self._token_depth += 1
        try:
            yield
        finally:
            with self._cond:
                self._token_depth -= 1
                if self._token_depth <= 0:
                    self._token_depth = 0
                    self._token_holder = None
                    self._cond.notify_all()

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            return {"active_retriers": len(self._retriers),
                    "gate_active": bool(self._retriers),
                    "token_held": self._token_holder is not None}

    def reset(self) -> None:
        global _GATE_ACTIVE
        with self._cond:
            self._retriers.clear()
            self._token_holder = None
            self._token_depth = 0
            _GATE_ACTIVE = False
            self._cond.notify_all()


_ARBITER = _OomArbiter()

#: Gate flag: False whenever no retrier is engaged, so the semaphore's
#: admission path pays one global load and a truthiness check.
_GATE_ACTIVE = False


def oom_admission_gate() -> None:
    """Called by TaskSemaphore.acquire_if_necessary before a NEW admission
    queues on the permit. No-op unless a retrier is engaged or a query
    deadline is armed (both are one module-global truthiness check)."""
    from ..utils.deadline import check_deadline
    check_deadline()
    if not _GATE_ACTIVE:
        return
    _ARBITER.wait_admission()


def arbiter_snapshot() -> Dict[str, Any]:
    return _ARBITER.snapshot()


# ---------------------------------------------------------------------------
# telemetry: counters and drainable records
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {
    "oom_retries": 0,        # plain spill-and-retry attempts
    "oom_splits": 0,         # row-axis input halvings
    "oom_rematerializations": 0,  # donated inputs rebuilt from host origin
    "oom_recoveries": 0,     # scopes that saw >=1 OOM and still succeeded
    "oom_failures": 0,       # scopes that exhausted the ladder
    "oom_spilled_bytes": 0,  # bytes freed by ladder-triggered spills
    "arbitrations": 0,       # scopes that engaged the arbiter
    "gate_waits": 0,         # admissions that parked on the gate
}
_RECORDS: List[Dict[str, Any]] = []


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + n


def retry_stats() -> Dict[str, Any]:
    """The ladder's counters and the arbiter's state."""
    with _STATS_LOCK:
        out: Dict[str, Any] = dict(_COUNTS)
    snap = _ARBITER.snapshot()
    out["active_retriers"] = snap["active_retriers"]
    out["gate_active"] = int(snap["gate_active"])
    return out


def drain_oom_retry_records() -> List[Dict[str, Any]]:
    """Pop the records of finished ladders that saw an OOM (scope,
    attempts, splits, rematerializations, spilled bytes, outcome and the
    first OOM's cause). The event-log writer that will turn each into a
    record on its query comes with the observability work."""
    global _RECORDS
    with _STATS_LOCK:
        out, _RECORDS = _RECORDS, []
    return out


def reset_retry_state() -> None:
    """Test hook: zero counters, drop pending records, reset the arbiter."""
    global _RECORDS
    with _STATS_LOCK:
        for k in list(_COUNTS):
            _COUNTS[k] = 0
        _RECORDS = []
    _ARBITER.reset()


def _memprof_event(kind: str, nbytes: int = 0) -> None:
    try:
        from ..utils import memprof
        mp = memprof.active()
        if mp is not None:
            mp.record(kind, -1, max(int(nbytes), 0))
    except Exception:  # best-effort telemetry: never break the recovery it narrates
        pass


# ---------------------------------------------------------------------------
# fault chokepoint: alloc.jit / alloc.upload with action=oom
# ---------------------------------------------------------------------------
def _maybe_inject(point: Optional[str]) -> None:
    """Deterministic synthetic failures inside the retry scope (utils/faults
    ``alloc.jit`` / ``alloc.upload``): ``action=oom`` raises a real
    ``torch.OutOfMemoryError`` with the allocator's words, so the ladder
    under test is the production ladder; ``action=fatal`` raises
    :class:`InjectedDeviceFailure`."""
    if point is None:
        return
    from ..utils import faults
    action = faults.fire(point)
    if action is None or action == "delay":
        return
    if action == "oom":
        raise torch.OutOfMemoryError(
            f"CUDA out of memory. Injected device OOM at {point} "
            f"(faults action=oom)")
    if action == "fatal":
        raise InjectedDeviceFailure(
            f"CUDA error: injected non-retryable device failure at {point} "
            f"(faults action=fatal)")
    raise faults.FaultInjectedError(point, action)


# ---------------------------------------------------------------------------
# the escalation ladder
# ---------------------------------------------------------------------------
class _Ladder:
    """Per-scope mutable ladder state: OOM attempts seen, splits spent,
    bytes spilled, arbiter engagement. One _Ladder spans a whole
    with_retry/with_retry_split call including recursive half-runs, so
    the split budget is global to the scope, not per level."""

    __slots__ = ("scope", "context", "fault_point", "attempts", "splits",
                 "spilled_bytes", "remats", "engaged", "closed", "last_error",
                 "first_error")

    def __init__(self, scope: str, context: Optional[str],
                 fault_point: Optional[str]):
        self.scope = scope
        self.context = context or scope
        self.fault_point = fault_point
        self.attempts = 0
        self.splits = 0
        self.spilled_bytes = 0
        self.remats = 0
        self.engaged = False
        self.closed = False
        self.last_error: Optional[BaseException] = None
        self.first_error: Optional[BaseException] = None

    def note_oom(self, e: BaseException) -> None:
        self.attempts += 1
        self.last_error = e
        if self.first_error is None:
            self.first_error = e
        if _ARBITRATION and not self.engaged:
            self.engaged = True
            _ARBITER.engage()
            _bump("arbitrations")

    def spill(self) -> int:
        """One synchronous-spill rung: catalog OOM callbacks and spill, then
        the collector, and the caching allocator's free blocks returned to
        CUDA. -> the bytes freed (on the card, the collector's too)."""
        from .catalog import get_catalog
        catalog = get_catalog()
        freed = catalog.handle_device_oom(
            context=f"oom-retry[{self.scope}]: "
                    f"{repr(self.last_error)[:160]}")
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        before = torch.cuda.memory_allocated() if cuda else 0
        # a reference cycle (a finished plan, an exception and its frames)
        # holds its tensors until the collector runs
        gc.collect()
        if cuda:
            freed += max(0, before - torch.cuda.memory_allocated())
            # what the dropped references left in the caching allocator's
            # pool, returned to CUDA for an allocation of another size
            torch.cuda.empty_cache()
        if freed > 0:
            self.spilled_bytes += freed
            _bump("oom_spilled_bytes", freed)
        return freed

    def note_retry(self) -> None:
        _bump("oom_retries")
        from ..utils import faults
        faults.note_recovery("oom_retries")
        _memprof_event("oom_retry")
        print(f"# device OOM in {self.scope}: spilled, retrying "
              f"(attempt {self.attempts})", file=sys.stderr)

    def note_split(self, batch: Any) -> None:
        self.splits += 1
        _bump("oom_splits")
        from ..utils import faults
        faults.note_recovery("oom_splits")
        try:
            nbytes = batch.nbytes()
        except Exception:  # a size probe for telemetry; the split proceeds
            nbytes = 0
        _memprof_event("oom_split", nbytes)
        print(f"# device OOM in {self.scope}: splitting input on the row "
              f"axis (split {self.splits}/{_MAX_SPLITS})", file=sys.stderr)

    def note_remat(self) -> None:
        self.remats += 1
        _bump("oom_rematerializations")

    def exclusive(self):
        """Exclusive-memory token for post-OOM attempts; no-op before the
        first OOM or with arbitration disabled."""
        if self.engaged:
            return _ARBITER.exclusive()
        return nullcontext()

    def structured_error(self, rematerialize: Optional[Callable] = None
                         ) -> DeviceOomError:
        from .catalog import get_catalog
        catalog = get_catalog()
        pm_path = None
        try:
            from ..utils import memprof
            mp = memprof.active()
            if mp is not None:
                pm_path = mp.oom_postmortem(
                    f"oom-retry exhausted [{self.scope}]: {self.context}",
                    catalog).get("path")
        except Exception:  # the DeviceOomError is raised regardless
            pm_path = None
        msg = (f"device OOM in scope {self.scope!r} survived the retry "
               f"ladder: {self.attempts} attempt(s), {self.splits} "
               f"split(s), {self.spilled_bytes} bytes spilled"
               + (f"; postmortem: {pm_path}" if pm_path else "")
               + "; " + catalog.oom_dump())
        return DeviceOomError(msg, scope=self.scope, attempts=self.attempts,
                              splits=self.splits,
                              spilled_bytes=self.spilled_bytes,
                              postmortem_path=pm_path,
                              rematerialize=rematerialize)

    def close(self, ok: bool) -> None:
        if self.closed:
            return
        self.closed = True
        if self.engaged:
            _ARBITER.disengage()
        if self.attempts == 0 and self.splits == 0:
            return
        _bump("oom_recoveries" if ok else "oom_failures")
        rec = {"ts": time.time(), "scope": self.scope,
               "context": (self.context or "")[:200],
               "attempts": self.attempts, "splits": self.splits,
               "rematerializations": self.remats,
               "spilled_bytes": self.spilled_bytes,
               "outcome": "recovered" if ok else "failed",
               "cause": type(self.first_error).__name__
               if self.first_error is not None else None,
               "cause_message": str(self.first_error)[:200]
               if self.first_error is not None else None}
        with _STATS_LOCK:
            _RECORDS.append(rec)


def _release_frames(e: BaseException) -> None:
    """Clear the locals of the finished frames that a failed call left in
    ``e``'s traceback, and in its causes': the intermediate tensors of the
    failed dispatch would otherwise stay allocated while the ladder
    spills, retries and splits (XLA frees a failed program's buffers;
    PyTorch frees a tensor when its last reference goes)."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__


def _invoke(lad: _Ladder, fn: Callable, args: tuple, kwargs: dict):
    # cooperative cancellation checkpoint: every ladder-protected device
    # dispatch passes here, so a query past its deadline stops BEFORE its
    # next device call instead of thrashing the spill/retry rungs
    from ..utils.deadline import check_deadline
    check_deadline()
    with lad.exclusive():
        _maybe_inject(lad.fault_point)
        return fn(*args, **kwargs)


def with_retry(fn: Callable, *args, scope: str = "device",
               context: Optional[str] = None,
               fault_point: Optional[str] = None,
               max_retries: Optional[int] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the spill-and-retry ladder (no
    split rung — for unsplittable work: broadcast build sides, device
    concat, a dispatch). Raises :class:`DeviceOomError` on exhaustion;
    non-OOM exceptions pass through untouched."""
    lad = _Ladder(scope, context, fault_point)
    retries = _MAX_RETRIES if max_retries is None else max_retries
    try:
        while True:
            try:
                out = _invoke(lad, fn, args, kwargs)
            except Exception as e:
                if not is_retryable_oom(e):
                    raise
                _release_frames(e)
                lad.note_oom(e)
                freed = lad.spill()
                # a nested ladder already exhausted ITS retries; retrying
                # identical work after a zero-byte spill cannot succeed
                if (isinstance(e, DeviceOomError) or freed <= 0
                        or lad.attempts > retries):
                    raise lad.structured_error() from e
                lad.note_retry()
                continue
            lad.close(True)
            return out
    except BaseException:
        lad.close(False)
        raise


def with_retry_split(fn: Callable, batch, *, splitter: Optional[Callable],
                     combiner: Optional[Callable] = None,
                     scope: str = "device", context: Optional[str] = None,
                     fault_point: Optional[str] = None,
                     max_retries: Optional[int] = None,
                     max_splits: Optional[int] = None):
    """Run ``fn(batch)`` under the full ladder: spill → retry →
    split-and-retry. ``splitter(batch)`` returns two row-axis halves (or
    None when the batch is too small to split); halves run sequentially
    through the same ladder and ``combiner(outputs)`` recombines them
    (default: ``concat_device_tables``). Operators whose output is not
    row-concatenable (partial aggregates, sorted runs) pass a combiner
    that re-applies their merge."""
    lad = _Ladder(scope, context, fault_point)
    retries = _MAX_RETRIES if max_retries is None else max_retries
    msplits = _MAX_SPLITS if max_splits is None else max_splits
    comb = combiner if combiner is not None else _concat_combine
    try:
        out = _run_split(lad, fn, batch, splitter, comb, retries, msplits)
        lad.close(True)
        return out
    except BaseException:
        lad.close(False)
        raise


def _run_split(lad: _Ladder, fn: Callable, batch, splitter, comb,
               retries: int, msplits: int):
    attempts_here = 0
    while True:
        try:
            return _invoke(lad, fn, (batch,), {})
        except Exception as e:
            if not is_retryable_oom(e):
                raise
            _release_frames(e)
            structured = isinstance(e, DeviceOomError)
            lad.note_oom(e)
            freed = lad.spill()
            if not structured and freed > 0 and attempts_here < retries:
                attempts_here += 1
                lad.note_retry()
                continue
            # escalate: split-and-retry. A donated batch was consumed by
            # the failed dispatch — resurrect it from the host origin the
            # inner ladder handed back before slicing.
            live = batch
            if structured and e.rematerialize is not None:
                live = e.rematerialize()
                lad.note_remat()
            halves = None
            if splitter is not None and lad.splits < msplits:
                halves = splitter(live)
            if halves is None:
                raise lad.structured_error() from e
            lad.note_split(live)
            outs = [_run_split(lad, fn, half, splitter, comb,
                               retries, msplits) for half in halves]
            return comb(outs)


# ---------------------------------------------------------------------------
# splitters / combiners
# ---------------------------------------------------------------------------
def split_device_rows(table):
    """Row-axis halving for DeviceTable inputs: two slices on the
    (pow2-bucketed) capacity axis, so the halves land back on the bucket
    ladder. Returns None for capacity-1 tables (cannot shrink further)."""
    cap = getattr(table, "capacity", 0)
    if cap <= 1:
        return None
    from ..columnar.device import slice_rows
    # slice_rows masks off rows past the active count, which assumes the
    # active rows are contiguous from row 0 — compact scattered masks first
    table = table.compact()
    half = cap // 2
    return (slice_rows(table, 0, half),
            slice_rows(table, half, cap - half))


def split_host_rows(table):
    """Row-axis halving for HostTable inputs (the H2D upload scope —
    splitting BEFORE upload halves the transfer's device footprint)."""
    n = getattr(table, "num_rows", 0)
    if n <= 1:
        return None
    half = n // 2
    return (table.slice(0, half), table.slice(half, n - half))


def _concat_combine(outs: Sequence[Any]):
    """Default combiner: row-concat the half outputs back into one device
    table (valid for row-wise operators, project/filter/whole-stage chains,
    where f(a ++ b) == f(a) ++ f(b), and for partial aggregates, whose
    states the final aggregate merges)."""
    outs = [o for o in outs if o is not None]
    if len(outs) == 1:
        return outs[0]
    from ..columnar.device import concat_device_tables
    return concat_device_tables(outs)


# ---------------------------------------------------------------------------
# the dispatch chokepoint (the JAX package's wrap_jit / wrap_jit_donating)
# ---------------------------------------------------------------------------
def wrap_dispatch(fn: Callable, context: Optional[str] = None) -> Callable:
    """Spill-and-retry OOM recovery around one operator's batch function
    (reference: DeviceMemoryEventHandler.scala:33). Splitting stays at the
    operator layer: this wrapper raises a retryable :class:`DeviceOomError`
    on exhaustion, which an enclosing with_retry_split scope escalates to
    split-and-retry."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return with_retry(fn, *args, scope="jit",
                          context=context or getattr(fn, "__name__", "jit"),
                          fault_point="alloc.jit", **kwargs)
    return wrapped


def wrap_dispatch_donating(fn: Callable, context: Optional[str] = None
                           ) -> Callable:
    """OOM recovery for a donating dispatch: the failed call may already
    have dropped the input's planes, so instead of re-calling with them the
    ladder rebuilds a fresh table from the host origin the upload site kept
    (``table._srt_remat``, exec/transitions.py) and retries with that.
    Without a rematerialiser: spill for later batches, then a structured
    failure."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        remat = getattr(args[0], "_srt_remat", None) if args else None
        lad = _Ladder("jit-donate",
                      context or getattr(fn, "__name__", "jit-donate"),
                      "alloc.jit")
        try:
            out = _run_donating(lad, fn, args, kwargs, remat)
            lad.close(True)
            return out
        except BaseException:
            lad.close(False)
            raise
    return wrapped


def _run_donating(lad: _Ladder, fn: Callable, args: tuple, kwargs: dict,
                  remat: Optional[Callable]):
    cur = args
    while True:
        try:
            return _invoke(lad, fn, cur, kwargs)
        except Exception as e:
            if not is_retryable_oom(e):
                raise
            _release_frames(e)
            lad.note_oom(e)
            freed = lad.spill()
            if remat is None:
                # input buffers are gone and cannot be rebuilt: spill
                # relieved pressure for SUBSEQUENT batches, but this one
                # is unrecoverable at this layer
                print("# device OOM in donating dispatch: input was "
                      "donated and no host origin was retained; "
                      "structured failure after spill", file=sys.stderr)
                raise lad.structured_error() from e
            if freed <= 0 or lad.attempts > _MAX_RETRIES:
                raise lad.structured_error(rematerialize=remat) from e
            fresh = remat()
            lad.note_remat()
            lad.note_retry()
            cur = (fresh,) + tuple(args[1:])
