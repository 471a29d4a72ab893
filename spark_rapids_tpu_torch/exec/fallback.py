"""Runtime degradation: host fallback and operator quarantine — the port
of ``spark_rapids_tpu/exec/fallback.py``.

A query never dies because the device path could not run it: unsupported
operators go to the host at plan time (plan/overrides.py), and this module
carries that to run time. When a device operator's dispatch fails
terminally (the OOM ladder exhausted, :class:`~..memory.retry.
DeviceOomError`, a CUDA library that could not allocate its workspace,
or the injected ``action=fatal``) the batch is downloaded, run through the
host engine's implementation of the same operator and uploaded again, so
the query degrades per operator instead of failing. It is loud: every use
prints a line on stderr, bumps the recovery ledger's ``host_fallbacks`` and
leaves a record (``drain_fallback_records``). Any other error a torch call
raises on the card (an invalid launch configuration, a dtype an operation
does not implement, a generic "CUDA error") is the port's own fault and
re-raises.

Three failures never fall back, nor are they noted in the quarantine
store; they re-raise:

- a **sticky** CUDA error (an illegal address, a device-side assert, a
  launch failure, ...) leaves the CUDA context unusable, so nothing after
  it can run on the device or download the batch. Kernel errors surface
  asynchronously, at the next synchronising call, so the failure may be
  charged to a later operator; it re-raises all the same;
- a failure to build, load or launch a hand-written kernel (native.py, a
  wrapper's "kernel launch failed"): the fallback must never hide a
  kernel;
- any failure of an operator whose batch may call a kernel's wrapper
  (``TpuExec.runs_kernel``: a LIKE on ``nfa_match``, two-limb decimal
  arithmetic and sums, a columnar UDF, ...), for the same reason: its
  work is never moved to the host, at run time or by the quarantine.

**Quarantine.** Repeated fallbacks cost a failure and a recovery each time.
The process-wide store, keyed by (operator class, plan-signature hash,
failure class), counts them; once a key reaches
``spark.rapids.tpu.fallback.quarantine.threshold`` the planner's
quarantine pass (plan/overrides.py) routes the operator to the host at
plan time, and ``explain`` shows the reason. Entries expire after
``quarantine.ttlSeconds``; the store keeps at most
``quarantine.maxEntries``, the oldest evicted first. The JAX package
persists it beside its compile cache's manifest; the port has no such
cache, so the store lives for the process, as the JAX store does with its
persistent tier off.
"""
from __future__ import annotations

import hashlib
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..conf import (FALLBACK_ENABLED, QUARANTINE_ENABLED,
                    QUARANTINE_MAX_ENTRIES, QUARANTINE_THRESHOLD,
                    QUARANTINE_TTL)
from ..native import KernelBuildError

__all__ = [
    "with_host_fallback",
    "quarantine_on_failure",
    "classify_failure",
    "configure_fallback",
    "quarantine_entries",
    "quarantine_reason",
    "note_quarantine",
    "plan_quarantine_pass",
    "fallback_stats",
    "drain_fallback_records",
    "reset_fallback_state",
]

# sticky module config (configure_fallback; defaults match the conf
# registrations so bare unit tests get the production behavior)
_ENABLED = True
_Q_ENABLED = True
_Q_THRESHOLD = 3
_Q_TTL_S = 86400.0
_Q_MAX = 256


# ---------------------------------------------------------------------------
# failure classification: which terminal errors are fallback-eligible
# ---------------------------------------------------------------------------
#: Messages of sticky CUDA errors: the context is unusable after one, so
#: nothing may run on the device again in this process (not even the
#: download a fallback needs).
_STICKY_MARKERS = (
    "illegal memory access", "an illegal instruction was encountered",
    "misaligned address", "device-side assert triggered",
    "unspecified launch failure", "the launch timed out",
    "uncorrectable ECC error", "hardware stack error",
    "operation not permitted when stream is capturing",
)

#: A hand-written kernel wrapper's launch check (its build and load raise
#: native.py's KernelBuildError): never hidden by a fallback.
_KERNEL_MARKERS = ("kernel launch failed",)

#: (named status, failure class) of the non-sticky CUDA failures a host
#: rerun may take: a CUDA library that could not allocate its workspace.
_CUDA_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("CUBLAS_STATUS_ALLOC_FAILED", "cuda_library"),
    ("CUSOLVER_STATUS_ALLOC_FAILED", "cuda_library"),
    ("CUFFT_ALLOC_FAILED", "cuda_library"),
    ("CUDNN_STATUS_ALLOC_FAILED", "cuda_library"),
)


def is_sticky_cuda_error(e: BaseException) -> bool:
    """Whether ``e`` is a sticky CUDA error (the context is lost)."""
    msg = str(e)
    return any(m in msg for m in _STICKY_MARKERS)


def classify_failure(e: BaseException) -> Optional[str]:
    """The failure class when ``e`` is a terminal device failure the
    host-fallback boundary may recover from, else None (re-raise).

    Eligible: the ladder's DeviceOomError (``oom_exhausted``), the
    injected ``action=fatal`` (``cuda_internal``), a named CUDA library
    allocation failure and a raw retryable OOM (``oom``: the ladder inside
    ``device_fn`` normally ends one in a DeviceOomError). Never eligible: a
    :class:`QueryTimeoutError` (the query is being cancelled, not rescued),
    a sticky CUDA error, a hand-written kernel's build, load or launch
    failure, and every other error."""
    from ..utils.deadline import QueryTimeoutError
    if isinstance(e, (QueryTimeoutError, KernelBuildError)):
        return None
    from ..memory.retry import (DeviceOomError, InjectedDeviceFailure,
                                is_retryable_oom)
    cause = e
    while isinstance(cause, DeviceOomError) and cause.__cause__ is not None:
        cause = cause.__cause__
    if is_sticky_cuda_error(cause):
        return None
    if isinstance(e, DeviceOomError):
        return "oom_exhausted"
    if isinstance(e, InjectedDeviceFailure):
        return "cuda_internal"
    if not isinstance(e, RuntimeError):
        return None
    msg = str(e)
    if any(m in msg for m in _KERNEL_MARKERS):
        return None
    for marker, cls in _CUDA_CLASSES:
        if marker in msg:
            return cls
    if is_retryable_oom(e):
        return "oom"
    return None


# ---------------------------------------------------------------------------
# telemetry: counters and drainable records
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()
_COUNTS: Dict[str, Any] = {
    "host_fallbacks": 0,        # batches re-executed through the host engine
    "fallback_bytes_down": 0,   # D2H bytes moved for fallback inputs
    "fallback_bytes_up": 0,     # H2D bytes re-uploaded after host execution
    "fallback_failures": 0,     # terminal failures with no host path (re-raised)
    "quarantine_notes": 0,      # fallback events folded into the store
    "quarantine_plan_routes": 0,  # nodes the planner routed to host
}
_RECORDS: List[Dict[str, Any]] = []


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + n


def fallback_stats() -> Dict[str, Any]:
    """The fallback counters and the store's size."""
    with _STATS_LOCK:
        out: Dict[str, Any] = dict(_COUNTS)
    out["quarantine_entries"] = _QUARANTINE.size()
    return out


def drain_fallback_records() -> List[Dict[str, Any]]:
    """Pop the records of completed fallbacks (operator, context, failure
    class, reason, rows, bytes down and up, wall)."""
    global _RECORDS
    with _STATS_LOCK:
        out, _RECORDS = _RECORDS, []
    return out


def reset_fallback_state() -> None:
    """Test hook: zero counters, drop pending records, clear the
    quarantine store."""
    global _RECORDS
    with _STATS_LOCK:
        for k in list(_COUNTS):
            _COUNTS[k] = 0
        _RECORDS = []
    _QUARANTINE.clear()


# ---------------------------------------------------------------------------
# quarantine store
# ---------------------------------------------------------------------------
def _sig_hash(plan_signature: str) -> str:
    return hashlib.sha256(plan_signature.encode("utf-8")).hexdigest()[:16]


class _QuarantineStore:
    """(operator class, plan-signature hash, failure class) -> fallback
    count + last-seen + reason. TTL-pruned on lookup, bounded by
    maxEntries (oldest last_ts evicted first)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}

    @staticmethod
    def key(operator: str, sig_hash: str, failure_class: str) -> str:
        return f"{operator}|{sig_hash}|{failure_class}"

    def note(self, operator: str, sig_hash: str, failure_class: str,
             reason: str) -> int:
        """Fold one terminal device failure in; returns the new count."""
        now = time.time()
        k = self.key(operator, sig_hash, failure_class)
        with self._lock:
            ent = self._entries.get(k)
            if ent is None:
                ent = {"operator": operator, "sig_hash": sig_hash,
                       "failure_class": failure_class, "count": 0,
                       "first_ts": now, "last_ts": now, "reason": ""}
                self._entries[k] = ent
            ent["count"] += 1
            ent["last_ts"] = now
            ent["reason"] = reason[:200]
            self._evict_locked(now)
            return ent["count"]

    def check(self, operator: str, sig_hash: str) -> Optional[str]:
        """The quarantine reason when ANY failure class for (operator,
        sig) crossed the threshold and is not expired, else None."""
        now = time.time()
        with self._lock:
            self._prune_locked(now)
            for ent in self._entries.values():
                if (ent["operator"] == operator
                        and ent["sig_hash"] == sig_hash
                        and ent["count"] >= _Q_THRESHOLD):
                    return (f"{ent['count']} runtime "
                            f"{ent['failure_class']} failure(s), last: "
                            f"{ent['reason']}")
        return None

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def _prune_locked(self, now: float) -> None:
        dead = [k for k, e in self._entries.items()
                if now - e["last_ts"] > _Q_TTL_S]
        for k in dead:
            del self._entries[k]

    def _evict_locked(self, now: float) -> None:
        self._prune_locked(now)
        while len(self._entries) > _Q_MAX:
            oldest = min(self._entries, key=lambda k: self._entries[k]["last_ts"])
            del self._entries[oldest]


_QUARANTINE = _QuarantineStore()


def configure_fallback(conf) -> None:
    """Apply spark.rapids.tpu.fallback.* (TorchSession start; sticky).
    Nothing is loaded: the store lives for the process."""
    global _ENABLED, _Q_ENABLED, _Q_THRESHOLD, _Q_TTL_S, _Q_MAX
    _ENABLED = bool(conf.get(FALLBACK_ENABLED))
    _Q_ENABLED = bool(conf.get(QUARANTINE_ENABLED))
    _Q_THRESHOLD = int(conf.get(QUARANTINE_THRESHOLD))
    _Q_TTL_S = float(conf.get(QUARANTINE_TTL))
    _Q_MAX = int(conf.get(QUARANTINE_MAX_ENTRIES))


def quarantine_entries() -> List[Dict[str, Any]]:
    return _QUARANTINE.entries()


def quarantine_reason(operator: str, plan_signature: str) -> Optional[str]:
    """The quarantine reason for a (device operator class, plan
    signature), or None. Zero store lookups when quarantine is idle."""
    if not (_ENABLED and _Q_ENABLED) or _QUARANTINE.size() == 0:
        return None
    return _QUARANTINE.check(operator, _sig_hash(plan_signature))


def note_quarantine(operator: str, plan_signature: str, failure_class: str,
                    reason: str) -> None:
    if not (_ENABLED and _Q_ENABLED):
        return
    _QUARANTINE.note(operator, _sig_hash(plan_signature), failure_class,
                     reason)
    _bump("quarantine_notes")


# ---------------------------------------------------------------------------
# the fallback boundary
# ---------------------------------------------------------------------------
def runs_kernel(node) -> bool:
    """Whether a batch of ``node`` (a fused stage: of any member) may call
    a hand-written kernel's wrapper (``TpuExec.runs_kernel``)."""
    probe = getattr(node, "runs_kernel", None)
    return bool(probe is not None and probe())


def _quarantine_targets(node) -> List[Tuple[str, str]]:
    """(operator class, plan signature) keys a terminal failure at
    ``node`` charges. A fused whole-stage charges every chain member: the
    planner's quarantine pass trial-converts individual operators (fusion
    happens after conversion), so member-level keys are what it can match,
    and any member may be the culprit."""
    chain = getattr(node, "chain", None)
    nodes = list(chain) if chain else [node]
    out = []
    for n in nodes:
        try:
            out.append((type(n).__name__, n.plan_signature()))
        except Exception:  # best-effort: the member goes un-quarantined
            continue
    return out


def with_host_fallback(node, device_fn: Callable[[Any], Any],
                       host_fn: Optional[Callable[[Any], Any]],
                       min_bucket: int = 1024):
    """Wrap one device operator's per-batch dispatch in the runtime
    degradation boundary.

    ``device_fn(batch)`` is the ladder-protected device path (typically
    a ``with_retry_split`` closure). ``host_fn(host_table)`` is the
    operator's host-engine equivalent, or None for operators without a
    batch-local host path: a terminal failure then still notes the
    quarantine store (so a later plan runs the operator on the host) before
    re-raising. The host result is uploaded at ``min_bucket`` to the
    batch's device. Returns ``device_fn`` unchanged when fallback is
    disabled or the node may call a hand-written kernel (its failures
    re-raise, unnoted)."""
    if not _ENABLED or runs_kernel(node):
        return device_fn

    def run(batch):
        try:
            return device_fn(batch)
        except Exception as e:
            cls = classify_failure(e)
            if cls is None:
                raise
            reason = f"{type(e).__name__}: {str(e)[:160]}"
            for op_name, sig in _quarantine_targets(node):
                note_quarantine(op_name, sig, cls, reason)
            if host_fn is None:
                _bump("fallback_failures")
                raise
            return _host_fallback(node, batch, host_fn, e, cls, reason,
                                  min_bucket)
    return run


class quarantine_on_failure:
    """Note-only degradation boundary for operators whose semantics span
    batches (final aggregates, sorts, joins): a terminal device failure
    inside the block cannot be recovered mid-stream, but it still feeds
    the quarantine store, so a later plan runs the operator on the host.
    The exception always propagates."""

    def __init__(self, node):
        self._node = node

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or not _ENABLED or runs_kernel(self._node):
            return False
        cls = classify_failure(exc)
        if cls is not None:
            reason = f"{type(exc).__name__}: {str(exc)[:160]}"
            for op_name, sig in _quarantine_targets(self._node):
                note_quarantine(op_name, sig, cls, reason)
            _bump("fallback_failures")
        return False


def _host_fallback(node, batch, host_fn, exc, failure_class: str,
                   reason: str, min_bucket: int):
    """Download -> host execute -> upload, with its record."""
    from ..columnar.device import DeviceTable
    t0 = time.perf_counter()
    device = batch.device
    try:
        ht = batch.to_host()
    except Exception:
        # a donated batch's planes may be gone after the failed dispatch;
        # the ladder hands the rebuild hook back on its structured error
        remat = getattr(exc, "rematerialize", None)
        if remat is None:
            raise exc
        ht = remat().to_host()
    bytes_down = int(ht.nbytes())
    out_host = host_fn(ht)
    out = DeviceTable.from_host(out_host, min_bucket, device)
    bytes_up = int(out.nbytes())
    wall = time.perf_counter() - t0
    op_name = type(node).__name__
    print(f"# device failure in {op_name} ({failure_class}): batch "
          f"re-executed on the host engine ({bytes_down} bytes down, "
          f"{bytes_up} bytes up)", file=sys.stderr)
    _bump("host_fallbacks")
    _bump("fallback_bytes_down", bytes_down)
    _bump("fallback_bytes_up", bytes_up)
    from ..utils import faults
    faults.note_recovery("host_fallbacks")
    rec = {"ts": time.time(), "operator": op_name,
           "context": str(getattr(node, "node_desc", lambda: "")())[:200],
           "failure_class": failure_class, "reason": reason,
           "rows": int(out_host.num_rows), "bytes_down": bytes_down,
           "bytes_up": bytes_up, "wall_s": wall}
    with _STATS_LOCK:
        _RECORDS.append(rec)
    return out


# ---------------------------------------------------------------------------
# plan-time quarantine pass (called from plan/overrides.py after tag)
# ---------------------------------------------------------------------------
def plan_quarantine_pass(meta, conf, device) -> None:
    """Route quarantined operators to host at PLAN time. For every
    still-convertible node, trial-convert it (with its UNCONVERTED CPU
    children — conversion preserves child schemas, which is all the
    device plan_signature reads) to learn the device class + signature
    it WOULD run as, and mark it cannot_run when the store says that key
    has crossed the threshold. Zero work when the store is empty."""
    if not (_ENABLED and _Q_ENABLED) or _QUARANTINE.size() == 0:
        return
    for m in meta.walk():
        if not m.can_run or m.rule is None:
            continue
        try:
            dev = m.rule.convert_fn(m.plan, list(m.plan.children), conf,
                                   device)
            sig = dev.plan_signature()
            op_name = type(dev).__name__
            if runs_kernel(dev):
                continue   # a kernel's work is never routed to the host
        except Exception:  # a node that cannot trial-convert is not quarantined
            continue
        reason = quarantine_reason(op_name, sig)
        if reason:
            _bump("quarantine_plan_routes")
            m.cannot_run(f"quarantined: {reason}")
