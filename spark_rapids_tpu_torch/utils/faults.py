"""Conf-gated fault injection — the port of
``spark_rapids_tpu/utils/faults.py``.

Named fault points are threaded through the engine's failure surfaces
(spill-store write and read, the host-to-device upload, the retry ladder's
dispatch and upload scopes, the shuffle manager's publish and fetch, the
TCP transport's connect and read, the DCN tier's publish and fetch, a
``ProcessCluster`` worker's task and a mesh stage's dispatch); a
deterministic, seeded spec fires them in tests and in ``chip_smoke.py``'s
pressure and process phases. A ``ProcessCluster`` worker configures its
injector with its worker id as a seed offset.

Cost: a module-level ``_INJECTOR`` that is ``None`` when disabled, so every
``fire()`` on a hot path pays one global load and an is-None check.

Spec grammar (``spark.rapids.tpu.faults.spec``)::

    spec    := clause (";" clause)*
    clause  := point (":" key "=" value)*
    keys    := p|prob        fire probability in [0,1]   (default 1.0)
               times         stop after N fires          (default unlimited)
               after         skip the first N evaluations (default 0)
               latency_ms    inject latency before returning
               action        raise|kill|corrupt|delay|oom|fatal (default raise)

e.g. ``alloc.jit:after=3:times=2:action=oom``. Each point has its own
``random.Random(f"{seed}:{point}")`` stream, so firing decisions depend only
on how often that point is reached, and equal the JAX package's bit for
bit.

The module is also the recovery ledger: every recovery mechanism (the OOM
ladder's retries and splits, the host fallback, spill-corruption
detection) notes what it did through ``note_recovery()``.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

from ..conf import FAULTS_ENABLED, FAULTS_SEED, FAULTS_SPEC

__all__ = [
    "FAULT_POINTS",
    "FaultInjectedError",
    "FaultInjector",
    "configure_faults",
    "reset_faults",
    "active",
    "fire",
    "note_recovery",
    "recovery_counters",
    "reset_recovery",
    "drain_fault_records",
    "faults_stats",
]

#: The named fault points (the JAX package's catalogue). Specs may only
#: reference these: a mistyped point is a config error, not a clause that
#: never fires.
FAULT_POINTS = (
    "shuffle.fetch",     # shuffle/manager.py read, before the fetch
    "shuffle.publish",   # shuffle/manager.py write, before publishing
    "tcp.connect",       # shuffle/tcp.py connect to a peer
    "tcp.read",          # shuffle/tcp.py read a peer's response
    "dcn.publish",       # shuffle/dcn.py block publish across processes
    "dcn.fetch",         # shuffle/dcn.py block fetch across processes
    "spill.write",       # memory/stores.py disk-spill write (supports corrupt)
    "spill.read",        # memory/stores.py disk-spill restore
    "worker.task",       # parallel/runtime.py worker task (supports kill)
    "h2d.upload",        # exec/transitions.py host->device upload
    "alloc.jit",         # memory/retry.py dispatch retry scope (supports oom/fatal)
    "alloc.upload",      # memory/retry.py H2D-upload retry scope (supports oom/fatal)
    "mesh.dispatch",     # exec/mesh.py mesh-stage dispatch
)

# "fatal" is the non-retryable twin of "oom": memory/retry.py raises a
# device failure with no OOM marker, so the retry ladder passes it through
# and the host-fallback boundary (exec/fallback.py) classifies it: the
# injection that exercises the degradation path below the ladder.
_ACTIONS = ("raise", "kill", "corrupt", "delay", "oom", "fatal")


class FaultInjectedError(RuntimeError):
    """An injected fault fired with ``action=raise``. Carries the point
    name so recovery errors and forensics can name the fault."""

    def __init__(self, point: str, action: str = "raise"):
        super().__init__(f"injected fault '{point}' (action={action})")
        self.point = point
        self.action = action


class _Clause:
    """One parsed spec clause: firing rule + mutable fire budget."""

    __slots__ = ("point", "prob", "times", "after", "latency_ms",
                 "action", "rng", "evaluations", "fires")

    def __init__(self, point: str, prob: float, times: Optional[int],
                 after: int, latency_ms: float, action: str, seed: int):
        self.point = point
        self.prob = prob
        self.times = times
        self.after = after
        self.latency_ms = latency_ms
        self.action = action
        self.rng = random.Random(f"{seed}:{point}")
        self.evaluations = 0
        self.fires = 0

    def evaluate(self) -> bool:
        """Advance this clause's deterministic stream by one evaluation
        and decide whether it fires."""
        self.evaluations += 1
        # consume one sample per evaluation regardless of the outcome so
        # the stream position depends only on how often the point is
        # reached, never on `after`/`times` state
        sample = self.rng.random()
        if self.evaluations <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if sample >= self.prob:
            return False
        self.fires += 1
        return True


def _parse_spec(spec: str, seed: int) -> Dict[str, _Clause]:
    clauses: Dict[str, _Clause] = {}
    for raw in spec.replace(";", ",").split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        point = parts[0].strip()
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known points: "
                f"{', '.join(FAULT_POINTS)}")
        prob, times, after, latency_ms, action = 1.0, None, 0, 0.0, "raise"
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"fault clause option {kv!r} is not key=value")
            k, v = (s.strip() for s in kv.split("=", 1))
            if k in ("p", "prob"):
                prob = float(v)
                if not 0.0 <= prob <= 1.0:
                    raise ValueError(f"fault probability {prob} not in [0,1]")
            elif k == "times":
                times = int(v)
            elif k == "after":
                after = int(v)
            elif k == "latency_ms":
                latency_ms = float(v)
            elif k == "action":
                if v not in _ACTIONS:
                    raise ValueError(
                        f"unknown fault action {v!r}; one of {_ACTIONS}")
                action = v
            else:
                raise ValueError(f"unknown fault clause key {k!r}")
        clauses[point] = _Clause(point, prob, times, after, latency_ms,
                                 action, seed)
    return clauses


# never set: gives injected latency an interruptible, checker-clean wait
_SLEEP_EVT = threading.Event()


class FaultInjector:
    """Deterministic seeded fault injector over the named point set."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._clauses = _parse_spec(spec, seed)
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []

    def fire(self, point: str) -> Optional[str]:
        """Evaluate the clause registered for ``point`` (if any).
        Returns the clause's action string when it fires (after applying
        any configured latency), else None."""
        clause = self._clauses.get(point)
        if clause is None:
            return None
        with self._lock:
            fired = clause.evaluate()
            if not fired:
                return None
            self._records.append({
                "point": point,
                "action": clause.action,
                "fire": clause.fires,
                "evaluation": clause.evaluations,
            })
        if clause.latency_ms > 0:
            _SLEEP_EVT.wait(clause.latency_ms / 1000.0)
        return clause.action

    def counters(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {p: {"evaluations": c.evaluations, "fires": c.fires}
                    for p, c in self._clauses.items()}

    def drain_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._records = self._records, []
            return out


# ---------------------------------------------------------------------------
# module-level injector: None when disabled (the zero-overhead pin)
# ---------------------------------------------------------------------------
_INJECTOR: Optional[FaultInjector] = None


def fire(point: str) -> Optional[str]:
    """Hot-path fault point. With injection disabled this is one global
    load and an is-None check."""
    if _INJECTOR is None:
        return None
    return _INJECTOR.fire(point)


def configure_faults(conf, seed_offset: int = 0) -> Optional[FaultInjector]:
    """Install (or clear) the process-wide injector from a RapidsConf;
    returns the installed injector (None when disabled). ``seed_offset``
    decorrelates the streams of several processes while keeping each one
    deterministic."""
    global _INJECTOR
    if not conf.get(FAULTS_ENABLED):
        _INJECTOR = None
        return None
    _INJECTOR = FaultInjector(str(conf.get(FAULTS_SPEC)),
                              int(conf.get(FAULTS_SEED)) + seed_offset)
    return _INJECTOR


def install(injector: Optional[FaultInjector]) -> None:
    """Install a pre-built injector (tests)."""
    global _INJECTOR
    _INJECTOR = injector


def reset_faults() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> Optional[FaultInjector]:
    return _INJECTOR


def drain_fault_records() -> List[Dict[str, Any]]:
    inj = _INJECTOR
    return inj.drain_records() if inj is not None else []


# ---------------------------------------------------------------------------
# recovery ledger: process-wide counters of what recovery machinery did
# ---------------------------------------------------------------------------
_LEDGER_KEYS = (
    "worker_deaths",        # worker processes observed dead (exit/EOF/wedge)
    "worker_respawns",      # dead workers replaced with a fresh process
    "worker_exclusions",    # workers taken out of rotation permanently
    "task_resubmissions",   # in-flight tasks re-run on a surviving worker
    "task_failures",        # tasks that exhausted task.maxFailures
    "task_timeouts",        # _wait deadlines that expired
    "transport_retries",    # transient socket errors retried with backoff
    "transport_giveups",    # peers abandoned after exhausting retries
    "shuffle_recomputes",   # map outputs recomputed after fetch-failed
    "spill_corruptions",    # disk-spill blocks that failed CRC verification
    "oom_retries",          # device-OOM spill-and-retry attempts (memory/retry.py)
    "oom_splits",           # device-OOM row-axis input halvings (memory/retry.py)
    "host_fallbacks",       # batches re-executed on the host engine (exec/fallback.py)
)

_LEDGER: Dict[str, int] = {k: 0 for k in _LEDGER_KEYS}
_LEDGER_LOCK = threading.Lock()


def note_recovery(key: str, n: int = 1) -> None:
    """Record recovery activity. Unknown keys are registered on the fly
    so call sites never crash telemetry."""
    with _LEDGER_LOCK:
        _LEDGER[key] = _LEDGER.get(key, 0) + n


def recovery_counters() -> Dict[str, int]:
    with _LEDGER_LOCK:
        return dict(_LEDGER)


def reset_recovery() -> None:
    with _LEDGER_LOCK:
        _LEDGER.clear()
        _LEDGER.update({k: 0 for k in _LEDGER_KEYS})


def faults_stats() -> Dict[str, Any]:
    """Recovery counters plus per-point injection counts when an
    injector is active."""
    out: Dict[str, Any] = dict(recovery_counters())
    inj = _INJECTOR
    if inj is not None:
        for point, c in inj.counters().items():
            key = point.replace(".", "_")
            out[f"injected_{key}"] = c["fires"]
    return out
