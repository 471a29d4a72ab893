"""Memory flight recorder: allocation-lifecycle profiling of the device
buffers — the port of ``spark_rapids_tpu/utils/memprof.py`` (reference:
RapidsBufferCatalog lifecycle tracking, RapidsBufferCatalog.scala:40,156,
and spark.rapids.memory.gpu.oomDumpDir state dumps).

- **lifecycle ring**: every register/spill/restore/free of the buffer
  catalog (and external-bytes updates) lands in a bounded ring with a
  sequence number, byte delta, tier and the owning (query_id, operator)
  from the thread-local node context (utils/node_context.py).
- **per-(query, operator) aggregation**: live bytes, peak bytes,
  alloc/free counts, spill/restore churn and held duration per operator.
- **peak attribution**: whenever the device total (catalog-resident plus
  external sources) makes a new high-water mark, the per-owner live set is
  snapshotted, so the holders sum to the catalog's ``peak_device_bytes``
  (tests/test_torch_memprof.py pins it within 1 %).
- **leak detection**: ``query_end(qid)`` flags buffers still registered
  after the query finished, attributed to the operator that allocated
  them.
- **OOM postmortem**: on an allocation failure (strict pool register) or
  an exhausted OOM ladder the catalog calls ``oom_postmortem()``, which
  ranks holders by operator, lists the last lifecycle events, spill-tier
  occupancy and the semaphore holders, writes it to ``report_dir`` when one
  is set, and queues the record (``drain_postmortems``).

Cost: a module-level ``_ACTIVE`` profiler that is ``None`` when disabled,
so the catalog's hot path pays one load and an is-None check. Lock order:
catalog lock, then the profiler's lock.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..conf import MEMPROF_ENABLED, MEMPROF_RING_SIZE
from .node_context import current

__all__ = ["MEMPROF_ENABLED", "MEMPROF_RING_SIZE", "MemoryProfiler",
           "active", "get_memprof", "set_memprof", "configure_memprof",
           "memprof_stats"]

#: attribution key for allocations outside any instrumented operator
#: (plain collect() with no event log runs with an empty context stack)
UNATTRIBUTED = (None, -1, "(unattributed)")

#: holder label for device bytes held outside the spill framework
#: (register_external_bytes sources: upload cache etc.)
EXTERNAL_KEY = "(external)"

#: lifecycle kinds that mutate accounting; unknown kinds only hit the ring
_ACCOUNTED = ("register", "spill", "restore", "free", "external")


def _fmt_key(key: Tuple) -> str:
    qid, nid, name = key
    if nid < 0:
        return name
    return f"q{'-' if qid is None else qid}:{name}#{nid}"


def _new_agg() -> Dict:
    return {"live_bytes": 0, "peak_bytes": 0, "allocs": 0, "frees": 0,
            "spilled_bytes": 0, "restored_bytes": 0, "held_s": 0.0}


class MemoryProfiler:
    """Thread-safe bounded lifecycle recorder + per-operator aggregator."""

    def __init__(self, ring_size: int = 4096, report_dir: str = ""):
        self.ring_size = ring_size
        self.report_dir = report_dir
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._ring: deque = deque(maxlen=ring_size)
        # buffer_id -> [owner key, size_bytes, t_register, on_device]
        self._owners: Dict[int, list] = {}
        # (query_id, node_id, name) -> aggregation dict (_new_agg)
        self._agg: Dict[Tuple, Dict] = {}
        self._ext_bytes = 0  # last-seen external device bytes (sum)
        self.live_attributed_bytes = 0  # catalog-resident device bytes
        self.peak_bytes = 0
        self.peak_holders: Dict[str, int] = {}
        self.events_recorded = 0
        self.leaks_detected = 0
        self.postmortems_written = 0
        self._pending_postmortems: List[Dict] = []

    # -- recording (called from inside catalog mutations) ---------------------
    def record(self, kind: str, buffer_id: int, nbytes: int,
               ext_bytes: Optional[int] = None,
               tier: Optional[str] = None) -> None:
        """One lifecycle event. ``ext_bytes`` is the catalog's current
        external-bytes sum (external sources must be visible to peak
        attribution, or the holders cannot sum to the true watermark).
        Unknown ``kind`` values only land in the ring."""
        ctx = current()
        key = (ctx.query_id, ctx.node_id, ctx.name) if ctx is not None \
            else UNATTRIBUTED
        now = time.time()
        with self._lock:
            self.events_recorded += 1
            if ext_bytes is not None:
                self._ext_bytes = int(ext_bytes)
            if kind == "register":
                self._owners[buffer_id] = [key, nbytes, now, True]
                a = self._agg_locked(key)
                a["allocs"] += 1
                a["live_bytes"] += nbytes
                if a["live_bytes"] > a["peak_bytes"]:
                    a["peak_bytes"] = a["live_bytes"]
                self.live_attributed_bytes += nbytes
            elif kind == "spill":
                owner = self._owners.get(buffer_id)
                if owner is not None and owner[3]:
                    owner[3] = False
                    oa = self._agg_locked(owner[0])
                    oa["live_bytes"] -= owner[1]
                    self.live_attributed_bytes -= owner[1]
                # churn is charged to the operator DRIVING the spill (the
                # allocator), matching the catalog's SPILL_BYTES metric
                self._agg_locked(key)["spilled_bytes"] += nbytes
            elif kind == "restore":
                owner = self._owners.get(buffer_id)
                if owner is not None and not owner[3]:
                    owner[3] = True
                    oa = self._agg_locked(owner[0])
                    oa["live_bytes"] += owner[1]
                    if oa["live_bytes"] > oa["peak_bytes"]:
                        oa["peak_bytes"] = oa["live_bytes"]
                    self.live_attributed_bytes += owner[1]
                self._agg_locked(key)["restored_bytes"] += nbytes
            elif kind == "free":
                owner = self._owners.pop(buffer_id, None)
                if owner is not None:
                    okey, obytes, t_reg, on_device = owner
                    oa = self._agg_locked(okey)
                    oa["frees"] += 1
                    oa["held_s"] += now - t_reg
                    if on_device:
                        oa["live_bytes"] -= obytes
                        self.live_attributed_bytes -= obytes
            self._ring.append({
                "seq": next(self._seq), "ts": now, "kind": kind,
                "buffer": buffer_id, "bytes": nbytes, "tier": tier,
                "query_id": key[0], "node_id": key[1], "operator": key[2]})
            total = self.live_attributed_bytes + self._ext_bytes
            if total > self.peak_bytes:
                self.peak_bytes = total
                self.peak_holders = self._holders_dict_locked()

    def _agg_locked(self, key: Tuple) -> Dict:
        a = self._agg.get(key)
        if a is None:
            a = self._agg[key] = _new_agg()
        return a

    def _holders_dict_locked(self) -> Dict[str, int]:
        """Live device bytes by owner label, from the owner table (not the
        per-query aggregation, which query_end prunes — a leaked buffer
        must stay visible in peak/holder attribution)."""
        holders: Dict[str, int] = {}
        for okey, obytes, _t, on_device in self._owners.values():
            if on_device:
                label = _fmt_key(okey)
                holders[label] = holders.get(label, 0) + obytes
        if self._ext_bytes:
            holders[EXTERNAL_KEY] = self._ext_bytes
        return holders

    # -- queries ---------------------------------------------------------------
    def holders_by_operator(self) -> List[Tuple[str, int]]:
        """Current live device bytes per owner, ranked descending (the
        oom_dump and postmortem ranking)."""
        with self._lock:
            holders = self._holders_dict_locked()
        return sorted(holders.items(), key=lambda kv: -kv[1])

    def begin_query(self, query_id) -> None:
        """Drop stale aggregation for ``query_id`` (a query id reused
        across runs starts clean)."""
        with self._lock:
            for key in [k for k in self._agg if k[0] == query_id]:
                del self._agg[key]

    def node_peaks(self, query_id) -> Dict[int, int]:
        """node_id -> peak device bytes for one query."""
        with self._lock:
            return {k[1]: a["peak_bytes"] for k, a in self._agg.items()
                    if k[0] == query_id and k[1] >= 0 and a["peak_bytes"]}

    def query_end(self, query_id) -> Dict:
        """Leak scan + per-operator summary at the query boundary.

        Buffers still registered whose owner belongs to ``query_id`` are
        flagged as leaks (attributed: operator + bytes + held duration).
        The query's aggregation entries are pruned afterwards so the
        table stays bounded across a long session."""
        now = time.time()
        with self._lock:
            leaks = []
            for bid, (okey, obytes, t_reg, on_dev) in self._owners.items():
                if okey[0] == query_id:
                    leaks.append({
                        "buffer": bid, "bytes": obytes,
                        "operator": okey[2], "node_id": okey[1],
                        "on_device": on_dev,
                        "held_s": round(now - t_reg, 3)})
            per_op = {}
            for key in [k for k in self._agg if k[0] == query_id]:
                a = self._agg.pop(key)
                per_op[f"{key[2]}#{key[1]}"] = {
                    "peak_bytes": a["peak_bytes"],
                    "live_bytes": a["live_bytes"],
                    "allocs": a["allocs"], "frees": a["frees"],
                    "spilled_bytes": a["spilled_bytes"],
                    "restored_bytes": a["restored_bytes"],
                    "held_s": round(a["held_s"], 4)}
            self.leaks_detected += len(leaks)
            summary = {
                "query_id": query_id,
                "peak_bytes": self.peak_bytes,
                "peak_holders": dict(self.peak_holders),
                "per_operator": per_op,
                "leaked_buffers": sorted(leaks, key=lambda d: -d["bytes"]),
                "leaked_bytes": sum(d["bytes"] for d in leaks),
            }
        return summary

    # -- OOM postmortem --------------------------------------------------------
    def oom_postmortem(self, context: str, catalog=None,
                       last_n: int = 64) -> Dict:
        """Full attribution dump before an OOM propagates: ranked
        holders-by-operator, external sources, spill-tier occupancy, the
        last N lifecycle events and the semaphore holder table, written to
        ``report_dir/oom-<ts>.txt`` when a report dir is set and queued
        for ``drain_postmortems``.

        Called from inside the catalog lock on the failing thread (RLock:
        re-entrant); catalog state is read via plain attribute loads."""
        now = time.time()
        with self._lock:
            holders = sorted(self._holders_dict_locked().items(),
                             key=lambda kv: -kv[1])
            ring = list(self._ring)[-last_n:]
            live = self.live_attributed_bytes + self._ext_bytes
            peak = self.peak_bytes
        lines = [
            "== spark-rapids-tpu (torch) OOM postmortem ==",
            time.strftime("time: %Y-%m-%dT%H:%M:%S%z"),
            f"context: {context}",
            f"live device bytes: {live} (peak {peak})",
            "",
            "-- holders by operator (live device bytes, ranked) --",
        ]
        lines.extend(f"  {label}: {b}" for label, b in holders)
        if not holders:
            lines.append("  (no live attributed buffers)")
        if catalog is not None:
            ext = dict(catalog._external_cache)
            lines.append("\n-- external device bytes by source --")
            lines.extend(f"  {k}: {v}" for k, v in sorted(ext.items()))
            if not ext:
                lines.append("  (none registered)")
            lines.append("\n-- spill-tier occupancy --")
            lines.append(f"  DEVICE used={catalog.device.used_bytes} "
                         f"limit={catalog.device.limit_bytes}")
            lines.append(f"  HOST   used={catalog.host.used_bytes} "
                         f"limit={catalog.host.limit_bytes}")
            lines.append(f"  DISK   used={catalog.disk.used_bytes}")
            lines.append(f"  spill_count={{host: "
                         f"{catalog.spill_count[1]}, disk: "
                         f"{catalog.spill_count[2]}}} "
                         f"oom_events={catalog.oom_events}")
        lines.append(f"\n-- last {len(ring)} lifecycle events --")
        for ev in ring:
            lines.append(
                f"  #{ev['seq']} {ev['kind']:<9} buffer={ev['buffer']} "
                f"bytes={ev['bytes']} tier={ev['tier']} "
                f"query={ev['query_id']} op={ev['operator']}")
        if not ring:
            lines.append("  (ring empty)")
        lines.append("\n-- semaphore --")
        from ..memory.semaphore import peek_semaphore
        sem = peek_semaphore()
        if sem is None:
            lines.append("  (no semaphore created yet)")
        else:
            d = sem.dump()
            lines.append(
                f"  permits={d['permits']} available={d['available']} "
                f"acquires={d['acquires']}")
            for h in d["holders"]:
                lines.append(f"  holder: thread={h['thread']!r} "
                             f"task={h['task_id']} held {h['held_s']:.1f}s")
            for w in d["waiters"]:
                lines.append(f"  waiter: thread={w['thread']!r} "
                             f"waiting {w['waiting_s']:.1f}s")
        report = "\n".join(lines) + "\n"
        path = None
        if self.report_dir:
            try:
                os.makedirs(self.report_dir, exist_ok=True)
                path = os.path.join(self.report_dir,
                                    f"oom-{int(now * 1000)}.txt")
                with open(path, "w", encoding="utf-8") as f:
                    f.write(report)
            except OSError:
                path = None
        record = {
            "ts": now, "context": context[:500], "path": path,
            "live_bytes": live, "peak_bytes": peak,
            "holders": dict(holders[:10]), "report": report,
        }
        with self._lock:
            self.postmortems_written += 1
            self._pending_postmortems.append(record)
        return record

    def drain_postmortems(self) -> List[Dict]:
        """Pop the queued postmortem records (the event log that will fold
        them into their query comes with the observability work)."""
        with self._lock:
            out, self._pending_postmortems = self._pending_postmortems, []
        return out

    # -- snapshots -------------------------------------------------------------
    def events(self, last_n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            evs = list(self._ring)
        return evs if last_n is None else evs[-last_n:]

    def snapshot(self) -> Dict:
        """Live and peak attribution at a glance."""
        with self._lock:
            holders = sorted(self._holders_dict_locked().items(),
                             key=lambda kv: -kv[1])
            return {
                "enabled": True,
                "live_attributed_bytes": self.live_attributed_bytes,
                "external_bytes": self._ext_bytes,
                "peak_bytes": self.peak_bytes,
                "peak_holders": dict(self.peak_holders),
                "top_holders": [{"owner": k, "bytes": v}
                                for k, v in holders[:10]],
                "events_recorded": self.events_recorded,
                "ring_len": len(self._ring),
                "leaks_detected": self.leaks_detected,
                "postmortems": self.postmortems_written,
            }

    def stats(self) -> Dict:
        """Flat counters, with live device bytes by operator."""
        with self._lock:
            per_op: Dict[str, int] = {}
            for okey, obytes, _t, on_device in self._owners.values():
                if on_device:
                    per_op[okey[2]] = per_op.get(okey[2], 0) + obytes
            return {
                "enabled": True,
                "events": self.events_recorded,
                "live_attributed_bytes": self.live_attributed_bytes,
                "external_bytes": self._ext_bytes,
                "peak_bytes": self.peak_bytes,
                "live_buffers": len(self._owners),
                "leaks_detected": self.leaks_detected,
                "postmortems": self.postmortems_written,
                "operator_live_bytes": per_op,
            }


# ---------------------------------------------------------------------------
# process-global profiler (the catalog hot path reads this once per event)
# ---------------------------------------------------------------------------
_ACTIVE: Optional[MemoryProfiler] = None
_ACTIVE_LOCK = threading.Lock()


def active() -> Optional[MemoryProfiler]:
    """The live profiler or None when disabled — the catalog's fast path
    (one attribute load + is-None check when profiling is off)."""
    return _ACTIVE


def get_memprof() -> Optional[MemoryProfiler]:
    return _ACTIVE


def set_memprof(mp: Optional[MemoryProfiler]) -> None:
    """Explicitly install/clear the profiler (tests; disabling is an
    explicit act, mirroring the tracer's sticky-enable contract)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = mp


def configure_memprof(conf) -> Optional[MemoryProfiler]:
    """Session-start chokepoint (TorchSession.__init__). Sticky, as in the
    JAX package: the profiler is process-wide and sessions come and go, so
    a session with profiling disabled does not clear a profiler another
    session filled (disable explicitly with ``set_memprof(None)``). The
    ring resizes only on a non-default size. Postmortems stay in memory
    (``report_dir`` empty) until ``health.reportDir`` is read."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if not bool(conf.get(MEMPROF_ENABLED)):
            return _ACTIVE
        ring = int(conf.get(MEMPROF_RING_SIZE))
        mp = _ACTIVE
        if mp is None:
            mp = _ACTIVE = MemoryProfiler(ring, "")
            return mp
        if ring != mp.ring_size and ring != MEMPROF_RING_SIZE.default:
            with mp._lock:
                mp.ring_size = ring
                mp._ring = deque(mp._ring, maxlen=ring)
        return mp


def memprof_stats() -> Dict:
    """The active profiler's counters, or ``{"enabled": False}``."""
    mp = _ACTIVE
    return mp.stats() if mp is not None else {"enabled": False}
