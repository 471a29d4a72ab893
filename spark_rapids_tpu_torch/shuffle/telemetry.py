"""The shuffle observatory: per-tier transfer telemetry — the port of
``spark_rapids_tpu/shuffle/telemetry.py``.

Every transfer at the shuffle tiers' choke points (the manager's serialize,
publish, fetch and deserialize; the cached tier's publish and fetch; the TCP
transport's connect, send, recv and serve; the DCN tier's enqueue,
serialize, fetch and deserialize; the mesh exchange's enqueue and dispatch,
the local tier's enqueue and a mesh stage's dispatch) reports into one
process-wide ``ShuffleObservatory``: tier, phase, shuffle and partition,
logical and wire bytes, wall, retries and publish-queue depth, kept in a
bounded ring and aggregated exactly per (query, tier), per (query, shuffle,
tier) and per (shuffle, partition, tier) for straggler attribution.

Cost: a module global ``_OBSERVATORY`` that is ``None`` when disabled
(``spark.rapids.tpu.shuffle.telemetry.enabled``, the default off), so
every hook pays one global load and an is-None check; byte counts may be
callables, never evaluated on the disabled path.

Sender/receiver stitching pairs the two halves of one TCP transfer by the
trace id of the JAX package's ``SRTC`` wire header. The port's transport
parses that header and drops it (the port has no ``utils/tracing.py``
yet), so no half of a port transfer carries a trace id and ``stitched()``
stays empty. The consumers of the per-query summary (the event log, the
health and diagnose tools) come with ROADMAP Queue 1: breadth.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..conf import SHUFFLE_TELEMETRY_ENABLED, SHUFFLE_TELEMETRY_RING_SIZE

__all__ = ["ShuffleObservatory", "TIERS", "configure_shuffle_telemetry",
           "reset_shuffle_telemetry", "active", "clock", "note_transfer",
           "drain_ring", "query_summary", "shuffle_telemetry_stats"]

#: the fabrics a note may name: "ici" the mesh exchange, "local" the
#: one-partition device tier, "cached" device-resident catalog blocks,
#: "transport" host bytes (TCP and the in-process transport), "dcn" the
#: device-resident tier across processes
TIERS = ("ici", "local", "cached", "transport", "dcn")

#: keys of the totals dicts
TOTAL_KEYS = ("transfers", "logical_bytes", "wire_bytes", "retries",
              "stitched")


def _zero_totals() -> Dict[str, Any]:
    t: Dict[str, Any] = {k: 0 for k in TOTAL_KEYS}
    t["wall_s"] = 0.0
    t["max_queue_depth"] = 0
    return t


def _zero_agg() -> Dict[str, Any]:
    return {"count": 0, "logical_bytes": 0, "wire_bytes": 0,
            "wall_s": 0.0, "retries": 0, "max_queue_depth": 0,
            "phases": {}}


class ShuffleObservatory:
    """Process-wide ledger of shuffle transfers: a bounded ring of raw
    events and exact aggregates, all under one lock (hooks fire from
    pipeline workers, the TCP server's threads, fetch pools and the query
    thread)."""

    def __init__(self, ring_size: int = 4096):
        self.ring_size = int(ring_size)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_size)
        self._totals = _zero_totals()
        # (tier, phase) -> agg, process-wide
        self._agg: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # query_id -> {"totals", "tiers", "shuffles", "partitions"}
        self._queries: Dict[Any, Dict[str, Any]] = {}
        # (trace_id, shuffle, map, partition) -> {"send": e, "recv": e}
        self._stitch: Dict[Tuple, Dict[str, Dict[str, Any]]] = {}
        self._stitched: List[Dict[str, Any]] = []

    # -- recording --------------------------------------------------------
    def note(self, tier: str, phase: str, shuffle_id: Any = None,
             map_id: Any = None, partition: Any = None,
             logical_bytes: Union[int, Callable[[], int]] = 0,
             wire_bytes: Union[int, Callable[[], int]] = 0,
             t0: float = 0.0, retries: int = 0, queue_depth: int = 0,
             trace_id: Any = None, side: Optional[str] = None,
             query_id: Any = None) -> None:
        """Record one transfer (or one phase of one). ``query_id``
        overrides the node context's query for hooks off the query thread;
        ``side`` ("send"/"recv") with ``trace_id`` and the block identity
        stitch the two halves of one wire transfer."""
        wall = (time.perf_counter() - t0) if t0 else 0.0
        logical = int(logical_bytes() if callable(logical_bytes)
                      else logical_bytes)
        wire = int(wire_bytes() if callable(wire_bytes) else wire_bytes)
        operator = None
        if query_id is None:
            from ..utils import node_context
            ctx = node_context.current()
            operator = ctx.name if ctx is not None else None
            query_id = ctx.query_id if ctx is not None else None
        entry = {"ts": time.time(), "tier": tier, "phase": phase,
                 "shuffle_id": shuffle_id, "map_id": map_id,
                 "partition": partition, "logical_bytes": logical,
                 "wire_bytes": wire, "wall_s": wall, "retries": int(retries),
                 "queue_depth": int(queue_depth), "query_id": query_id,
                 "operator": operator, "trace_id": trace_id, "side": side}
        with self._lock:
            self._ring.append(entry)
            self._fold_totals(self._totals, entry)
            self._fold_agg(self._agg.setdefault((tier, phase), _zero_agg()),
                           entry)
            q = self._queries.get(query_id)
            if q is None:
                q = self._queries[query_id] = {
                    "totals": _zero_totals(), "tiers": {}, "shuffles": {},
                    "partitions": {}}
            self._fold_totals(q["totals"], entry)
            self._fold_agg(q["tiers"].setdefault(tier, _zero_agg()), entry)
            if shuffle_id is not None:
                self._fold_agg(q["shuffles"].setdefault((shuffle_id, tier),
                                                        _zero_agg()), entry)
                if partition is not None and wall > 0.0:
                    pk = (shuffle_id, partition, tier)
                    q["partitions"][pk] = q["partitions"].get(pk, 0.0) + wall
            if trace_id is not None and side in ("send", "recv"):
                self._fold_stitch(entry)

    @staticmethod
    def _fold_totals(totals: Dict[str, Any], entry: Dict) -> None:
        totals["transfers"] += 1
        for k in ("logical_bytes", "wire_bytes", "retries", "wall_s"):
            totals[k] += entry[k]
        totals["max_queue_depth"] = max(totals["max_queue_depth"],
                                        entry["queue_depth"])

    @staticmethod
    def _fold_agg(a: Dict[str, Any], entry: Dict) -> None:
        a["count"] += 1
        for k in ("logical_bytes", "wire_bytes", "wall_s", "retries"):
            a[k] += entry[k]
        a["max_queue_depth"] = max(a["max_queue_depth"], entry["queue_depth"])
        ph = a["phases"]
        ph[entry["phase"]] = ph.get(entry["phase"], 0.0) + entry["wall_s"]

    def _fold_stitch(self, entry: Dict) -> None:
        """Pair the two halves of one wire transfer on (trace id, block
        identity). The caller holds the lock."""
        key = (entry["trace_id"], entry["shuffle_id"], entry["map_id"],
               entry["partition"])
        halves = self._stitch.setdefault(key, {})
        halves[entry["side"]] = entry
        if "send" in halves and "recv" in halves:
            send, recv = halves.pop("send"), halves.pop("recv")
            self._stitched.append({
                "trace_id": entry["trace_id"],
                "shuffle_id": entry["shuffle_id"],
                "map_id": entry["map_id"], "partition": entry["partition"],
                "send_tier": send["tier"], "send_wall_s": send["wall_s"],
                "send_bytes": send["wire_bytes"],
                "recv_wall_s": recv["wall_s"],
                "recv_bytes": recv["wire_bytes"]})
            del self._stitch[key]
            self._totals["stitched"] += 1
            q = self._queries.get(entry["query_id"])
            if q is not None:
                q["totals"]["stitched"] += 1

    # -- reads ------------------------------------------------------------
    def drain_ring(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out

    def totals(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._totals)

    def stitched(self) -> List[Dict[str, Any]]:
        """Completed sender/receiver pairs (both halves seen)."""
        with self._lock:
            return list(self._stitched)

    def tier_aggregate(self) -> List[Dict[str, Any]]:
        """Process-wide per-(tier, phase) rows, heaviest wall first."""
        with self._lock:
            rows = [{"tier": tier, "phase": phase,
                     **{k: v for k, v in a.items() if k != "phases"}}
                    for (tier, phase), a in self._agg.items()]
        rows.sort(key=lambda r: (-r["wall_s"], -r["wire_bytes"], r["tier"],
                                 r["phase"]))
        return rows

    @staticmethod
    def _straggler(partitions: Dict[Tuple, float]) -> Optional[Dict]:
        """The slowest (shuffle, partition, tier) wall against the p50."""
        if not partitions:
            return None
        walls = sorted(partitions.values())
        p50 = walls[len(walls) // 2]
        worst = max(partitions, key=lambda k: partitions[k])
        slowest = partitions[worst]
        return {"slowest_wall_s": slowest, "p50_wall_s": p50,
                "skew": (slowest / p50) if p50 > 0 else 0.0,
                "worst": {"shuffle_id": worst[0], "partition": worst[1],
                          "tier": worst[2], "wall_s": slowest}}

    def query_summary(self, query_id: Any,
                      drain: bool = True) -> Dict[str, Any]:
        """One query's totals, per-tier and per-(shuffle, tier) rows
        (heaviest wall first) and straggler; a query that moved nothing
        gets a zero summary. ``drain`` forgets the query."""
        with self._lock:
            q = (self._queries.pop(query_id, None) if drain
                 else self._queries.get(query_id))
        if q is None:
            return {"totals": _zero_totals(), "tiers": [], "shuffles": [],
                    "straggler": None}
        tiers = [{"tier": tier, **a, "phases": dict(a["phases"])}
                 for tier, a in q["tiers"].items()]
        tiers.sort(key=lambda r: (-r["wall_s"], -r["wire_bytes"], r["tier"]))
        shuffles = [{"shuffle_id": sid, "tier": tier,
                     **{k: v for k, v in a.items() if k != "phases"}}
                    for (sid, tier), a in q["shuffles"].items()]
        shuffles.sort(key=lambda r: (-r["wall_s"], -r["wire_bytes"],
                                     str(r["shuffle_id"]), r["tier"]))
        return {"totals": dict(q["totals"]), "tiers": tiers,
                "shuffles": shuffles,
                "straggler": self._straggler(q["partitions"])}


# ---------------------------------------------------------------------------
# the module-level observatory: None when disabled
# ---------------------------------------------------------------------------
_OBSERVATORY: Optional[ShuffleObservatory] = None


def clock() -> float:
    """A hook's start stamp: ``perf_counter`` when the observatory is on,
    0.0 ("don't time") when it is off."""
    if _OBSERVATORY is None:
        return 0.0
    return time.perf_counter()


def note_transfer(tier: str, phase: str, shuffle_id: Any = None,
                  map_id: Any = None, partition: Any = None,
                  logical_bytes: Union[int, Callable[[], int]] = 0,
                  wire_bytes: Union[int, Callable[[], int]] = 0,
                  t0: float = 0.0, retries: int = 0, queue_depth: int = 0,
                  trace_id: Any = None, side: Optional[str] = None,
                  query_id: Any = None) -> None:
    """The transfer hook; one global load and an is-None check when off."""
    if _OBSERVATORY is None:
        return
    _OBSERVATORY.note(tier, phase, shuffle_id=shuffle_id, map_id=map_id,
                      partition=partition, logical_bytes=logical_bytes,
                      wire_bytes=wire_bytes, t0=t0, retries=retries,
                      queue_depth=queue_depth, trace_id=trace_id, side=side,
                      query_id=query_id)


def configure_shuffle_telemetry(conf) -> Optional[ShuffleObservatory]:
    """Install (or clear) the process-wide observatory from a RapidsConf
    (every ``TorchSession`` does; the most recent session wins)."""
    global _OBSERVATORY
    if not conf.get(SHUFFLE_TELEMETRY_ENABLED):
        _OBSERVATORY = None
        return None
    _OBSERVATORY = ShuffleObservatory(
        int(conf.get(SHUFFLE_TELEMETRY_RING_SIZE)))
    return _OBSERVATORY


def reset_shuffle_telemetry() -> None:
    global _OBSERVATORY
    _OBSERVATORY = None


def active() -> Optional[ShuffleObservatory]:
    return _OBSERVATORY


def drain_ring() -> List[Dict[str, Any]]:
    obs = _OBSERVATORY
    return obs.drain_ring() if obs is not None else []


def query_summary(query_id: Any,
                  drain: bool = True) -> Optional[Dict[str, Any]]:
    """One query's summary; None when the observatory is off."""
    obs = _OBSERVATORY
    if obs is None:
        return None
    return obs.query_summary(query_id, drain=drain)


def shuffle_telemetry_stats() -> Dict[str, Any]:
    """Process-wide transfer totals (``wall_s`` rounded to the
    microsecond); empty when the observatory is off."""
    obs = _OBSERVATORY
    if obs is None:
        return {}
    t = obs.totals()
    t["wall_s"] = round(t["wall_s"], 6)
    return t
