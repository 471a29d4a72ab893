"""Distribution metric — the port's copy of the ``Histogram`` of
``spark_rapids_tpu/utils/metrics.py`` (the task semaphore's held-time
distribution). The rest of the JAX metrics layer comes with the
observability work (ROADMAP Queue 1: breadth).
"""
from __future__ import annotations

import threading
from typing import Dict, List

__all__ = ["Histogram"]


class Histogram:
    """Distribution metric backed by the merging t-digest
    (utils/tdigest.py). Raw observations buffer in a small list and fold
    into the bounded sketch lazily, so ``observe`` on a hot path is an
    append + occasional vectorized compress."""

    __slots__ = ("name", "delta", "count", "total", "vmin", "vmax", "_buf",
                 "_digest", "_lock")

    FLUSH_AT = 1024
    DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self, name: str, delta: int = 100):
        self.name = name
        self.delta = delta
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._buf: List[float] = []
        self._digest: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            self._buf.append(v)
            if len(self._buf) >= self.FLUSH_AT:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        from .tdigest import build_digest, merge_digests
        part = build_digest(self._buf, self.delta)
        self._digest = merge_digests([self._digest, part], self.delta) \
            if self._digest else part
        self._buf = []

    def quantiles(self, qs) -> List[float]:
        from .tdigest import digest_quantiles
        with self._lock:
            self._flush_locked()
            digest = list(self._digest)
        return digest_quantiles(digest, list(qs))

    def snapshot(self) -> Dict[str, float]:
        """Summary dict (serializes into event-log node records)."""
        with self._lock:
            self._flush_locked()
            digest = list(self._digest)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        if not count:
            return {"count": 0, "sum": 0.0}
        from .tdigest import digest_quantiles
        p50, p90, p99 = digest_quantiles(digest, self.DEFAULT_QUANTILES)
        return {"count": count, "sum": total, "min": vmin, "max": vmax,
                "p50": p50, "p90": p90, "p99": p99}
