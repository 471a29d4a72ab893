"""Merging t-digest sketch (vectorized numpy) — the port's copy of
``spark_rapids_tpu/utils/tdigest.py``, which the semaphore's held-time
histogram (utils/metrics.py) folds its observations into.

A one-pass k-scale binning of sorted values (Dunning's merging digest with
the k1 scale function). State: one flat list of floats, ``[vmin, vmax,
mean0, weight0, mean1, weight1, ...]``; the empty digest is ``[]``. A digest
holds at most about ``delta/2 + 2`` centroids whatever the input size.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["build_digest", "merge_digests", "digest_quantiles"]


def _k(q: np.ndarray, delta: float) -> np.ndarray:
    q = np.clip(q, 0.0, 1.0)
    return delta / (2.0 * np.pi) * np.arcsin(2.0 * q - 1.0)


def _compress(means: np.ndarray, weights: np.ndarray,
              delta: float) -> tuple:
    """Merge weight-ordered centroids that land in the same k-bin."""
    W = weights.sum()
    if W <= 0 or len(means) == 0:
        return means[:0], weights[:0]
    cum = np.cumsum(weights)
    qmid = (cum - weights / 2.0) / W
    bins = np.floor(_k(qmid, delta)).astype(np.int64)
    change = np.nonzero(np.diff(bins))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(means)]])
    cw = np.concatenate([[0.0], np.cumsum(weights)])
    cwm = np.concatenate([[0.0], np.cumsum(weights * means)])
    w_out = cw[ends] - cw[starts]
    m_out = (cwm[ends] - cwm[starts]) / w_out
    return m_out, w_out


def _encode(vmin: float, vmax: float, means: np.ndarray,
            weights: np.ndarray) -> List[float]:
    out = [float(vmin), float(vmax)]
    for m, w in zip(means, weights):
        out.append(float(m))
        out.append(float(w))
    return out


def _decode(digest: Sequence[float]):
    if not len(digest):
        return None
    d = np.asarray(digest, dtype=np.float64)
    return d[0], d[1], d[2::2], d[3::2]


def build_digest(values: np.ndarray, delta: int) -> List[float]:
    """Sketch a batch of raw values (the partial-aggregate update)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    v = v[~np.isnan(v)]
    n = len(v)
    if n == 0:
        return []
    q = (np.arange(n) + 0.5) / n
    bins = np.floor(_k(q, float(delta))).astype(np.int64)
    change = np.nonzero(np.diff(bins))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    cs = np.concatenate([[0.0], np.cumsum(v)])
    counts = (ends - starts).astype(np.float64)
    means = (cs[ends] - cs[starts]) / counts
    return _encode(v[0], v[-1], means, counts)


def merge_digests(digests: Sequence[Sequence[float]],
                  delta: int) -> List[float]:
    """Merge partial digests (the merge-aggregate op)."""
    decoded = [d for d in (_decode(x) for x in digests) if d is not None]
    if not decoded:
        return []
    vmin = min(d[0] for d in decoded)
    vmax = max(d[1] for d in decoded)
    means = np.concatenate([d[2] for d in decoded])
    weights = np.concatenate([d[3] for d in decoded])
    order = np.argsort(means, kind="stable")
    m_out, w_out = _compress(means[order], weights[order], float(delta))
    return _encode(vmin, vmax, m_out, w_out)


def digest_quantiles(digest: Sequence[float],
                     qs: Sequence[float]) -> List[float]:
    """Interpolated quantiles (reference t-digest percentile_approx also
    interpolates between centroids, unlike Spark CPU's exact-value pick —
    the reference documents the same divergence)."""
    d = _decode(digest)
    if d is None:
        return [float("nan")] * len(qs)
    vmin, vmax, means, weights = d
    W = weights.sum()
    cum = np.cumsum(weights)
    mid = cum - weights / 2.0
    xs = np.concatenate([[0.0], mid, [W]])
    ys = np.concatenate([[vmin], means, [vmax]])
    t = np.asarray(qs, dtype=np.float64) * W
    return np.interp(t, xs, ys).tolist()
