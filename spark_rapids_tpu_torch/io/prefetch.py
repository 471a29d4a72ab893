"""Bounded read-ahead over an ordered work list — the port of
``prefetched`` from ``spark_rapids_tpu/io/prefetch.py`` (reference: the
multithreaded readers' read-pool pipelining, GpuMultiFileReader.scala:934).

Submits up to ``window`` items to a thread pool and yields ``(item,
result)`` pairs in order, keeping the window full as items complete.
Bounding the window caps the data held at once (a whole-partition submit
would pin every file's bytes until the consumer drains them).
"""
from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

__all__ = ["prefetched"]

T = TypeVar("T")
R = TypeVar("R")


def prefetched(items: Iterable[T], fn: Callable[[T], R],
               window: int) -> Iterator[Tuple[T, R]]:
    items = list(items)
    if not items:
        return
    window = max(1, window)
    with cf.ThreadPoolExecutor(max_workers=window,
                               thread_name_prefix="srt-io-prefetch") as pool:
        pending: deque = deque()  # (item, future): the pairing stays exact
        it = iter(items)
        for x in it:
            pending.append((x, pool.submit(fn, x)))
            if len(pending) >= window:
                break
        while pending:
            item, fut = pending.popleft()
            result = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(fn, nxt)))
            yield item, result
