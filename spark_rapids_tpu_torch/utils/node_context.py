"""Thread-local "which operator is executing" stack — the port of
``spark_rapids_tpu/utils/node_context.py``.

Process-wide services (the buffer catalog's register and spill paths, the
memory profiler) work on behalf of whatever exec node is running but hold
no reference to it. A ``node_scope`` pushed around an operator's work
attributes an allocation or a spill to the innermost node driving it, per
(query, node_id): every device operator pushes one around each resume of
its batch generator (exec/base.py), inside the ``query_scope`` of its
``collect``. Runs outside any scope attribute to nobody: ``current()`` is
None and callers fall back to process-global counters.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

__all__ = ["NodeContext", "node_scope", "current", "current_registry",
           "active_contexts", "query_scope", "current_query"]


class NodeContext:
    __slots__ = ("node_id", "name", "registry", "query_id")

    def __init__(self, node_id: int, name: str, registry=None,
                 query_id: Optional[int] = None):
        self.node_id = node_id
        self.name = name
        self.registry = registry  # the node's MetricRegistry (may be None)
        self.query_id = query_id

    def __repr__(self):
        return f"NodeContext({self.node_id}, {self.name!r})"


_TLS = threading.local()

# cross-thread registry of every thread's context stack, so a report can
# name the (query, operator) each live thread is executing (a thread-local
# alone is invisible from another thread)
_ALL_LOCK = threading.Lock()
_ALL_STACKS: dict = {}  # thread ident -> that thread's stack list


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
        with _ALL_LOCK:
            _ALL_STACKS[threading.get_ident()] = st
    return st


def current_query() -> Optional[int]:
    """The query id of the calling thread's innermost ``query_scope``."""
    return getattr(_TLS, "query_id", None)


@contextmanager
def query_scope(query_id: int):
    """Mark the dynamic extent as query ``query_id``'s (a collect): the
    node scopes opened inside it default to that query."""
    prev = getattr(_TLS, "query_id", None)
    _TLS.query_id = query_id
    try:
        yield
    finally:
        _TLS.query_id = prev


@contextmanager
def node_scope(node_id: int, name: str, registry=None,
               query_id: Optional[int] = None):
    """Mark ``node_id`` as the executing operator for the dynamic extent.

    Nested scopes stack: a child generator resumed inside a parent's scope
    pushes itself on top, so ``current()`` is always the innermost node."""
    st = _stack()
    if query_id is None:
        query_id = current_query()
    st.append(NodeContext(node_id, name, registry, query_id))
    try:
        yield
    finally:
        st.pop()


def current() -> Optional[NodeContext]:
    """The innermost executing node's context, or None when uninstrumented."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def current_registry():
    """The innermost executing node's MetricRegistry, or None."""
    ctx = current()
    return ctx.registry if ctx is not None else None


def active_contexts() -> dict:
    """Best-effort {thread name: innermost context} across all live
    threads. Reads
    other threads' stacks racily — a context may pop mid-read — so stale
    or missing entries are tolerated, never an error."""
    alive = {t.ident: t.name for t in threading.enumerate()}
    with _ALL_LOCK:
        # GC stacks of threads that have exited
        for tid in [tid for tid in _ALL_STACKS if tid not in alive]:
            del _ALL_STACKS[tid]
        items = list(_ALL_STACKS.items())
    out = {}
    for tid, st in items:
        try:
            ctx = st[-1]
        except IndexError:
            continue
        out[alive.get(tid, str(tid))] = (
            f"query={ctx.query_id} node={ctx.node_id} {ctx.name}")
    return out
