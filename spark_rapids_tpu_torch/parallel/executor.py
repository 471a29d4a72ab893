"""Executor-side runtime context and failure detection — the port of
``spark_rapids_tpu/parallel/executor.py``.

- ``ExecutorContext.initialize`` ~ RapidsExecutorPlugin.init
  (Plugin.scala:189-241): the device, the spill catalog, the admission
  semaphore, the shuffle manager, registration with the heartbeats.
- ``FailureDetector`` ~ the control plane's side of
  RapidsShuffleHeartbeatManager.scala: peers that miss beats are declared
  dead, once, to every listener.

Executors of one process on one card share the process's spill catalog
(memory/catalog.py): the card's memory is one budget. An executor runs on
the card (``"cuda"``) unless the caller asks for another device, and raises
without a CUDA device, as ``TorchSession`` does.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..columnar.device import resolve_device
from ..conf import CONCURRENT_GPU_TASKS, RapidsConf
from ..memory.semaphore import TaskSemaphore
from ..shuffle.manager import ShuffleManager

__all__ = ["ExecutorContext", "FailureDetector"]


class ExecutorContext:
    """What one executor owns: its device, the spill catalog, an admission
    semaphore, a shuffle manager, a broadcast manager and (made on first
    use) a DCN-tier transport."""

    def __init__(self, executor_id: int, conf: Optional[RapidsConf] = None,
                 transport=None, device=None, buffer_catalog=None):
        self.executor_id = executor_id
        self.conf = conf or RapidsConf()
        self.device = resolve_device(device, "ExecutorContext")
        self._transport = transport
        self._buffer_catalog = buffer_catalog
        self.catalog = None
        self.semaphore: Optional[TaskSemaphore] = None
        self.shuffle: Optional[ShuffleManager] = None
        self.broadcast = None
        self._dcn = None
        self.initialized = False

    def initialize(self) -> "ExecutorContext":
        """Fail fast, as the reference does: an executor that cannot set up
        its device or memory raises here."""
        from ..memory.catalog import get_catalog
        self.catalog = get_catalog(self.conf, self.device)
        self.semaphore = TaskSemaphore(self.conf.get(CONCURRENT_GPU_TASKS))
        self.shuffle = ShuffleManager(self.conf, self._transport, self.device,
                                      self._buffer_catalog)
        self.shuffle.heartbeats.register(self.executor_id)
        # a broadcast materialises once and re-materialises from the
        # transport on every other executor (reference:
        # GpuBroadcastExchangeExec.scala:336-345)
        from ..shuffle.broadcast import BroadcastManager
        self.broadcast = BroadcastManager(
            self.shuffle.transport, self.catalog, self.conf.min_bucket_rows,
            self.device)
        self.initialized = True
        return self

    def dcn_transport(self):
        """The DCN-tier transport, made on first use: blocks stay resident
        on this executor's device, host bytes only on the TCP wire
        (shuffle/dcn.py ``TcpDcnShuffleTransport``)."""
        if self._dcn is None:
            from ..shuffle.dcn import TcpDcnShuffleTransport
            self._dcn = TcpDcnShuffleTransport(self.conf, self.device,
                                               self.catalog)
        return self._dcn

    def heartbeat(self) -> None:
        if self.shuffle is not None:
            self.shuffle.heartbeats.heartbeat(self.executor_id)

    def shutdown(self) -> None:
        if self._dcn is not None:
            self._dcn.close()
            self._dcn = None
        if self.broadcast is not None:
            self.broadcast.close()
        if self.shuffle is not None:
            self.shuffle.unregister_all()
            if self._transport is None:  # only a transport made here
                self.shuffle.transport.close()
        self.initialized = False


class FailureDetector:
    """Declares a peer dead ``timeout_s`` after its last heartbeat and tells
    every listener once; a listener's error does not stop the others."""

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[int, float] = {}
        self._dead: set = set()
        self._listeners: List[Callable[[int], None]] = []
        self._lock = threading.Lock()
        #: listener errors, (peer, exception), kept for the caller to read
        self.listener_errors: List[tuple] = []

    def on_peer_lost(self, fn: Callable[[int], None]) -> None:
        self._listeners.append(fn)

    def heartbeat(self, executor_id: int) -> None:
        with self._lock:
            self._last[executor_id] = self._clock()
            self._dead.discard(executor_id)  # a returning peer recovered

    def check(self) -> List[int]:
        """Newly dead peers; their listeners are told."""
        now = self._clock()
        with self._lock:
            newly = [e for e, t in self._last.items()
                     if e not in self._dead and now - t >= self.timeout_s]
            self._dead.update(newly)
        for e in newly:
            for fn in self._listeners:
                try:
                    fn(e)
                except Exception as exc:  # noqa: BLE001 - recorded
                    self.listener_errors.append((e, exc))
        return newly

    def live(self) -> List[int]:
        with self._lock:
            return sorted(e for e in self._last if e not in self._dead)

    def dead(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)
