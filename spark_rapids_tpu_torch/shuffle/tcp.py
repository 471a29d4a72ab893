"""The TCP socket shuffle transport, the tier between processes — the port
of ``spark_rapids_tpu/shuffle/tcp.py``, wire-compatible with it (reference:
RapidsShuffleServer.scala:70 serving block data, RapidsShuffleClient.scala:88
fetching from peers).

- Published blocks go into a spill-backed host store: an in-memory budget
  (``spark.rapids.tpu.shuffle.host.storeBytes``) whose overflow spills
  oldest first to local disk files, served from there. A block may be
  registered lazily (``put_lazy``): its provider runs on the first request
  (the DCN tier keeps blocks on the device until a peer asks).
- The server streams a block in fixed windows (ranged GETs of
  ``spark.rapids.tpu.shuffle.tcp.chunkBytes``), never holding more than a
  chunk per connection.
- The client fetches remote blocks through a small pool under a receive
  byte budget (``spark.rapids.shuffle.transport.maxReceiveInflightBytes``,
  RapidsConf.scala:1064): a block reserves its size before its chunks
  stream in, in the consumer's order (a turnstile), and the reservation is
  released when the consumer takes it.
- Transient socket errors retry with exponential backoff and jitter; a peer
  that answers "not found" is definitive (fetch failed -> recompute).
  ``tcp.connect`` and ``tcp.read`` are fault points.

Wire protocol (little-endian), one request per connection::

    request:  magic 'SRTB'|'SRTC' | u8 op | i64 shuffle | i64 map |
              i64 reduce
              (magic SRTC only) | 16s trace_id | u64 parent_span | i64 qid
              (op GET_RANGE only) | i64 offset | i64 max_len
    response: u8 found | u64 total_len | (GET_RANGE only) u64 chunk_len |
              payload
    ops: 1 = GET (whole block), 2 = REMOVE_SHUFFLE, 3 = GET_RANGE

The server accepts both magics: it reads the JAX package's traced header
(``SRTC``) and drops it, since the port has no ``utils/tracing.py`` yet
(ROADMAP Queue 1: breadth). The client sends ``SRTB``.
"""
from __future__ import annotations

import os
import random
import socket
import struct
import tempfile
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

from ..conf import (HOST_STORE_BYTES, MAX_RECEIVE_INFLIGHT, TCP_CHUNK_BYTES,
                    TCP_CONNECT_TIMEOUT, TCP_MAX_PROVIDER_RETRIES,
                    TCP_READ_TIMEOUT, TCP_RETRY_ATTEMPTS,
                    TCP_RETRY_BACKOFF_MS, TCP_RETRY_MAX_BACKOFF_MS,
                    RapidsConf)
from ..utils import faults
from . import telemetry
from .transport import (BlockId, ShuffleFetchFailedException,
                        ShuffleTransport)

__all__ = ["TcpShuffleTransport"]

_MAGIC = b"SRTB"
_MAGIC_TRACED = b"SRTC"
_OP_GET = 1
_OP_REMOVE = 2
_OP_GET_RANGE = 3
_REQ = struct.Struct("<4sBqqq")
#: the traced header of the JAX package's TraceContext (16s trace id, u64
#: parent span, i64 query id), read and dropped
_TRACE_CTX = struct.Struct("<16sQq")
_RANGE_EXT = struct.Struct("<qq")
_RESP_HEAD = struct.Struct("<BQ")
_RESP_CHUNK = struct.Struct("<Q")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        # every caller sets a read timeout on the socket first
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


class _HostBlockStore:
    """Budgeted in-memory block store with oldest-first disk spill."""

    def __init__(self, budget_bytes: int, max_provider_retries: int = 3):
        self._budget = budget_bytes
        self._max_provider_retries = max(1, int(max_provider_retries))
        self._mem: "OrderedDict[BlockId, bytes]" = OrderedDict()
        self._disk: Dict[BlockId, Tuple[str, int]] = {}   # path, length
        self._providers: Dict[BlockId, object] = {}   # lazy payload fns
        self._provider_retries: Dict[BlockId, int] = {}
        self._spilling: set = set()   # victims mid-write, still in _mem
        self._lock = threading.Lock()
        self._mat_inflight: set = set()   # blocks materializing right now
        self._mat_cond = threading.Condition(self._lock)
        self._dir: Optional[str] = None
        self.mem_bytes = 0
        self.spilled_blocks = 0
        self.spilled_bytes = 0

    def _spill_dir(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="srt-shuffle-blocks-")
        return self._dir

    def put(self, block: BlockId, payload: bytes) -> None:
        with self._lock:
            old = self._mem.pop(block, None)
            if old is not None:
                self.mem_bytes -= len(old)
            disk_old = self._disk.pop(block, None)
            self._mem[block] = payload
            self.mem_bytes += len(payload)
            # choose spill victims but KEEP them readable in _mem until
            # their disk entry exists — a concurrent read during the file
            # write must never see the block in neither map
            victims = []
            excess = self.mem_bytes - self._budget
            for b in list(self._mem.keys()):            # oldest first
                if excess <= 0 or \
                        len(self._mem) - len(self._spilling) <= 1:
                    break
                if b in self._spilling or b == block:
                    continue
                self._spilling.add(b)
                victims.append((b, self._mem[b]))
                excess -= len(self._mem[b])
        if disk_old is not None:
            _unlink_quietly(disk_old[0])
        for victim, data in victims:
            path = os.path.join(
                self._spill_dir(),
                f"b{victim[0]}_{victim[1]}_{victim[2]}.blk")
            with open(path, "wb") as f:
                f.write(data)
            with self._lock:
                self._spilling.discard(victim)
                if self._mem.get(victim) is data:   # not replaced/removed
                    self._disk[victim] = (path, len(data))
                    del self._mem[victim]
                    self.mem_bytes -= len(data)
                    self.spilled_blocks += 1
                    self.spilled_bytes += len(data)
                    continue
            _unlink_quietly(path)

    def put_lazy(self, block: BlockId, provider) -> None:
        """Register a deferred payload: ``provider()`` -> bytes runs on the
        first request for this block (DCN tier: blocks stay device-resident
        until a remote peer actually asks — most never serialize)."""
        with self._lock:
            self._providers[block] = provider

    def lazy_depth(self) -> int:
        """Publish-queue depth: lazy providers registered but not yet
        materialized (the shuffle observatory's backpressure signal)."""
        with self._lock:
            return len(self._providers)

    def _materialize(self, block: BlockId) -> None:
        with self._lock:
            # a concurrent materialization of this block: wait for it to
            # land in _mem/_disk instead of reporting the block missing
            while block in self._mat_inflight:
                self._mat_cond.wait()
            provider = self._providers.pop(block, None)
            if provider is None:
                return
            self._mat_inflight.add(block)
        try:
            payload = provider()
        except Exception:
            with self._lock:
                # keep it requestable for a retry, but bounded: a
                # crash-looping provider must not stay registered (and
                # pin its inputs in host memory) forever — after the
                # budget the block simply reports missing, which the
                # fetch path turns into fetch-failed -> recompute
                n = self._provider_retries.get(block, 0) + 1
                self._provider_retries[block] = n
                if n < self._max_provider_retries:
                    self._providers.setdefault(block, provider)
                self._mat_inflight.discard(block)
                self._mat_cond.notify_all()
            raise
        self.put(block, payload)
        with self._lock:
            self._provider_retries.pop(block, None)
            self._mat_inflight.discard(block)
            self._mat_cond.notify_all()

    def length(self, block: BlockId) -> Optional[int]:
        with self._lock:
            pending = block in self._providers \
                or block in self._mat_inflight
        if pending:
            self._materialize(block)
        with self._lock:
            data = self._mem.get(block)
            if data is not None:
                return len(data)
            entry = self._disk.get(block)
            return None if entry is None else entry[1]

    def read(self, block: BlockId, offset: int, n: int) -> Optional[bytes]:
        with self._lock:
            pending = block in self._providers \
                or block in self._mat_inflight
        if pending:
            self._materialize(block)
        with self._lock:
            data = self._mem.get(block)
            entry = self._disk.get(block) if data is None else None
        if data is not None:
            return data[offset:offset + n]
        if entry is None:
            return None
        path, _ = entry
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(n)
        except OSError:
            return None

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            for b in [b for b in self._providers if b[0] == shuffle_id]:
                del self._providers[b]
            for b in [b for b in self._provider_retries
                      if b[0] == shuffle_id]:
                del self._provider_retries[b]
            for b in [b for b in self._mem if b[0] == shuffle_id]:
                self.mem_bytes -= len(self._mem.pop(b))
            doomed = [self._disk.pop(b)[0]
                      for b in [b for b in self._disk if b[0] == shuffle_id]]
        for path in doomed:
            _unlink_quietly(path)

    def close(self) -> None:
        with self._lock:
            paths = [p for (p, _) in self._disk.values()]
            self._disk.clear()
            self._mem.clear()
            self.mem_bytes = 0
            spill_dir, self._dir = self._dir, None
        for p in paths:
            _unlink_quietly(p)
        if spill_dir is not None:
            try:
                os.rmdir(spill_dir)
            except OSError:
                pass


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class _Turnstile:
    """Orders inflight-budget acquisitions by ticket: ticket k proceeds
    only after tickets < k have acquired (or bailed). Idempotent advance."""

    def __init__(self):
        self._next = 0
        self._cv = threading.Condition()

    def wait_turn(self, ticket: int) -> None:
        with self._cv:
            while self._next < ticket:
                self._cv.wait()

    def advance(self, ticket: int) -> None:
        with self._cv:
            if ticket + 1 > self._next:
                self._next = ticket + 1
                self._cv.notify_all()


class _InflightBudget:
    """Counting byte semaphore for the receive throttle."""

    def __init__(self, limit: int):
        self._limit = limit
        self._used = 0
        self._cv = threading.Condition()
        self.peak = 0

    def acquire(self, n: int) -> None:
        n = min(n, self._limit)  # one oversized block must not deadlock
        with self._cv:
            while self._used + n > self._limit:
                self._cv.wait()
            self._used += n
            self.peak = max(self.peak, self._used)

    def release(self, n: int) -> None:
        n = min(n, self._limit)
        with self._cv:
            self._used -= n
            self._cv.notify_all()


class TcpShuffleTransport(ShuffleTransport):
    """A block server on ``host:port`` (an ephemeral port by default) and a
    client of the peers added with ``add_peer``."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 host: str = "127.0.0.1", port: int = 0):
        conf = conf or RapidsConf()
        self.chunk_bytes = int(conf.get(TCP_CHUNK_BYTES))
        self._connect_timeout = float(conf.get(TCP_CONNECT_TIMEOUT))
        self._read_timeout = float(conf.get(TCP_READ_TIMEOUT))
        self._retry_attempts = max(1, int(conf.get(TCP_RETRY_ATTEMPTS)))
        self._backoff_s = float(conf.get(TCP_RETRY_BACKOFF_MS)) / 1000.0
        self._max_backoff_s = \
            float(conf.get(TCP_RETRY_MAX_BACKOFF_MS)) / 1000.0
        self._jitter = random.Random()
        #: set at close(): retry backoffs wait on it so shutdown never
        #: has to wait out a backoff schedule
        self._closed = threading.Event()
        self.store = _HostBlockStore(
            int(conf.get(HOST_STORE_BYTES)),
            int(conf.get(TCP_MAX_PROVIDER_RETRIES)))
        self.inflight = _InflightBudget(int(conf.get(MAX_RECEIVE_INFLIGHT)))
        self._lock = threading.Lock()
        self._peers: List[Tuple[str, int]] = []
        self.bytes_published = 0
        self.bytes_fetched = 0
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(32)
        self._closing = False
        self._thread = threading.Thread(target=self._serve,
                                        name="srt-shuffle-server",
                                        daemon=True)
        self._thread.start()

    # -- server side ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self._server.getsockname()

    def _serve(self):
        while not self._closing:
            try:
                # blocks until close() tears the socket down
                conn, _ = self._server.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._handle, args=(conn,),
                             name="srt-shuffle-conn",
                             daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            with conn:
                # a stalled or malicious client must not pin a server
                # thread forever
                conn.settimeout(self._read_timeout)
                raw = _recv_exact(conn, _REQ.size)
                magic, op, sid, mid, rid = _REQ.unpack(raw)
                if magic == _MAGIC_TRACED:
                    _recv_exact(conn, _TRACE_CTX.size)  # read and dropped
                elif magic != _MAGIC:
                    return
                self._serve_request(conn, op, sid, mid, rid)
        except Exception:  # noqa: BLE001
            # a broken client connection must not kill the server; the
            # client retries or takes the block as missing
            pass

    def _serve_request(self, conn: socket.socket, op: int, sid: int,
                       mid: int, rid: int):
        if op == _OP_REMOVE:
            self.remove_shuffle(sid)
            conn.sendall(_RESP_HEAD.pack(1, 0))
            return
        block = BlockId(sid, mid, rid)
        if op == _OP_GET_RANGE:
            off, max_len = _RANGE_EXT.unpack(
                _recv_exact(conn, _RANGE_EXT.size))
            t0 = telemetry.clock()
            total = self.store.length(block)
            if total is None:
                conn.sendall(_RESP_HEAD.pack(0, 0))
                return
            n = max(0, min(max_len, self.chunk_bytes, total - off))
            payload = self.store.read(block, off, n) or b""
            conn.sendall(_RESP_HEAD.pack(1, total)
                         + _RESP_CHUNK.pack(len(payload)))
            conn.sendall(payload)
            telemetry.note_transfer(
                "transport", "serve", shuffle_id=sid, map_id=mid,
                partition=rid, wire_bytes=len(payload), t0=t0)
            return
        # whole-block GET (compat): stream it in windows anyway so
        # the server never materializes more than a chunk per send
        total = self.store.length(block)
        if total is None:
            conn.sendall(_RESP_HEAD.pack(0, 0))
            return
        conn.sendall(_RESP_HEAD.pack(1, total))
        off = 0
        while off < total:
            n = min(self.chunk_bytes, total - off)
            piece = self.store.read(block, off, n)
            if not piece:
                return  # store lost the block mid-stream
            conn.sendall(piece)
            off += len(piece)

    # -- client side ----------------------------------------------------------
    def add_peer(self, host: str, port: int):
        self._peers.append((host, port))

    def _range_from_peer(self, addr: Tuple[str, int], block: BlockId,
                         offset: int) -> Optional[Tuple[int, bytes]]:
        """One ranged request -> (total_len, chunk) or None if absent.

        Transient socket errors (connect refused/reset/timeout) are
        retried with exponential backoff + jitter up to
        ``tcp.retryAttempts``; a live peer answering found=0 is a
        definitive miss and returns at once — that keeps the missing-block
        path on ShuffleFetchFailedException -> recompute while flaky
        networks just retry."""
        head = _REQ.pack(_MAGIC, _OP_GET_RANGE, *block)
        for attempt in range(self._retry_attempts):
            if attempt:
                faults.note_recovery("transport_retries")
                delay = min(self._backoff_s * (2 ** (attempt - 1)),
                            self._max_backoff_s)
                delay *= 0.5 + self._jitter.random()  # +/-50% jitter
                if self._closed.wait(delay):
                    return None  # transport shut down mid-backoff
            try:
                if faults.fire("tcp.connect") not in (None, "delay"):
                    raise ConnectionRefusedError(
                        "injected fault 'tcp.connect'")
                t_conn = telemetry.clock()
                with socket.create_connection(
                        addr, timeout=self._connect_timeout) as s:
                    telemetry.note_transfer(
                        "transport", "connect", shuffle_id=block[0],
                        map_id=block[1], partition=block[2], t0=t_conn,
                        retries=attempt)
                    s.settimeout(self._read_timeout)
                    t_send = telemetry.clock()
                    s.sendall(head
                              + _RANGE_EXT.pack(offset, self.chunk_bytes))
                    telemetry.note_transfer(
                        "transport", "send", shuffle_id=block[0],
                        map_id=block[1], partition=block[2], t0=t_send,
                        wire_bytes=len(head) + _RANGE_EXT.size)
                    if faults.fire("tcp.read") not in (None, "delay"):
                        raise ConnectionResetError(
                            "injected fault 'tcp.read'")
                    t_recv = telemetry.clock()
                    found, total = _RESP_HEAD.unpack(
                        _recv_exact(s, _RESP_HEAD.size))
                    if not found:
                        return None  # definitive miss: peer is up, no block
                    (clen,) = _RESP_CHUNK.unpack(
                        _recv_exact(s, _RESP_CHUNK.size))
                    chunk = _recv_exact(s, clen)
                    telemetry.note_transfer(
                        "transport", "recv", shuffle_id=block[0],
                        map_id=block[1], partition=block[2], t0=t_recv,
                        wire_bytes=clen, retries=attempt)
                    return int(total), chunk
            except OSError:
                continue  # transient or dead peer: back off and retry
        faults.note_recovery("transport_giveups")
        return None  # unreachable after retries == block not found here

    def _fetch_remote(self, block: BlockId, turnstile: "_Turnstile",
                      ticket: int) -> Optional[Tuple[bytes, int]]:
        """Assemble a block from a peer chunk by chunk.

        The inflight reservation is acquired in STRICT consumer order via
        the turnstile (ticket = position in the fetch list): ticket k's
        acquire can only ever wait on releases of blocks < k, so the
        budget can never deadlock head-of-line. Returns
        (payload, reserved_bytes) — the caller owns the release."""
        try:
            for addr in self._peers:
                first = self._range_from_peer(addr, block, 0)
                if first is None:
                    continue
                total, chunk = first
                turnstile.wait_turn(ticket)
                self.inflight.acquire(total)
                turnstile.advance(ticket)
                try:
                    parts = [chunk]
                    got = len(chunk)
                    while got < total:
                        nxt = self._range_from_peer(addr, block, got)
                        if nxt is None or not nxt[1]:
                            break
                        parts.append(nxt[1])
                        got += len(nxt[1])
                    if got != total:
                        self.inflight.release(total)
                        continue  # torn block; try the next peer
                    return b"".join(parts), total
                except BaseException:
                    self.inflight.release(total)
                    raise
            return None
        finally:
            turnstile.advance(ticket)  # idempotent: never block later tickets

    # -- SPI ------------------------------------------------------------------
    def publish(self, block: BlockId, payload: bytes) -> None:
        self.store.put(block, payload)
        with self._lock:
            self.bytes_published += len(payload)

    def fetch(self, blocks: List[BlockId]) -> Iterator[Tuple[BlockId, bytes]]:
        """Local blocks served from the store; remote blocks prefetched by
        a small pool under the receive-inflight cap, yielded in order."""
        local: Dict[BlockId, bool] = {}
        for b in blocks:
            local[b] = self.store.length(b) is not None
        remote = [b for b in blocks if not local[b]]
        pool = ThreadPoolExecutor(max_workers=4,
                                  thread_name_prefix="srt-shuffle-fetch") \
            if remote else None
        turnstile = _Turnstile()
        futures = {}
        consumed: set = set()
        try:
            for ticket, b in enumerate(remote):
                futures[b] = pool.submit(self._fetch_remote, b, turnstile,
                                         ticket)
            for b in blocks:
                if local[b]:
                    total = self.store.length(b)
                    payload = self.store.read(b, 0, total) \
                        if total is not None else None
                    if payload is None or len(payload) != total:
                        raise ShuffleFetchFailedException(
                            b, "local block vanished from the store")
                else:
                    res = futures[b].result()
                    consumed.add(b)
                    if res is None:
                        raise ShuffleFetchFailedException(
                            b, f"not found locally or on "
                               f"{len(self._peers)} peers")
                    payload, reserved = res
                    self.inflight.release(reserved)
                with self._lock:
                    self.bytes_fetched += len(payload)
                yield b, payload
        finally:
            # abandoned/errored: reservations of unconsumed prefetches must
            # not leak (they would poison every later fetch) — release as
            # each outstanding future completes
            for b, fut in futures.items():
                if b in consumed:
                    continue
                fut.add_done_callback(self._release_unconsumed)
            if pool is not None:
                pool.shutdown(wait=False)

    def _release_unconsumed(self, fut) -> None:
        try:
            res = fut.result()
        except BaseException:
            return  # worker already released on its error path
        if res is not None:
            self.inflight.release(res[1])

    def remove_shuffle(self, shuffle_id: int) -> None:
        self.store.remove_shuffle(shuffle_id)

    def close(self) -> None:
        self._closing = True
        self._closed.set()  # interrupt any retry backoff in flight
        try:
            self._server.close()
        except OSError:
            pass
        self.store.close()
