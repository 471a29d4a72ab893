"""The shuffle transport SPI — the port of
``spark_rapids_tpu/shuffle/transport.py`` (reference:
RapidsShuffleTransport.scala:303, loaded by class name at :545-569).

``LocalShuffleTransport`` is the in-process block store of the executor
tier (parallel/runtime.py ``LocalCluster``). ``load_transport`` reads
``spark.rapids.shuffle.transport.class``; a class of the JAX package
(the key's default names ``spark_rapids_tpu.shuffle.transport
.LocalShuffleTransport``) names the port's class of the same name.
"""
from __future__ import annotations

import importlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..conf import SHUFFLE_TRANSPORT_CLASS, RapidsConf

__all__ = ["BlockId", "ShuffleTransport", "LocalShuffleTransport",
           "ShuffleFetchFailedException", "load_transport"]


class BlockId(Tuple[int, int, int]):
    """(shuffle_id, map_id, reduce_id) — reference: ShuffleBlockId."""

    def __new__(cls, shuffle_id: int, map_id: int, reduce_id: int):
        return super().__new__(cls, (shuffle_id, map_id, reduce_id))


class ShuffleFetchFailedException(Exception):
    """A shuffle block could not be fetched (reference:
    RapidsShuffleFetchFailedException -> stage retry). A missing block
    fails loudly: skipping it would give a wrong answer in silence."""

    def __init__(self, block: BlockId, detail: str = ""):
        self.block = block
        super().__init__(
            f"shuffle block (shuffle={block[0]}, map={block[1]}, "
            f"reduce={block[2]}) could not be fetched"
            + (f": {detail}" if detail else ""))


class ShuffleTransport:
    """Stores blocks on the writing side and fetches them on the reading
    side. ``fetch`` raises ShuffleFetchFailedException for any block it
    cannot produce."""

    def publish(self, block: BlockId, payload: bytes) -> None:
        raise NotImplementedError

    def fetch(self, blocks: List[BlockId]) -> Iterator[Tuple[BlockId, bytes]]:
        raise NotImplementedError

    def remove_shuffle(self, shuffle_id: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalShuffleTransport(ShuffleTransport):
    """The in-process block store."""

    def __init__(self, conf: Optional[RapidsConf] = None):
        self._blocks: Dict[BlockId, bytes] = {}
        self._lock = threading.Lock()
        self.bytes_published = 0
        self.bytes_fetched = 0

    def publish(self, block: BlockId, payload: bytes) -> None:
        with self._lock:
            self._blocks[block] = payload
            self.bytes_published += len(payload)

    def fetch(self, blocks: List[BlockId]) -> Iterator[Tuple[BlockId, bytes]]:
        for b in blocks:
            with self._lock:
                payload = self._blocks.get(b)
                if payload is not None:
                    self.bytes_fetched += len(payload)
            if payload is None:
                raise ShuffleFetchFailedException(b, "not in local store")
            yield b, payload

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            for b in [b for b in self._blocks if b[0] == shuffle_id]:
                del self._blocks[b]


def load_transport(conf: RapidsConf) -> ShuffleTransport:
    """The transport class named by the conf, made with ``conf``."""
    clsname = conf.get(SHUFFLE_TRANSPORT_CLASS)
    if clsname.startswith("spark_rapids_tpu."):
        clsname = "spark_rapids_tpu_torch." + clsname.split(".", 1)[1]
    module, _, name = clsname.rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    return cls(conf)
