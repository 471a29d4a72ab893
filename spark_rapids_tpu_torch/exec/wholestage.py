"""Whole-stage fusion — the port of ``spark_rapids_tpu/exec/wholestage.py``.

Adjacent fusible device operators are composed into one node. PyTorch runs
eagerly, so the node composes the chain's per-batch functions and runs them
back to back on each batch (the JAX package compiles the same composition
into one XLA program). The plan shape and ``explain`` stay those of the JAX
package: ``TpuWholeStage[Filter+Project+HashAggregate]``.

Each batch runs through the retry ladder's dispatch chokepoint
(``wrap_dispatch``, the ``alloc.jit`` point) inside a split-and-retry scope
(the chain is row-wise, and a partial aggregate's half states merge
downstream), inside the host-fallback boundary: a terminal failure runs the
batch through the chain's host-engine twins instead of failing the query.

Input donation (``spark.rapids.tpu.donation.*``): PyTorch has no
``donate_argnums``, but a batch the stage owns alone (an upload the scan
cache does not keep, exec/transitions.py ``mark_exclusive``) is handed over
in a box the stage empties, so the chain holds the only reference and each
plane is freed, for the caching allocator to reuse, as soon as the chain
has consumed it. Donated bytes count in ``donatedBytes``; on an OOM the
ladder rebuilds the batch from its host origin (``wrap_dispatch_donating``).
Cached and spill-registered batches are never donated.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..columnar.device import DeviceTable
from ..conf import DONATION_ENABLED, DONATION_FORCE, RapidsConf
from .base import TpuExec

__all__ = ["TpuWholeStageExec", "fuse_stages", "donation_active",
           "DONATED_BYTES"]

DONATED_BYTES = "donatedBytes"


def donation_active(conf: Optional[RapidsConf],
                    device: Optional[torch.device]) -> bool:
    """Whether fused stages donate their exclusively owned inputs: on by
    default on CUDA, on the CPU only with ``donation.force``."""
    if conf is None or not conf.get(DONATION_ENABLED):
        return False
    if conf.get(DONATION_FORCE):
        return True
    return device is not None and device.type == "cuda"


class _Donated:
    """An exclusively owned batch handed to a donating dispatch. The ladder
    and the fallback hold the box, never the table: the dispatch takes the
    table out, so the chain holds its only reference."""

    def __init__(self, table: DeviceTable):
        self.table: Optional[DeviceTable] = table
        self.device = table.device
        #: the rebuild from the host origin (wrap_dispatch_donating)
        self._srt_remat = getattr(table, "_srt_remat", None)

    def take(self) -> DeviceTable:
        table, self.table = self.table, None
        if table is None:
            if self._srt_remat is None:
                raise RuntimeError("a donated batch was consumed and has no "
                                   "host origin to rebuild it from")
            table = self._srt_remat()
        return table

    def to_host(self):
        """The batch on the host (the fallback's download)."""
        return self.take().to_host()


class TpuWholeStageExec(TpuExec):
    """Wraps a linear chain of fusible TpuExecs [bottom, ..., top]."""

    def __init__(self, chain: List[TpuExec], donate_inputs: bool = False):
        super().__init__()
        if not chain:
            raise ValueError("empty fusion chain")
        # flatten nested whole-stages: the bottom-up pass wraps inner chains
        # before outer fusible parents are seen
        self.chain = [m for n in chain
                      for m in (n.chain if isinstance(n, TpuWholeStageExec)
                                else [n])]
        self.donate_inputs = donate_inputs
        # the producer feeding the chain (transition or non-fused exec)
        self.source = self.chain[0].children[0]
        self.children = (self.source,)
        self.schema = self.chain[-1].schema
        self.metrics[DONATED_BYTES] = 0

    @property
    def num_partitions(self) -> int:
        return self.source.num_partitions

    def node_name(self):
        inner = "+".join(type(n).__name__.replace("Tpu", "").replace("Exec", "")
                         for n in self.chain)
        return f"TpuWholeStage[{inner}]"

    def runs_kernel(self) -> bool:
        return any(n.runs_kernel() for n in self.chain)

    def plan_signature(self) -> str:
        return "WS|" + "||".join(n.plan_signature() for n in self.chain)

    def batch_fn(self):
        """The composed chain function."""
        fns = [n.batch_fn() for n in self.chain]

        def run(table: DeviceTable) -> DeviceTable:
            for f in fns:
                table = f(table)
            return table
        return run

    def host_batch_fn(self):
        """The composed host-engine chain, or None when a member has no
        host path (the stage then quarantines on a terminal failure but
        cannot recover the batch)."""
        fns = [n.host_batch_fn() for n in self.chain]
        if any(f is None for f in fns):
            return None

        def run(table):
            for f in fns:
                table = f(table)
            return table
        return run

    def _min_bucket(self) -> int:
        for n in self.chain:
            mb = getattr(n, "min_bucket", None)
            if mb:
                return mb
        return 1024

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        from ..memory.retry import (split_device_rows, with_retry_split,
                                    wrap_dispatch, wrap_dispatch_donating)
        from .fallback import with_host_fallback
        from .transitions import take_exclusive
        fns = [n.batch_fn() for n in self.chain]

        def chain(b):
            # a donated batch leaves its box here, so this frame holds its
            # only reference: each step's input dies when the next begins
            table = b.take() if isinstance(b, _Donated) else b
            del b
            for f in fns:
                table = f(table)
            return table
        fused = wrap_dispatch(chain, context=self.node_name())
        donating = wrap_dispatch_donating(chain, context=self.node_name())

        def dispatch(b):
            if isinstance(b, _Donated):
                return donating(b)
            return fused(b)

        def splitter(b):
            return split_device_rows(b.take() if isinstance(b, _Donated)
                                     else b)

        # the degradation boundary: the ladder escalates inside it (spill,
        # retry, split: the chain is row-wise, and split halves dispatch
        # undonated); a terminal failure, or a classified non-retryable
        # device error, reruns the batch through the host chain
        run = with_host_fallback(
            self,
            lambda b: with_retry_split(dispatch, b, splitter=splitter,
                                       scope="wholestage",
                                       context=self.node_name()),
            self.host_batch_fn(), self._min_bucket())
        for batch in self.source.execute_columnar(pidx):
            if self.donate_inputs and take_exclusive(batch):
                # bytes before the call: the planes go as they are consumed
                self.metrics[DONATED_BYTES] += batch.nbytes()
                batch = _Donated(batch)
            out = run(batch)
            del batch
            self.account_batch()
            yield out


def fuse_stages(plan, donate: bool = False):
    """Bottom-up pass replacing maximal fusible chains with TpuWholeStageExec.

    A node joins a chain when it is a fusible TpuExec with exactly one
    child. Chains of length 1 are left alone. ``donate`` (donation_active)
    lets the fused stages donate their exclusively owned inputs.
    """
    from ..plan.meta import replace_children

    def rebuild(node):
        node = replace_children(node, [rebuild(c) for c in node.children])
        if _fusible(node):
            chain = [node]
            cur = node.children[0]
            while _fusible(cur):
                chain.insert(0, cur)
                cur = cur.children[0]
            if len(chain) > 1:
                return TpuWholeStageExec(chain, donate_inputs=donate)
        return node

    return rebuild(plan)


def _fusible(node) -> bool:
    return isinstance(node, TpuExec) and len(node.children) == 1 \
        and node.fusible
