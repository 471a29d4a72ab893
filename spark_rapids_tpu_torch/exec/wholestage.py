"""Whole-stage fusion — the port of ``spark_rapids_tpu/exec/wholestage.py``.

Adjacent fusible device operators are composed into one node. PyTorch runs
eagerly, so the node composes the chain's per-batch functions and runs them
back to back on each batch (the JAX package compiles the same composition
into one XLA program). The plan shape and ``explain`` stay those of the JAX
package: ``TpuWholeStage[Filter+Project+HashAggregate]``.
"""
from __future__ import annotations

from typing import Iterator, List

from ..columnar.device import DeviceTable
from .base import TpuExec

__all__ = ["TpuWholeStageExec", "fuse_stages"]


class TpuWholeStageExec(TpuExec):
    """Wraps a linear chain of fusible TpuExecs [bottom, ..., top]."""

    def __init__(self, chain: List[TpuExec]):
        super().__init__()
        if not chain:
            raise ValueError("empty fusion chain")
        # flatten nested whole-stages: the bottom-up pass wraps inner chains
        # before outer fusible parents are seen
        self.chain = [m for n in chain
                      for m in (n.chain if isinstance(n, TpuWholeStageExec)
                                else [n])]
        # the producer feeding the chain (transition or non-fused exec)
        self.source = self.chain[0].children[0]
        self.children = (self.source,)
        self.schema = self.chain[-1].schema

    @property
    def num_partitions(self) -> int:
        return self.source.num_partitions

    def node_name(self):
        inner = "+".join(type(n).__name__.replace("Tpu", "").replace("Exec", "")
                         for n in self.chain)
        return f"TpuWholeStage[{inner}]"

    def batch_fn(self):
        """The composed chain function."""
        fns = [n.batch_fn() for n in self.chain]

        def run(table: DeviceTable) -> DeviceTable:
            for f in fns:
                table = f(table)
            return table
        return run

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        run = self.batch_fn()
        for batch in self.source.execute_columnar(pidx):
            out = run(batch)
            self.account_batch()
            yield out


def fuse_stages(plan):
    """Bottom-up pass replacing maximal fusible chains with TpuWholeStageExec.

    A node joins a chain when it is a fusible TpuExec with exactly one
    child. Chains of length 1 are left alone.
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
                return TpuWholeStageExec(chain)
        return node

    return rebuild(plan)


def _fusible(node) -> bool:
    return isinstance(node, TpuExec) and len(node.children) == 1 \
        and node.fusible
