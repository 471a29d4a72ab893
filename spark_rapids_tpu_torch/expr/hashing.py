"""Position hashing — the port of ``SampleMask`` from
``spark_rapids_tpu/expr/hashing.py`` (the sample's row predicate). The rest
of that module (hash, xxhash64, rand, the partition id and the
monotonically increasing id) waits for ROADMAP Queue 1: breadth.

The JAX package computes splitmix64 in uint64. Torch has no shift on
uint64, so the device path keeps the same bits in int64: additions and
multiplications wrap identically in two's complement, and a right shift is
an arithmetic shift with the sign-extended bits masked off (a logical
shift). The host engine computes in numpy's uint64, as the JAX package
does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtypes as dt
from .base import EvalCol, EvalContext, Expression

__all__ = ["SampleMask", "splitmix64_uniform"]

_U64 = 0xFFFFFFFFFFFFFFFF
_SEED_MUL = 0x632BE59BD9B4E019
_PART_MUL = 0x9E3779B97F4A7C15
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _signed(c: int) -> int:
    """A 64-bit pattern as the int64 holding the same bits."""
    c &= _U64
    return c - (1 << 64) if c >> 63 else c


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _base(seed: int, partition_id: int) -> int:
    return (seed * _SEED_MUL + partition_id * _PART_MUL) & _U64


def splitmix64_uniform(pos, seed: int, partition_id: int):
    """The uniform in [0, 1) that splitmix64 of (seed, partition, row
    position) gives each position: ``pos`` an int64 tensor (torch, int64
    arithmetic) or array (numpy, uint64 arithmetic)."""
    if isinstance(pos, torch.Tensor):
        x = pos + _signed(_base(seed, partition_id))
        z = x + _signed(_GOLDEN)
        z = (z ^ _lsr(z, 30)) * _signed(_MIX1)
        z = (z ^ _lsr(z, 27)) * _signed(_MIX2)
        z = z ^ _lsr(z, 31)
        return _lsr(z, 11).to(torch.float64) * (2.0 ** -53)
    x = np.asarray(pos, dtype=np.int64).astype(np.uint64) \
        + np.uint64(_base(seed, partition_id))
    z = x + np.uint64(_GOLDEN)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_MIX1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_MIX2)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


class SampleMask(Expression):
    """Deterministic Bernoulli-sample predicate: keep a row iff
    splitmix64(seed, partition, absolute row position) maps below
    ``fraction``. The device path and the host engine make the same
    decision for every row, and so does the JAX package."""

    context_dependent = True

    def __init__(self, fraction: float, seed: int):
        assert 0.0 <= fraction <= 1.0, fraction
        self.fraction = float(fraction)
        self.seed = int(seed)
        self.children = ()

    def with_children(self, children):
        return self

    def __repr__(self):
        return f"SampleMask({self.fraction}, seed={self.seed})"

    @property
    def data_type(self):
        return dt.BOOLEAN

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> EvalCol:
        if ctx.is_device:
            pos = torch.arange(ctx.num_rows, dtype=torch.int64,
                               device=ctx.xp.device) + ctx.batch_row_offset
        else:
            pos = np.arange(ctx.num_rows, dtype=np.int64) \
                + ctx.batch_row_offset
        u = splitmix64_uniform(pos, self.seed, ctx.partition_id)
        return EvalCol(u < self.fraction, None, dt.BOOLEAN)
