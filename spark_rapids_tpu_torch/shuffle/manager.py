"""Device-side hashing of the shuffle layer — the port of ``_fmix_device``
from ``spark_rapids_tpu/shuffle/manager.py``. Device partition ids wait for
ROADMAP Queue 1: the grace join and the spill catalog.

Torch has no unsigned 32-bit shifts or remainders, so a uint32 value rides
an int64 tensor in ``[0, 2**32)``: shifts are then logical, and every
product is taken modulo ``2**32`` by ``mul32`` without overflowing int64.
"""
from __future__ import annotations

import torch

__all__ = ["MASK32", "fmix_device", "mul32"]

MASK32 = 0xFFFFFFFF
_MURMUR_C1 = 0x85EBCA6B
_MURMUR_C2 = 0xC2B2AE35


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a constant
    ``c`` in ``[0, 2**32)``: split ``c`` into 16-bit halves so that no
    partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 0x10000) & MASK32


def fmix_device(x: torch.Tensor) -> torch.Tensor:
    """Murmur3's 32-bit finaliser, bit for bit the JAX package's
    ``_fmix_device``. ``x`` is any integer tensor; its low 32 bits are the
    uint32 input (so int32 values with the top bit set work as they do
    after ``astype(uint32)``). Returns int64 in ``[0, 2**32)``."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, _MURMUR_C1)
    x = x ^ (x >> 13)
    x = mul32(x, _MURMUR_C2)
    return x ^ (x >> 16)
