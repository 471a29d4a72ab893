"""Device-side hashing of the shuffle layer — the port of ``_fmix_device``,
``_string_key_hash``, ``_column_key_hash`` and ``device_partition_ids``
from ``spark_rapids_tpu/shuffle/manager.py``, bit for bit. The grace join
buckets its rows by these ids; the shuffle write path that also orders rows
by them (``_partition_order``) waits for ROADMAP Queue 1: multi-GPU.

Torch has no unsigned 32-bit shifts or remainders, so a uint32 value rides
an int64 tensor in ``[0, 2**32)``: shifts are then logical, every product
is taken modulo ``2**32`` by ``mul32`` without overflowing int64, and the
remainder by the partition count is taken on that non-negative int64.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.device import DeviceColumn, DeviceTable, pack_string_key_words
from ..conf import STEP_BREADTH, not_ported

__all__ = ["MASK32", "fmix_device", "mul32", "string_key_hash",
           "column_key_hash", "device_partition_ids"]

MASK32 = 0xFFFFFFFF
_MURMUR_C1 = 0x85EBCA6B
_MURMUR_C2 = 0xC2B2AE35
_COMBINE_ADD = 0xE6546B64
#: the JAX package's uint64 limb-fold constant 0x9E3779B97F4A7C15, as the
#: int64 with the same bits (the product modulo 2**64 is the same)
_LIMB_FOLD = 0x9E3779B97F4A7C15 - 2**64


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


def _fold64(bits: torch.Tensor) -> torch.Tensor:
    """The uint64 bit pattern in int64 ``bits`` -> ``lo ^ hi`` of its
    32-bit halves (the arithmetic shift's sign bits are masked off)."""
    return (bits & MASK32) ^ ((bits >> 32) & MASK32)


def string_key_hash(col: DeviceColumn) -> torch.Tensor:
    """``_string_key_hash``: a width-independent hash of a string column.
    Each 8-byte word (big-endian, the matrix's zero padding included) folds
    to 32 bits, is mixed with its word number, and counts only where the
    row's length reaches into it; the length's own mix comes last. So the
    same value hashes alike in batches of any matrix width."""
    words = pack_string_key_words(col.data, col.lengths)[:-1]
    k = torch.zeros(col.capacity, dtype=torch.int64, device=col.data.device)
    for i, word in enumerate(words):
        start = 8 * i
        kw = fmix_device(_fold64(word) ^ (start + 1))
        k = k ^ torch.where(col.lengths > start, kw, 0)
    return k ^ fmix_device(col.lengths)


def column_key_hash(col: DeviceColumn) -> torch.Tensor:
    """``_column_key_hash``: a per-row uint32 hash (in int64) of one key
    column, mixed once more by the finaliser (a string's too); a null row
    hashes to 0. A float hashes its float64 bits as they are: -0.0 and
    0.0, or two NaN payloads, hash apart. A wide decimal (a 2-D plane
    without lengths) folds its limbs: ``hi ^ lo * 0x9E3779B97F4A7C15``
    modulo 2**64 (int64 products wrap to the same bits)."""
    v = col.data
    if col.lengths is not None:
        k = string_key_hash(col)
    elif v.dim() == 2 and v.shape[1] == 2 and v.dtype == torch.int64:
        k = _fold64(v[:, 0] ^ (v[:, 1] * _LIMB_FOLD))
    elif v.dim() != 1:
        raise NotImplementedError(
            f"a key column of {col.dtype!r} (a nested type) has no partition "
            f"id yet {not_ported(STEP_BREADTH)}")
    elif v.dtype.is_floating_point:
        k = _fold64(v.to(torch.float64).view(torch.int64))
    else:  # integers, dates and bools widen to int64
        k = _fold64(v.to(torch.int64))
    return torch.where(col.validity, fmix_device(k), 0)


def device_partition_ids(table: DeviceTable, key_names: Sequence[str],
                         num_parts: int, seed: int = 42) -> torch.Tensor:
    """Per-row partition ids in ``[0, num_parts)``, int32, bit-equal to the
    JAX package's ``device_partition_ids``: the keys' hashes combined in
    order by ``h = (h ^ k) * 5 + 0xE6546B64 mod 2**32`` from ``seed``."""
    h = torch.full((table.capacity,), seed & MASK32, dtype=torch.int64,
                   device=table.device)
    for name in key_names:
        h = h ^ column_key_hash(table.column(name))
        h = (mul32(h, 5) + _COMBINE_ADD) & MASK32
    # h is a non-negative int64 < 2**32, so torch's % is the uint32 one
    return (h % num_parts).to(torch.int32)
