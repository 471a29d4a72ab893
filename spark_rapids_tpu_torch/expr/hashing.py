"""Hash and id expressions — the port of ``spark_rapids_tpu/expr/hashing.py``
(reference: HashFunctions.scala): Spark's ``hash`` (Murmur3, seed 42) and
``xxhash64`` (seed 42), each folded across its columns, a null leaving the
running hash as it was; ``spark_partition_id``, ``monotonically_increasing_id``
and the sample's row predicate (``SampleMask``).

On the device both hashes are one ``row_hash`` kernel launch over every
column (``csrc/strings_cast.cu``); its plain version, ``row_hash_reference``,
computes Spark's uint32 and uint64 arithmetic in int64 (products and sums
wrap alike; a right shift is an arithmetic shift with the sign-extended bits
masked off, as torch has no shift on unsigned integers), and is what a CPU
tensor gets. The host engine computes in numpy's unsigned types, as the JAX
package does. Floats hash with -0.0 as 0.0 and every NaN as the canonical
NaN; a string hashes its bytes (Murmur3's tail bytes sign-extended, as
Java's byte is). A decimal past 18 digits hashes, on the host engine, the
bytes of its unscaled value's two's complement (Java's
``BigInteger.toByteArray``), as Spark does; the JAX package casts the value
to int64 (which raises past 2^63) and the plan keeps it off the device.
``rand`` is not ported: its device path draws from ``jax.random``, whose
bits the port cannot reproduce.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..native import launch
from .base import EvalCol, EvalContext, Expression

__all__ = ["Murmur3Hash", "XxHash64", "SparkPartitionID",
           "MonotonicallyIncreasingID", "SampleMask", "splitmix64_uniform",
           "row_hash", "row_hash_reference", "ROW_HASH_MAX_COLS"]

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



# ---------------------------------------------------------------------------
# Murmur3 and XxHash64 in int64 (the plain version of row_hash)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_XXP1 = 0x9E3779B185EBCA87
_XXP2 = 0xC2B2AE3D27D4EB4F
_XXP3 = 0x165667B19E3779F9
_XXP4 = 0x85EBCA77C2B2AE63
_XXP5 = 0x27D4EB2F165667C5


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    return (_rotl32((k1 * _C1) & _M32, 15) * _C2) & _M32


def _mix_h1(h1, k1):
    return (_rotl32(h1 ^ k1, 13) * 5 + 0xE6546B64) & _M32


def _fmix32(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _mm_int(k, seed):
    return _fmix32(_mix_h1(seed, _mix_k1(k)), 4)


def _mm_long(v, seed):
    h1 = _mix_h1(seed, _mix_k1(v & _M32))
    h1 = _mix_h1(h1, _mix_k1(_lsr(v, 32)))
    return _fmix32(h1, 8)


def _rotl64(x, r):
    return (x << r) | _lsr(x, 64 - r)


def _xx_fmix(h):
    h = h ^ _lsr(h, 33)
    h = h * _signed(_XXP2)
    h = h ^ _lsr(h, 29)
    h = h * _signed(_XXP3)
    return h ^ _lsr(h, 32)


def _xx_int(v, seed):
    """XXH64.hashInt: v a uint32 (in int64), zero-extended."""
    h = seed + _signed(_XXP5 + 4)
    h = h ^ (v * _signed(_XXP1))
    h = _rotl64(h, 23) * _signed(_XXP2) + _signed(_XXP3)
    return _xx_fmix(h)


def _xx_long(v, seed):
    h = seed + _signed(_XXP5 + 8)
    h = h ^ (_rotl64(v * _signed(_XXP2), 31) * _signed(_XXP1))
    h = _rotl64(h, 27) * _signed(_XXP1) + _signed(_XXP4)
    return _xx_fmix(h)


def _fixed_bits(c: EvalCol):
    """(bits as int64, wide): a fixed-width column's hashed bits, floats
    normalised; wide values hash as longs."""
    v = c.values
    d = c.dtype
    if isinstance(d, dt.BooleanType):
        return v.to(torch.int64), False
    if isinstance(d, dt.FloatType):
        f = v.to(torch.float32)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        return f.view(torch.int32).to(torch.int64) & _M32, False
    if isinstance(d, dt.DoubleType):
        f = v.to(torch.float64)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        return f.view(torch.int64), True
    if isinstance(d, (dt.LongType, dt.TimestampType, dt.DecimalType)):
        if v.dim() != 1:
            raise TypeError(f"a hash of {d!r} (a wide decimal) runs on the "
                            "host engine")
        return v.to(torch.int64), True
    if isinstance(d, (dt.ByteType, dt.ShortType, dt.IntegerType,
                      dt.DateType)):
        return v.to(torch.int64) & _M32, False
    raise TypeError(f"hash of {d!r} not supported")


def _mm_string(data, lengths, seed):
    n, w = data.shape
    lengths = lengths.to(torch.int64)
    aligned = lengths - lengths % 4
    b = data.to(torch.int64)
    h1 = seed
    for off in range(0, w - w % 4, 4):
        k = b[:, off] | (b[:, off + 1] << 8) | (b[:, off + 2] << 16) \
            | (b[:, off + 3] << 24)
        h1 = torch.where(off + 4 <= aligned, _mix_h1(h1, _mix_k1(k)), h1)
    sext = torch.where(b >= 128, b | 0xFFFFFF00, b)
    for j in range(w):
        use = (j >= aligned) & (j < lengths)
        h1 = torch.where(use, _mix_h1(h1, _mix_k1(sext[:, j])), h1)
    return _fmix32(h1, lengths)


def _xx_string(data, lengths, seed):
    """XXH64.hashUnsafeBytes over the matrix, every phase masked per row
    (the JAX package's ``_xx_bytes_device``)."""
    n, w = data.shape
    ln = lengths.to(torch.int64)
    nwords = max(1, (w + 7) // 8)
    padded = torch.zeros((n, nwords * 8), dtype=torch.int64,
                         device=data.device)
    padded[:, :w] = data.to(torch.int64)
    words = torch.zeros((n, nwords), dtype=torch.int64, device=data.device)
    for byte in range(8):
        words = words | (padded[:, byte::8] << (8 * byte))
    nstripes = ln // 32
    p1, p2 = _signed(_XXP1), _signed(_XXP2)
    v = [seed + _signed(_XXP1 + _XXP2), seed + p2, seed, seed - p1]
    for t in range((nwords + 3) // 4):
        active = t < nstripes
        for lane in range(4):
            wi = 4 * t + lane
            k = words[:, wi] if wi < nwords else torch.zeros_like(seed)
            upd = _rotl64(v[lane] + k * p2, 31) * p1
            v[lane] = torch.where(active, upd, v[lane])
    merged = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) \
        + _rotl64(v[3], 18)
    for x in v:
        merged = merged ^ (_rotl64(x * p2, 31) * p1)
        merged = merged * p1 + _signed(_XXP4)
    h = torch.where(ln >= 32, merged, seed + _signed(_XXP5)) + ln
    base_word = 4 * nstripes
    for j in range(nwords):
        active = (j >= base_word) & (8 * j + 8 <= ln)
        upd = h ^ (_rotl64(words[:, j] * p2, 31) * p1)
        upd = _rotl64(upd, 27) * p1 + _signed(_XXP4)
        h = torch.where(active, upd, h)
    has4 = (ln % 8) >= 4
    jj = (ln // 8).clamp(0, nwords - 1)
    k32 = torch.gather(words, 1, jj[:, None])[:, 0] & _M32
    upd = _rotl64(h ^ (k32 * p1), 23) * p2 + _signed(_XXP3)
    h = torch.where(has4, upd, h)
    tail = 8 * (ln // 8) + torch.where(has4, 4, 0)
    for t in range(3):
        pos = tail + t
        byte = torch.gather(data.to(torch.int64), 1,
                            pos.clamp(0, w - 1)[:, None])[:, 0]
        upd = _rotl64(h ^ (byte * _signed(_XXP5)), 11) * p1
        h = torch.where(pos < ln, upd, h)
    return _xx_fmix(h)


def row_hash_reference(cols: Sequence[EvalCol], n: int, xx: bool,
                       seed: int = 42, device=None) -> torch.Tensor:
    """Spark's Murmur3 (int32) or, with ``xx``, XxHash64 (int64) of each
    row, folded across ``cols`` from ``seed``: the plain version of
    ``row_hash``."""
    if device is None:
        device = cols[0].values.device if cols else torch.device("cpu")
    h = torch.full((n,), _signed(seed) if xx else seed & _M32,
                   dtype=torch.int64, device=device)
    for c in cols:
        if c.lengths is not None:
            data = c.values.expand(n, -1) if c.values.shape[0] != n \
                else c.values
            nh = _xx_string(data, c.lengths, h) if xx \
                else _mm_string(data, c.lengths, h)
        else:
            bits, wide = _fixed_bits(c)
            if xx:
                nh = _xx_long(bits, h) if wide else _xx_int(bits, h)
            else:
                nh = _mm_long(bits, h) if wide else _mm_int(bits, h)
        if c.validity is not None:
            nh = torch.where(c.validity, nh, h)
        h = nh
    return h if xx else (h & _M32).to(torch.int32)


class _HashCol(ctypes.Structure):
    """``SrtHashCol`` of csrc/strings_cast.cu."""
    _fields_ = [("kind", ctypes.c_int32), ("width", ctypes.c_int32),
                ("stride", ctypes.c_int64), ("data", ctypes.c_void_p),
                ("valid", ctypes.c_void_p), ("lengths", ctypes.c_void_p)]


#: the kernel's column kinds by value-plane dtype
_HASH_KIND = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
              torch.int64: 4, torch.float32: 5, torch.float64: 6}
_HASH_STRING = 7
#: columns one launch folds (csrc/strings_cast.cu kMaxHashCols)
ROW_HASH_MAX_COLS = 16


def _hash_col(c: EvalCol, keep: List[torch.Tensor]) -> _HashCol:
    valid = None
    if c.validity is not None:
        valid = c.validity.contiguous()
        keep.append(valid)
    vptr = None if valid is None else valid.data_ptr()
    v = c.values
    if c.lengths is not None:
        if v.stride(1) != 1:
            v = v.contiguous()
        lengths = c.lengths.to(torch.int32).contiguous()
        keep += [v, lengths]
        return _HashCol(_HASH_STRING, v.shape[1], v.stride(0), v.data_ptr(),
                        vptr, lengths.data_ptr())
    if isinstance(c.dtype, (dt.FloatType, dt.DoubleType)):
        v = v.to(torch.float32 if isinstance(c.dtype, dt.FloatType)
                 else torch.float64)
    elif isinstance(c.dtype, (dt.LongType, dt.TimestampType,
                              dt.DecimalType)):
        v = v.to(torch.int64)
    if v.dim() != 1 or v.dtype not in _HASH_KIND:
        raise TypeError(f"row_hash: a column of {c.dtype!r} has no kernel "
                        "kind (a wide decimal hashes on the host engine)")
    v = v.contiguous()
    keep.append(v)
    return _HashCol(_HASH_KIND[v.dtype], 0, 0, v.data_ptr(), vptr, None)


def row_hash(cols: Sequence[EvalCol], n: int, xx: bool, seed: int = 42,
             device=None) -> torch.Tensor:
    """Spark's Murmur3 (int32) or XxHash64 (int64) of each of ``n`` rows,
    folded across ``cols``: the plain version on the CPU, else one launch
    of the ``row_hash`` kernel."""
    if device is None:
        device = cols[0].values.device if cols else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cpu":
        return row_hash_reference(cols, n, xx, seed, device)
    if len(cols) > ROW_HASH_MAX_COLS:
        raise NotImplementedError(
            f"row_hash: {len(cols)} columns; one launch folds at most "
            f"{ROW_HASH_MAX_COLS}")
    keep: List[torch.Tensor] = []
    descs = (_HashCol * max(len(cols), 1))(*[_hash_col(c, keep)
                                             for c in cols])
    out = torch.empty(n, dtype=torch.int64 if xx else torch.int32,
                      device=device)
    if n:
        launch(row_hash, "srt_row_hash", device, descs, len(cols), n,
               int(xx), seed & _U64, out.data_ptr())
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
row_hash.launches = 0


# ---------------------------------------------------------------------------
# the host engine: numpy's unsigned arithmetic, as the JAX package computes
# ---------------------------------------------------------------------------
def _np_rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_mix_k1(k1):
    return _np_rotl32(k1 * np.uint32(_C1), 15) * np.uint32(_C2)


def _np_mix_h1(h1, k1):
    return _np_rotl32(h1 ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)


def _np_fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = h1 * np.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = h1 * np.uint32(0xC2B2AE35)
    return h1 ^ (h1 >> np.uint32(16))


def _np_mm_int(k, seed):
    return _np_fmix(_np_mix_h1(seed, _np_mix_k1(k)), np.uint32(4))


def _np_mm_long(v, seed):
    low = (v & np.uint64(_M32)).astype(np.uint32)
    high = (v >> np.uint64(32)).astype(np.uint32)
    h1 = _np_mix_h1(seed, _np_mix_k1(low))
    h1 = _np_mix_h1(h1, _np_mix_k1(high))
    return _np_fmix(h1, np.uint32(8))


def _np_rotl64(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _np_xx_fmix(h):
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(_XXP2)
    h = h ^ (h >> np.uint64(29))
    h = h * np.uint64(_XXP3)
    return h ^ (h >> np.uint64(32))


def _np_xx_long(v, seed):
    h = seed + np.uint64(_XXP5) + np.uint64(8)
    h = h ^ (_np_rotl64(v * np.uint64(_XXP2), 31) * np.uint64(_XXP1))
    h = _np_rotl64(h, 27) * np.uint64(_XXP1) + np.uint64(_XXP4)
    return _np_xx_fmix(h)


def _np_xx_int(v, seed):
    h = seed + np.uint64(_XXP5) + np.uint64(4)
    h = h ^ (v.astype(np.uint64) * np.uint64(_XXP1))
    h = _np_rotl64(h, 23) * np.uint64(_XXP2) + np.uint64(_XXP3)
    return _np_xx_fmix(h)


def _np_normalize(vals):
    vals = np.where(vals == 0.0, np.zeros_like(vals), vals)
    return np.where(vals != vals, np.full_like(vals, np.nan), vals)


def _np_matrix(rows: list) -> tuple:
    """Byte rows -> (uint8 (n, w) zero-padded, int64 lengths)."""
    lens = np.fromiter((len(b) for b in rows), np.int64, len(rows))
    w = max(int(lens.max()) if len(rows) else 0, 1)
    mat = np.array(rows, dtype=f"S{w}").view(np.uint8).reshape(len(rows), w)
    return mat, lens


def _np_mm_strings(mat: np.ndarray, lens: np.ndarray,
                   h1: np.ndarray) -> np.ndarray:
    """Murmur3_x86_32.hashUnsafeBytes (Spark's) of every row at once: the
    4-byte blocks, then the tail bytes sign-extended."""
    n, w = mat.shape
    aligned = lens - lens % 4
    b = mat.astype(np.uint32)
    for off in range(0, w - w % 4, 4):
        k = b[:, off] | (b[:, off + 1] << np.uint32(8)) \
            | (b[:, off + 2] << np.uint32(16)) \
            | (b[:, off + 3] << np.uint32(24))
        h1 = np.where(off + 4 <= aligned, _np_mix_h1(h1, _np_mix_k1(k)), h1)
    sext = np.where(b >= 128, b | np.uint32(0xFFFFFF00), b)
    for j in range(w):
        use = (j >= aligned) & (j < lens)
        h1 = np.where(use, _np_mix_h1(h1, _np_mix_k1(sext[:, j])), h1)
    return _np_fmix(h1, lens.astype(np.uint32))


def _np_xx_strings(mat: np.ndarray, lens: np.ndarray,
                   seed: np.ndarray) -> np.ndarray:
    """XXH64.hashUnsafeBytes (Spark's) of every row at once: 32-byte
    stripes, 8-byte words, a 4-byte word, the tail bytes."""
    u = np.uint64
    n, w = mat.shape
    nwords = (w + 7) // 8
    padded = np.zeros((n, nwords * 8), np.uint8)
    padded[:, :w] = mat
    words = padded.view("<u8").reshape(n, nwords).astype(np.uint64)
    ln = lens.astype(np.uint64)
    nstripes = ln // u(32)
    v = [seed + u(_XXP1) + u(_XXP2), seed + u(_XXP2), seed.copy(),
         seed - u(_XXP1)]
    for t in range((nwords + 3) // 4):
        active = nstripes > u(t)
        for lane in range(4):
            wi = 4 * t + lane
            k = words[:, wi] if wi < nwords else np.zeros(n, np.uint64)
            upd = _np_rotl64(v[lane] + k * u(_XXP2), 31) * u(_XXP1)
            v[lane] = np.where(active, upd, v[lane])
    merged = _np_rotl64(v[0], 1) + _np_rotl64(v[1], 7) \
        + _np_rotl64(v[2], 12) + _np_rotl64(v[3], 18)
    for x in v:
        merged = merged ^ (_np_rotl64(x * u(_XXP2), 31) * u(_XXP1))
        merged = merged * u(_XXP1) + u(_XXP4)
    h = np.where(ln >= u(32), merged, seed + u(_XXP5)) + ln
    base_word = u(4) * nstripes
    for j in range(nwords):
        active = (u(j) >= base_word) & (u(8 * j + 8) <= ln)
        upd = h ^ (_np_rotl64(words[:, j] * u(_XXP2), 31) * u(_XXP1))
        upd = _np_rotl64(upd, 27) * u(_XXP1) + u(_XXP4)
        h = np.where(active, upd, h)
    has4 = (ln % u(8)) >= u(4)
    jj = np.minimum(ln // u(8), u(nwords - 1)).astype(np.int64)
    k32 = words[np.arange(n), jj] & u(_M32)
    upd = _np_rotl64(h ^ (k32 * u(_XXP1)), 23) * u(_XXP2) + u(_XXP3)
    h = np.where(has4, upd, h)
    tail = u(8) * (ln // u(8)) + np.where(has4, u(4), u(0))
    for t in range(3):
        pos = tail + u(t)
        byte = mat[np.arange(n), np.minimum(pos, u(w - 1)).astype(np.int64)]
        upd = _np_rotl64(h ^ (byte.astype(np.uint64) * u(_XXP5)), 11) \
            * u(_XXP1)
        h = np.where(pos < ln, upd, h)
    return _np_xx_fmix(h)


def _big_int_bytes(v: int) -> bytes:
    """Java's ``BigInteger.toByteArray``: the minimal two's complement,
    big-endian."""
    nbytes = (v if v >= 0 else ~v).bit_length() // 8 + 1
    return v.to_bytes(nbytes, "big", signed=True)


def _host_hash(c: EvalCol, h: np.ndarray, xx: bool) -> np.ndarray:
    """One column folded into the running hashes ``h`` on the host engine."""
    d = c.dtype
    v = c.values
    if isinstance(d, (dt.StringType, dt.BinaryType)) or dt.is_d128(d):
        if isinstance(d, (dt.StringType, dt.BinaryType)):
            rows = [s.encode() if isinstance(s, str) else bytes(s)
                    for s in v]
        else:
            rows = [_big_int_bytes(int(x)) for x in v]
        mat, lens = _np_matrix(rows)
        with np.errstate(over="ignore"):
            return _np_xx_strings(mat, lens, h) if xx \
                else _np_mm_strings(mat, lens, h)
    if isinstance(d, dt.BooleanType):
        bits, wide = v.astype(np.uint32), False
    elif isinstance(d, dt.FloatType):
        bits = _np_normalize(v.astype(np.float32)).view(np.uint32)
        wide = False
    elif isinstance(d, dt.DoubleType):
        bits = _np_normalize(v.astype(np.float64)).view(np.uint64)
        wide = True
    elif isinstance(d, (dt.LongType, dt.TimestampType, dt.DecimalType)):
        bits, wide = v.astype(np.int64).view(np.uint64), True
    elif isinstance(d, (dt.ByteType, dt.ShortType, dt.IntegerType,
                        dt.DateType)):
        bits, wide = v.astype(np.int32).view(np.uint32), False
    else:
        raise TypeError(f"hash of {d!r} not supported")
    with np.errstate(over="ignore"):
        if xx:
            return _np_xx_long(bits, h) if wide else _np_xx_int(bits, h)
        return _np_mm_long(bits, h) if wide else _np_mm_int(bits, h)


class _RowHash(Expression):
    """The fold of one hash across the children, from ``seed``."""

    xx = False

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed

    def with_children(self, children):
        return type(self)(*children, seed=self.seed)

    @property
    def data_type(self):
        return dt.LONG if self.xx else dt.INT

    @property
    def nullable(self):
        return False

    def runs_kernel(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> EvalCol:
        cols = [c.eval(ctx) for c in self.children]
        n = ctx.num_rows
        if ctx.is_device:
            return EvalCol(row_hash(cols, n, self.xx, self.seed,
                                    ctx.xp.device), None, self.data_type)
        if self.xx:
            h = np.full(n, self.seed & _U64, dtype=np.uint64)
        else:
            h = np.full(n, self.seed & _M32, dtype=np.uint32)
        for c in cols:
            nh = _host_hash(c, h, self.xx)
            h = np.where(c.valid_mask(ctx), nh, h)
        return EvalCol(h.view(np.int64 if self.xx else np.int32), None,
                       self.data_type)


class Murmur3Hash(_RowHash):
    """hash(...) — Spark's Murmur3, folding seed 42 across the columns."""


class XxHash64(_RowHash):
    """xxhash64(...) — Spark's XxHash64, seed 42, folding across columns."""

    xx = True


class SparkPartitionID(Expression):
    """spark_partition_id() (reference: GpuSparkPartitionID.scala)."""

    context_dependent = True

    def __init__(self):
        self.children = ()

    def with_children(self, children):
        return self

    @property
    def data_type(self):
        return dt.INT

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> EvalCol:
        xp = ctx.xp
        return EvalCol(xp.full((ctx.num_rows,), ctx.partition_id, xp.int32),
                       None, dt.INT)


class MonotonicallyIncreasingID(Expression):
    """monotonically_increasing_id(): (partition_id << 33) + row offset
    (reference: GpuMonotonicallyIncreasingID.scala)."""

    context_dependent = True

    def __init__(self):
        self.children = ()

    def with_children(self, children):
        return self

    @property
    def data_type(self):
        return dt.LONG

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> EvalCol:
        base = int(ctx.partition_id) << 33
        if ctx.is_device:
            offs = torch.arange(ctx.num_rows, dtype=torch.int64,
                                device=ctx.xp.device) + ctx.batch_row_offset
        else:
            offs = np.arange(ctx.num_rows, dtype=np.int64) \
                + ctx.batch_row_offset
        return EvalCol(offs + base, None, dt.LONG)
