"""Exact 128-bit decimal arithmetic on int64 planes — the port of
``spark_rapids_tpu/expr/decimal128.py`` (reference: the DECIMAL_128 tier,
decimalExpressions.scala, DecimalUtil.scala, GpuCast.scala:1513).

Storage: a DECIMAL(p>18) device column holds ``(capacity, 2)`` int64 limbs
``[hi, lo]``, the value being ``hi * 2**64 + uint64(lo)`` (128-bit two's
complement). Results are checked against ``10**precision`` and nulled on
overflow (Spark's non-ANSI CheckOverflow).

Every function of the JAX module is here as plain torch code on int64 digit
planes, function by function: four (or eight) little-endian 32-bit digits
in int64 lanes, schoolbook products, long division by powers of ten in
steps of at most 10^9, exact HALF_UP rounding. Torch has no uint64
arithmetic or order, so the JAX package's uint64 words (``_biased_hi``,
``d128_key_words``) are int64 tensors holding the same bits, and an
unsigned compare flips the sign bit first (as ``exec/sort.py`` does for
string words). ``>>`` on int64 is arithmetic, which the carry
normalisation needs for borrows.

Three of them are the plain versions of hand-written kernels
(``csrc/decimal128.cu``), one thread a row with 64-bit limbs:

- ``d128_mul_rescaled``: ``a * b`` (256 bits exact), divided by ``10**k``
  with HALF_UP rounding, checked against ``10**p``;
- ``d128_rescale``: a column times or over ``10**k`` (HALF_UP), checked;
- ``d128_segment_sum``: each group's exact sum and overflow flag (up to
  ``SEGMENT_SUM_SMALL_CAP`` groups in registers, more through atomics).

Their operands may be limbs or scaled int64 (the decimal64 tier), which the
kernels read as they are. A wrapper checks its inputs, then computes the
plain version for tensors on the CPU, or launches the kernel on the current
stream of a CUDA device and counts the launch in ``<wrapper>.launches``; a
failed launch raises. There is no fallback from the kernel to the plain
version. Where the result overflows, its limbs are the exact result modulo
2**128 in both, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..native import launch

__all__ = [
    "MAX_PRECISION", "limbs_from_py_ints", "limbs_to_py_ints",
    "d128_add", "d128_sub", "d128_neg", "d128_abs", "d128_sign",
    "d128_cmp", "d128_eq", "d128_lt", "d128_key_words",
    "d128_mul", "d128_rescale", "d128_rescale_reference",
    "d128_mul_rescaled", "d128_mul_rescaled_reference",
    "d128_from_i64", "d128_to_i64", "d128_trunc_low64", "d128_to_f64",
    "d128_from_f64",
    "d128_overflows", "d128_segment_sum", "d128_segment_sum_reference",
    "POW10_LIMBS", "MAX_MUL_SCALE_DROP", "SUM_OVERFLOW_MARK",
    "SEGMENT_SUM_SMALL_CAP",
]

MAX_PRECISION = 38
#: what an overflowed wide-decimal sum state holds under its null: 10^38,
#: beyond every valid state, so a final merge can tell an overflowed
#: partial from an empty one (exec/aggregate.py, plan/host_groupby.py)
SUM_OVERFLOW_MARK = 10 ** MAX_PRECISION
#: the widest scale drop of a product the kernel takes (two scales of 38)
MAX_MUL_SCALE_DROP = 76
#: the most groups the segment sum's small-cap path takes
#: (``csrc/decimal128.cu kSmallCap``)
SEGMENT_SUM_SMALL_CAP = 16
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_SIGN = -2**63


# ---------------------------------------------------------------------------
# host <-> device transfer helpers (numpy, upload/download path)
# ---------------------------------------------------------------------------
def limbs_from_py_ints(values, capacity: int) -> np.ndarray:
    """Scaled Python ints (an object array, a sequence with ``None`` for 0,
    or an int64 array) -> ``(capacity, 2)`` int64 limbs, each value taken
    modulo 2**128 as the JAX function takes it; rows past the values are
    0. Vectorised: the JAX package builds them a row at a time."""
    out = np.zeros((capacity, 2), dtype=np.int64)
    n = len(values)
    if not n:
        return out
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        v = values.astype(np.int64)
        out[:n, 1] = v
        out[:n, 0] = v >> 63
        return out
    obj = np.empty(n, dtype=object)
    obj[:] = list(values)
    obj = np.where(np.equal(obj, None), 0, obj)
    lo = (obj & _MASK64).astype(np.uint64)
    hi = ((obj >> 64) & _MASK64).astype(np.uint64)
    out[:n, 1] = lo.view(np.int64)
    out[:n, 0] = hi.view(np.int64)
    return out


def limbs_to_py_ints(limbs: np.ndarray) -> np.ndarray:
    """``(n, 2)`` int64 limbs -> object array of Python ints (the signed
    128-bit values)."""
    hi = np.asarray(limbs[:, 0], dtype=np.int64).astype(object)
    lo = np.asarray(limbs[:, 1], dtype=np.int64).view(np.uint64) \
        .astype(object)
    out = np.empty(len(hi), dtype=object)
    out[:] = hi * (1 << 64) + lo
    return out


# ---------------------------------------------------------------------------
# digit form: 4 (or 8) little-endian 32-bit digits in int64 lanes
# ---------------------------------------------------------------------------
def _to_digits(limbs: torch.Tensor) -> List[torch.Tensor]:
    """(n, 2) limbs -> [d0..d3], 32-bit digits of the raw two's complement
    bit pattern."""
    hi, lo = limbs[:, 0], limbs[:, 1]
    return [lo & _MASK32, (lo >> 32) & _MASK32,
            hi & _MASK32, (hi >> 32) & _MASK32]


def _from_digits(d: List[torch.Tensor]) -> torch.Tensor:
    """[d0..d3] (carry-normalised, 32 bits each) -> (n, 2) limbs."""
    lo = (d[0] & _MASK32) | ((d[1] & _MASK32) << 32)
    hi = (d[2] & _MASK32) | ((d[3] & _MASK32) << 32)
    return torch.stack([hi, lo], dim=1)


def _carry_normalize(d: List[torch.Tensor]) -> List[torch.Tensor]:
    """Propagate carries so every digit is in [0, 2^32), modulo 2^(32 *
    len(d)); digits may hold values up to ~2^63, and negative ones (the
    arithmetic shift carries a borrow)."""
    out = []
    carry = torch.zeros_like(d[0])
    for x in d:
        v = x + carry
        out.append(v & _MASK32)
        carry = v >> 32
    return out


# ---------------------------------------------------------------------------
# add / sub / neg / compare
# ---------------------------------------------------------------------------
def d128_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    da, db = _to_digits(a), _to_digits(b)
    return _from_digits(_carry_normalize([x + y for x, y in zip(da, db)]))


def d128_neg(a: torch.Tensor) -> torch.Tensor:
    d = [(~x) & _MASK32 for x in _to_digits(a)]
    d[0] = d[0] + 1
    return _from_digits(_carry_normalize(d))


def d128_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return d128_add(a, d128_neg(b))


def d128_sign(a: torch.Tensor) -> torch.Tensor:
    """-1 / 0 / +1 per row (int32)."""
    hi, lo = a[:, 0], a[:, 1]
    zero = torch.logical_and(hi == 0, lo == 0)
    return torch.where(zero, 0, torch.where(hi < 0, -1, 1)).to(torch.int32)


def d128_abs(a: torch.Tensor) -> torch.Tensor:
    return torch.where((a[:, 0] < 0)[:, None], d128_neg(a), a)


def _biased_hi(a: torch.Tensor) -> torch.Tensor:
    """The bits of the JAX package's biased hi word (the hi limb as uint64
    with its sign bit flipped), as int64."""
    return a[:, 0] ^ _SIGN


def d128_key_words(a: torch.Tensor) -> List[torch.Tensor]:
    """Most-significant-first words whose unsigned order is the signed
    128-bit order: the bits of the JAX package's uint64 key words, as
    int64. A caller that sorts by them flips the sign bit first (``w ^
    -2**63``); equality needs nothing."""
    return [_biased_hi(a), a[:, 1]]


def d128_cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-1 / 0 / +1 of (a - b) per row (signed 128-bit compare, int32): the
    hi limbs in signed order, then the lo limbs in unsigned order (sign
    bit flipped into torch's signed order)."""
    ah, bh = a[:, 0], b[:, 0]
    al, bl = a[:, 1] ^ _SIGN, b[:, 1] ^ _SIGN
    lt = torch.logical_or(ah < bh, torch.logical_and(ah == bh, al < bl))
    gt = torch.logical_or(ah > bh, torch.logical_and(ah == bh, al > bl))
    return torch.where(lt, -1, torch.where(gt, 1, 0)).to(torch.int32)


def d128_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.logical_and(a[:, 0] == b[:, 0], a[:, 1] == b[:, 1])


def d128_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return d128_cmp(a, b) < 0


# ---------------------------------------------------------------------------
# multiply (128 x 128 -> 256-bit digit form, sign-magnitude)
# ---------------------------------------------------------------------------
def _mul_abs_digits(da: List[torch.Tensor], db: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Schoolbook product of two 4-digit magnitudes -> 8 normalised digits.
    A 32x32 product may pass 2^63 and wrap in int64; its bits are the
    unsigned product's, which the masks read. Carries are normalised after
    each diagonal, so no lane sum overflows."""
    prod = [torch.zeros_like(da[0]) for _ in range(8)]
    for i in range(4):
        for j in range(4):
            p = da[i] * db[j]
            prod[i + j] = prod[i + j] + (p & _MASK32)
            prod[i + j + 1] = prod[i + j + 1] + ((p >> 32) & _MASK32)
        prod = _carry_normalize(prod)
    return prod


def d128_mul(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """-> (8-digit magnitude of |a*b|, negative flag)."""
    sa, sb = a[:, 0] < 0, b[:, 0] < 0
    da = _to_digits(d128_abs(a))
    db = _to_digits(d128_abs(b))
    return _mul_abs_digits(da, db), torch.logical_xor(sa, sb)


# ---------------------------------------------------------------------------
# division by powers of ten (rescale) with ROUND_HALF_UP
# ---------------------------------------------------------------------------
def _divmod_small(digits: List[torch.Tensor], d: int
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Digit-wise long division of a magnitude by d < 2^31, high to low:
    the partial remainder ``r * 2^32 + digit`` is below ``d * 2^32 <=
    2^62`` and non-negative, so torch's floor division is the JAX one."""
    q: List[torch.Tensor] = [None] * len(digits)  # type: ignore[list-item]
    r = torch.zeros_like(digits[0])
    for i in range(len(digits) - 1, -1, -1):
        cur = (r << 32) | digits[i]
        q[i] = torch.div(cur, d, rounding_mode="floor")
        r = cur - q[i] * d
    return q, r


def _pow10_chain(k: int) -> List[int]:
    """10^k as factors each <= 10^9 (digit-division sized)."""
    out = []
    while k > 0:
        step = min(k, 9)
        out.append(10 ** step)
        k -= step
    return out


def _digits_cmp(a: List[torch.Tensor], b: List[torch.Tensor]
                ) -> torch.Tensor:
    """-1/0/+1 comparing two equal-length digit magnitudes (int32)."""
    res = torch.zeros_like(a[0], dtype=torch.int32)
    for x, y in zip(a, b):  # least significant first: later digits win
        res = torch.where(x < y, -1, torch.where(x > y, 1, res)) \
            .to(torch.int32)
    return res


def _const_digits(v: int, ndig: int, like: torch.Tensor
                  ) -> List[torch.Tensor]:
    return [torch.full_like(like, (v >> (32 * i)) & _MASK32)
            for i in range(ndig)]


def _div_pow10_round_half_up(digits: List[torch.Tensor], k: int
                             ) -> List[torch.Tensor]:
    """Magnitude digit division by 10^k with exact HALF_UP rounding: the
    composite remainder ``r1 + d1*r2 + d1*d2*r3 ...`` is accumulated
    exactly in 5 digits and compared with 10^k by the doubled-remainder
    test."""
    if k == 0:
        return digits
    q = digits
    r_acc = [torch.zeros_like(digits[0]) for _ in range(5)]
    prefix = 1  # product of the divisors already applied
    for d in _pow10_chain(k):
        q, r = _divmod_small(q, d)
        add = [((prefix >> (32 * i)) & _MASK32) * r for i in range(5)]
        r_acc = _carry_normalize([x + y for x, y in zip(r_acc, add)])
        prefix *= d
    doubled = _carry_normalize([x * 2 for x in r_acc])
    round_up = _digits_cmp(doubled, _const_digits(10 ** k, 5,
                                                  doubled[0])) >= 0
    bump = [round_up.to(torch.int64)] \
        + [torch.zeros_like(q[0])] * (len(q) - 1)
    return _carry_normalize([x + y for x, y in zip(q, bump)])


def _mul_pow10_digits(digits: List[torch.Tensor], k: int
                      ) -> List[torch.Tensor]:
    """Magnitude digit multiply by 10^k, widening a digit a step."""
    for d in _pow10_chain(k):
        carry = torch.zeros_like(digits[0])
        out = []
        for x in digits:
            v = x * d + carry      # x < 2^32, d <= 10^9: fits int64
            out.append(v & _MASK32)
            carry = v >> 32
        out.append(carry & _MASK32)
        digits = _carry_normalize(out)
    return digits


def POW10_LIMBS(k: int) -> np.ndarray:
    """10^k as one (2,) int64 limb pair [hi, lo] (k <= 38)."""
    v = 10 ** k
    return np.array([v >> 64, v & _MASK64], dtype=np.uint64).view(np.int64)


def _digits_to_limbs_checked(digits: List[torch.Tensor], precision: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude digits -> limbs + overflow flag (|v| >= 10^precision, or
    a magnitude past 127 bits)."""
    over = torch.zeros_like(digits[0], dtype=torch.bool)
    for x in digits[4:]:
        over = torch.logical_or(over, x != 0)
    bound = _const_digits(10 ** precision, 4, digits[0])
    over = torch.logical_or(over, _digits_cmp(digits[:4], bound) >= 0)
    limbs = _from_digits(digits[:4])
    over = torch.logical_or(over, limbs[:, 0] < 0)
    return limbs, over


def _pad8(mag: List[torch.Tensor]) -> List[torch.Tensor]:
    return mag + [torch.zeros_like(mag[0])] * max(0, 8 - len(mag))


def d128_rescale_reference(a: torch.Tensor, from_scale: int, to_scale: int,
                           precision: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``d128_rescale`` (JAX ``d128_rescale`` :310):
    change scale with HALF_UP rounding -> (limbs, overflow flag). A 1-D
    int64 operand is scaled int64, widened first."""
    if a.dim() == 1:
        a = d128_from_i64(a)
    sign_neg = a[:, 0] < 0
    mag = _to_digits(d128_abs(a))
    if to_scale > from_scale:
        mag = _mul_pow10_digits(mag, to_scale - from_scale)
    elif to_scale < from_scale:
        mag = _div_pow10_round_half_up(mag, from_scale - to_scale)
    limbs, over = _digits_to_limbs_checked(_pad8(mag), precision)
    limbs = torch.where(sign_neg[:, None], d128_neg(limbs), limbs)
    return limbs, over


def d128_mul_rescaled_reference(a: torch.Tensor, b: torch.Tensor,
                                scale_drop: int, precision: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``d128_mul_rescaled`` (JAX :327, via ``d128_mul``
    :189, ``_div_pow10_round_half_up`` :239 and ``_digits_to_limbs_checked``
    :293): ``a * b`` with the product's scale reduced by ``scale_drop``
    digits (HALF_UP), checked against ``precision`` -> (limbs, overflow). A
    1-D int64 operand is scaled int64, widened first."""
    if a.dim() == 1:
        a = d128_from_i64(a)
    if b.dim() == 1:
        b = d128_from_i64(b)
    mag, neg = d128_mul(a, b)
    if scale_drop > 0:
        mag = _div_pow10_round_half_up(mag, scale_drop)
    limbs, over = _digits_to_limbs_checked(_pad8(mag), precision)
    limbs = torch.where(neg[:, None], d128_neg(limbs), limbs)
    return limbs, over


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------
def d128_from_i64(v: torch.Tensor) -> torch.Tensor:
    """Scaled int64 (decimal64 storage) -> limbs (sign extended)."""
    return torch.stack([v >> 63, v], dim=1)


def d128_to_i64(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Limbs -> int64 + overflow flag (value outside int64)."""
    hi, lo = a[:, 0], a[:, 1]
    fits = torch.logical_or(torch.logical_and(hi == 0, lo >= 0),
                            torch.logical_and(hi == -1, lo < 0))
    return lo, torch.logical_not(fits)


def d128_trunc_low64(a: torch.Tensor, scale: int) -> torch.Tensor:
    """Limbs at ``scale`` -> the value truncated toward zero to an integer,
    its low 64 bits as int64 (Spark's non-ANSI ``Decimal.toLong``): the
    magnitude divided by 10^scale over the digit planes (floor(floor(x / a)
    / b) = floor(x / (a b))), the sign put back modulo 2^64."""
    neg = a[:, 0] < 0
    q = _to_digits(d128_abs(a))
    for d in _pow10_chain(scale):
        q, _ = _divmod_small(q, d)
    lo = q[0] | (q[1] << 32)
    return torch.where(neg, -lo, lo)


def _u64_to_f64(w: torch.Tensor) -> torch.Tensor:
    """The uint64 bits of ``w`` as float64, rounded once (two exact 32-bit
    halves and one rounding add, the conversion the JAX package's uint64
    cast makes)."""
    h = ((w >> 32) & _MASK32).to(torch.float64)
    return h * 4294967296.0 + (w & _MASK32).to(torch.float64)


def d128_to_f64(a: torch.Tensor) -> torch.Tensor:
    hi = a[:, 0].to(torch.float64)
    return hi * (2.0 ** 64) + _u64_to_f64(a[:, 1])


def d128_from_f64(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 -> limbs (truncating toward zero) + overflow flag. Exact for
    |v| < 2^127; beyond, and for NaN, the flag is set (the limbs are then
    the truncation's, not the JAX package's)."""
    over = torch.logical_or(torch.abs(v) >= 2.0 ** 127, torch.isnan(v))
    neg = v < 0
    av = torch.where(over, 0.0, torch.abs(v))
    hi_f = torch.floor(av / (2.0 ** 64))
    lo_f = av - hi_f * (2.0 ** 64)
    hi = hi_f.to(torch.int64)
    lo_top = torch.floor(lo_f / (2.0 ** 32))
    lo_bot = (lo_f - lo_top * (2.0 ** 32)).to(torch.int64)
    lo = (lo_top.to(torch.int64) << 32) | (lo_bot & _MASK32)
    limbs = torch.stack([hi, lo], dim=1)
    limbs = torch.where(neg[:, None], d128_neg(limbs), limbs)
    return limbs, over


def d128_overflows(a: torch.Tensor, precision: int) -> torch.Tensor:
    """|a| >= 10^precision (precision <= 38)."""
    mag = _to_digits(d128_abs(a))
    return _digits_cmp(mag, _const_digits(10 ** precision, 4, mag[0])) >= 0


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------
def d128_segment_sum_reference(a: torch.Tensor, contrib: torch.Tensor,
                               gid: torch.Tensor, cap: int, precision: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``d128_segment_sum`` (JAX :395): per group, the
    exact sum of the contributing rows -> (limbs[cap], overflow[cap]).
    Positive and negative magnitudes are summed apart, digit plane by
    digit plane (a digit is below 2^32 and a batch below 2^31 rows, so no
    lane sum leaves int64), then subtracted and checked. Rows whose group
    id is outside ``[0, cap)`` are dropped, as ``segment_sum`` drops them.
    A 1-D int64 operand is scaled int64, widened first."""
    if a.dim() == 1:
        a = d128_from_i64(a)
    g = gid.to(torch.int64)
    in_range = torch.logical_and(g >= 0, g < cap)
    g = torch.where(in_range, g, 0)
    contrib = torch.logical_and(contrib, in_range)
    neg = a[:, 0] < 0
    mag = _to_digits(d128_abs(a))
    pos_c = torch.logical_and(contrib, torch.logical_not(neg))
    neg_c = torch.logical_and(contrib, neg)

    def seg(digs, c):
        out = [torch.zeros(cap, dtype=torch.int64, device=a.device)
               .index_add_(0, g, torch.where(c, x, 0)) for x in digs]
        return _carry_normalize(out + [torch.zeros_like(out[0])])

    pos = seg(mag, pos_c)
    negs = seg(mag, neg_c)
    cmp = _digits_cmp(pos, negs)
    big = [torch.where(cmp >= 0, p, q) for p, q in zip(pos, negs)]
    small = [torch.where(cmp >= 0, q, p) for p, q in zip(pos, negs)]
    diff = _carry_normalize([x - y for x, y in zip(big, small)])
    over = diff[4] != 0
    bound = _const_digits(10 ** precision, 4, diff[0])
    over = torch.logical_or(over, _digits_cmp(diff[:4], bound) >= 0)
    limbs = _from_digits(diff[:4])
    over = torch.logical_or(over, limbs[:, 0] < 0)
    limbs = torch.where((cmp < 0)[:, None], d128_neg(limbs), limbs)
    return limbs, over


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
def _check_value(name: str, t: torch.Tensor, device) -> int:
    """A decimal operand: contiguous int64, ``(n, 2)`` limbs or ``(n,)``
    scaled int64 -> 1 for limbs, 0 for int64."""
    if t.dtype != torch.int64 or not t.is_contiguous() \
            or not (t.dim() == 1 or (t.dim() == 2 and t.shape[1] == 2)):
        raise TypeError(f"{name} must be a contiguous int64 (n, 2) limb or "
                        f"(n,) scaled int64 tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return int(t.dim() == 2)


def _check_precision(fn: str, precision: int) -> None:
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"{fn}: precision {precision} outside "
                         f"1..{MAX_PRECISION}")


def _cuda_device(fn: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise TypeError(f"{fn}: no kernel for device {device}")


def d128_mul_rescaled(a: torch.Tensor, b: torch.Tensor, scale_drop: int,
                      precision: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a * b``, each operand ``(n, 2)`` limbs or ``(n,)`` scaled int64,
    with the product's scale reduced by ``scale_drop`` digits (HALF_UP) and
    checked against ``10**precision`` -> ((n, 2) int64 limbs, (n,) bool
    overflow). Kernel: ``csrc/decimal128.cu d128_mul_rescaled``."""
    dev = a.device
    wa = _check_value("a", a, dev)
    wb = _check_value("b", b, dev)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"d128_mul_rescaled: {a.shape[0]} rows against "
                         f"{b.shape[0]}")
    if not 0 <= scale_drop <= MAX_MUL_SCALE_DROP:
        raise ValueError(f"d128_mul_rescaled: scale drop {scale_drop} "
                         f"outside 0..{MAX_MUL_SCALE_DROP}")
    _check_precision("d128_mul_rescaled", precision)
    if dev.type == "cpu":
        return d128_mul_rescaled_reference(a, b, scale_drop, precision)
    _cuda_device("d128_mul_rescaled", dev)
    n = a.shape[0]
    out = torch.empty((n, 2), dtype=torch.int64, device=dev)
    over = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        launch(d128_mul_rescaled, "srt_d128_mul_rescaled", dev,
               a.data_ptr(), wa, b.data_ptr(), wb, n, scale_drop, precision,
               out.data_ptr(), over.data_ptr())
    return out, over


def d128_rescale(a: torch.Tensor, from_scale: int, to_scale: int,
                 precision: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Change the scale of ``a`` (``(n, 2)`` limbs or ``(n,)`` scaled int64)
    with HALF_UP rounding, checked against ``10**precision`` -> ((n, 2)
    limbs, (n,) bool overflow). Kernel: ``csrc/decimal128.cu
    d128_rescale``."""
    dev = a.device
    wide = _check_value("a", a, dev)
    for name, s in (("from_scale", from_scale), ("to_scale", to_scale)):
        if not 0 <= s <= MAX_PRECISION:
            raise ValueError(f"d128_rescale: {name} {s} outside "
                             f"0..{MAX_PRECISION}")
    _check_precision("d128_rescale", precision)
    if dev.type == "cpu":
        return d128_rescale_reference(a, from_scale, to_scale, precision)
    _cuda_device("d128_rescale", dev)
    n = a.shape[0]
    out = torch.empty((n, 2), dtype=torch.int64, device=dev)
    over = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        launch(d128_rescale, "srt_d128_rescale", dev, a.data_ptr(), wide, n,
               to_scale - from_scale, precision, out.data_ptr(),
               over.data_ptr())
    return out, over


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (a view
    past an odd row): the segment sum reads 16-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def d128_segment_sum(a: torch.Tensor, contrib: torch.Tensor,
                     gid: torch.Tensor, cap: int, precision: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per group ``g < cap``, the exact sum of the rows of ``a`` (``(n, 2)``
    limbs or ``(n,)`` scaled int64) with ``contrib`` set and ``gid == g``,
    checked against ``10**precision`` -> ((cap, 2) limbs, (cap,) bool
    overflow). ``gid`` is int32 or int64; rows with an id outside ``[0,
    cap)`` are dropped. Kernel: ``csrc/decimal128.cu d128_segment_sum``
    (192-bit accumulators, so a total past 2^128 is seen): up to
    ``SEGMENT_SUM_SMALL_CAP`` groups in registers, two launches, counted
    in ``d128_segment_sum.small_cap_launches`` too; more groups through
    shared and global atomics over zeroed scratch."""
    dev = a.device
    wide = _check_value("a", a, dev)
    n = a.shape[0]
    if contrib.dtype != torch.bool or contrib.shape != (n,) \
            or not contrib.is_contiguous() or contrib.device != dev:
        raise TypeError(f"contrib must be a contiguous ({n},) bool tensor on "
                        f"{dev}, got {contrib.dtype} "
                        f"{tuple(contrib.shape)} on {contrib.device}")
    if gid.dtype not in (torch.int32, torch.int64) or gid.shape != (n,) \
            or not gid.is_contiguous() or gid.device != dev:
        raise TypeError(f"gid must be a contiguous ({n},) int32 or int64 "
                        f"tensor on {dev}, got {gid.dtype} "
                        f"{tuple(gid.shape)} on {gid.device}")
    if cap < 1:
        raise ValueError(f"d128_segment_sum: cap {cap} < 1")
    if n >= 2 ** 31:
        raise ValueError(f"d128_segment_sum: {n} rows; a batch holds fewer "
                         "than 2^31")
    _check_precision("d128_segment_sum", precision)
    if dev.type == "cpu":
        return d128_segment_sum_reference(a, contrib, gid, cap, precision)
    _cuda_device("d128_segment_sum", dev)
    from ..native import load_kernels
    lib = load_kernels()
    out = torch.empty((cap, 2), dtype=torch.int64, device=dev)
    over = torch.empty(cap, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.srt_d128_segment_sum_scratch(n, cap),
                          dtype=torch.int64, device=dev)
    a, contrib, gid = (_aligned16(t) for t in (a, contrib, gid))
    launch(d128_segment_sum, "srt_d128_segment_sum", dev, a.data_ptr(), wide,
           contrib.data_ptr(), gid.data_ptr(), int(gid.dtype == torch.int64),
           n, cap, precision, scratch.data_ptr(), out.data_ptr(),
           over.data_ptr())
    if cap <= lib.srt_d128_segment_sum_small_cap():
        d128_segment_sum.small_cap_launches += 1
    return out, over


for _fn in (d128_mul_rescaled, d128_rescale, d128_segment_sum):
    _fn.launches = 0
d128_segment_sum.small_cap_launches = 0
