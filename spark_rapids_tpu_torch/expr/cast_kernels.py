"""String casts over the (rows, width) uint8 byte matrix of a device string
column — the port of ``spark_rapids_tpu/expr/cast_kernels.py``
(reference: GpuCast.scala:1513).

Each direction has a plain torch version under the JAX package's name,
written as the JAX package writes it (masks over the matrix, a loop over its
columns where it scans), and two wrappers launch the hand-written kernels of
``csrc/strings_cast.cu``:

- ``str_parse(data, lengths, kind)``: ``string_to_long_device``,
  ``string_to_double_device``, ``string_to_bool_device``,
  ``string_to_date_device`` -> (values, ok);
- ``str_format(values, kind, scale)``: ``int_to_string_device``,
  ``date_to_string_device``, ``decimal_to_string_device``,
  ``bool_to_string_device`` -> (matrix, lengths).

A wrapper takes the plain version for a tensor on the CPU, and launches the
kernel for one on the card; it never falls back. Malformed input gives
ok = False (Spark's non-ANSI null).

The double parse follows what XLA:CPU makes of the JAX formulas, so that
the port matches the JAX package bit for bit: ``acc * 10.0 + d`` and
``mant + frac * 10^-fcnt`` are fused multiply-adds (one rounding each; the
plain version emulates them exactly), a subnormal result is flushed to
zero, and ``10^k`` is XLA's ``pow`` (``POW10``: exact powers of ten, but
zero below 10^-307 and one ulp high at 10^23 and 10^210). The formula is
not correctly rounded: the host engine's ``float(s)`` is.

Torch has no shift, remainder or order on unsigned integers, so the JAX
package's uint64 accumulators ride int64 bit for bit (products wrap alike)
and an unsigned comparison flips the sign bit of both sides.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..native import launch

__all__ = ["int_to_string_device", "bool_to_string_device",
           "date_to_string_device", "decimal_to_string_device",
           "string_to_long_device", "string_to_double_device",
           "string_to_bool_device", "string_to_date_device",
           "str_parse", "str_parse_reference", "str_format",
           "str_format_reference", "POW10", "PARSE_KINDS", "FORMAT_KINDS",
           "FORMAT_WIDTH"]

#: the kernel's parse kinds (csrc/strings_cast.cu ParseKind)
PARSE_KINDS = {"long": 0, "double": 1, "bool": 2, "date": 3}
#: the kernel's format kinds (csrc/strings_cast.cu FormatKind)
FORMAT_KINDS = {"long": 0, "date": 1, "decimal": 2, "bool": 3}
#: the output width of each format kind, as in the JAX package
FORMAT_WIDTH = {"long": 32, "date": 16, "decimal": 32, "bool": 8}

_POW_LO, _POW_HI = -400, 400


def _xla_pow10() -> np.ndarray:
    """pow(10, k) for k in [-400, 400] as XLA:CPU computes it."""
    table = np.array([float(f"1e{k}") for k in range(_POW_LO, _POW_HI + 1)])
    table[-323 - _POW_LO:-307 - _POW_LO] = 0.0     # flushed subnormals
    table[23 - _POW_LO] = float.fromhex("0x1.52d02c7e14af7p+76")
    table[210 - _POW_LO] = float.fromhex("0x1.8557f31326bbcp+697")
    return table


#: XLA:CPU's pow(10, k), k = -400 .. 400
POW10 = _xla_pow10()
_MIN_NORMAL = 2.2250738585072014e-308
_SIGN = -2**63
#: (name, device) -> a constant tensor, copied to the device once (a copy
#: from host memory cannot run inside a CUDA graph's capture)
_CONSTS: dict = {}


def _const(name: str, make, device) -> torch.Tensor:
    key = (name, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(make()).to(device)
    return t


def _pow10_table(device) -> torch.Tensor:
    return _const("pow10", lambda: POW10, device)


def _pow10(k: torch.Tensor) -> torch.Tensor:
    """``jnp.power(10.0, k)`` for integral float64 ``k``."""
    idx = k.clamp(_POW_LO, _POW_HI).to(torch.int64) - _POW_LO
    return _pow10_table(k.device)[idx]


# ---------------------------------------------------------------------------
# exact fused multiply-add (what XLA:CPU contracts to)
# ---------------------------------------------------------------------------
def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = a * 134217729.0
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a, b):
    """a + b rounded to odd: an inexact sum takes the neighbour whose last
    bit is 1."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    fix = torch.logical_and(e != 0, even)
    toward = torch.where(e > 0, float("inf"), float("-inf"))
    return torch.where(fix, torch.nextafter(s, toward), s)


def _fma_from_product(uh, ul, c):
    """RN(uh + ul + c) for an exact product uh + ul (uh = RN(uh + ul)):
    Boldo and Melquiond's emulation of the FMA through round-to-odd."""
    th, tl = _two_sum(c, uh)
    return th + _round_odd_sum(tl, ul)


def _fma10(acc: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """fma(acc, 10, d): 10 * acc is 8 * acc + 2 * acc, both exact."""
    uh, ul = _two_sum(acc * 8.0, acc * 2.0)
    out = _fma_from_product(uh, ul, d)
    return torch.where(torch.isfinite(acc), out, acc * 10.0 + d)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) for finite a, b, c with a >= 0 and 0 <= b <= 1 (the
    mantissa's fraction and its power of ten); a past 2^900 is scaled by
    2^-600 first (and b by 2^600), so that the split cannot overflow."""
    big = a > 2.0 ** 900
    a2 = torch.where(big, a * 2.0 ** -600, a)
    b2 = torch.where(big, b * 2.0 ** 600, b)
    uh, ul = _two_prod(a2, b2)
    out = _fma_from_product(uh, ul, c)
    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    return torch.where(finite, out, a * b + c)


# ---------------------------------------------------------------------------
# number/date/bool -> string (the plain versions of str_format)
# ---------------------------------------------------------------------------
def _digits(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """int64 -> (negative, digits (n, 20) least significant first, digit
    count), INT64_MIN-safe: the last digit comes from the value, the rest
    from the truncated tenth, whose magnitude fits int64."""
    v = vals.to(torch.int64)
    neg = v < 0
    q = torch.div(v, 10, rounding_mode="trunc")
    rest = q.abs()
    cols = [(v - q * 10).abs()]
    r = rest
    for _ in range(19):
        cols.append(torch.remainder(r, 10))
        r = torch.div(r, 10, rounding_mode="floor")
    p10 = _const("p10", lambda: np.array([10 ** k for k in range(19)],
                                         dtype=np.int64), v.device)
    ndig = 1 + (rest[:, None] >= p10[None, :]).sum(1).to(torch.int32)
    return neg, torch.stack(cols, 1), ndig


def _place(digs: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """The ASCII digit ``digs[row, exp]`` (exp clipped to [0, 19])."""
    d = torch.gather(digs, 1, exp.clamp(0, 19).to(torch.int64))
    return (d + ord("0")).to(torch.uint8)


def int_to_string_device(vals: torch.Tensor, width: int = 32):
    """int64 -> left-aligned decimal bytes -> (data (n, width), lengths)."""
    neg, digs, ndig = _digits(vals)
    negi = neg.to(torch.int32)
    length = ndig + negi
    j = torch.arange(width, dtype=torch.int32, device=vals.device)
    p = j[None, :] - negi[:, None]
    ch = _place(digs, ndig[:, None] - 1 - p)
    ch = torch.where(torch.logical_and(neg[:, None], j[None, :] == 0),
                     ord("-"), ch)
    data = torch.where(j[None, :] < length[:, None], ch, 0).to(torch.uint8)
    return data, length


def bool_to_string_device(vals: torch.Tensor, width: int = 8):
    t = np.zeros(width, dtype=np.uint8)
    t[:4] = np.frombuffer(b"true", dtype=np.uint8)
    f = np.zeros(width, dtype=np.uint8)
    f[:5] = np.frombuffer(b"false", dtype=np.uint8)
    b = vals.to(torch.bool)
    tt = _const(f"true{width}", lambda: t, vals.device)
    ft = _const(f"false{width}", lambda: f, vals.device)
    data = torch.where(b[:, None], tt[None, :], ft[None, :])
    return data, torch.where(b, 4, 5).to(torch.int32)


def date_to_string_device(days: torch.Tensor, width: int = 16):
    """days-since-epoch -> 'YYYY-MM-DD' bytes (years clipped to 0..9999)."""
    from .datetimes import civil_from_days
    from .xp_torch import TorchNamespace
    y, m, d = (x.to(torch.int64) for x in
               civil_from_days(TorchNamespace(days.device), days))
    y = y.clamp(0, 9999)
    dash = torch.full_like(y, -1)
    digs = torch.stack([y // 1000 % 10, y // 100 % 10, y // 10 % 10, y % 10,
                        dash, m // 10 % 10, m % 10, dash, d // 10 % 10,
                        d % 10], 1)
    ch = torch.where(digs < 0, ord("-"), digs + ord("0")).to(torch.uint8)
    data = torch.zeros((days.shape[0], width), dtype=torch.uint8,
                       device=days.device)
    data[:, :10] = ch
    return data, torch.full((days.shape[0],), 10, dtype=torch.int32,
                            device=days.device)


def decimal_to_string_device(unscaled: torch.Tensor, scale: int,
                             width: int = 32):
    """scaled-int64 decimal -> '[-]intpart[.fraction]' bytes."""
    neg, digs, ndig = _digits(unscaled)
    negi = neg.to(torch.int32)
    ndig = torch.clamp(ndig, min=scale + 1)   # '0.05' keeps a leading zero
    point = 1 if scale > 0 else 0
    length = ndig + point + negi
    j = torch.arange(width, dtype=torch.int32, device=unscaled.device)
    p = j[None, :] - negi[:, None]
    int_digits = ndig - scale
    is_point = (p == int_digits[:, None]) if point \
        else torch.zeros_like(p, dtype=torch.bool)
    di = torch.where(p > int_digits[:, None], p - 1, p) if point else p
    ch = _place(digs, ndig[:, None] - 1 - di)
    ch = torch.where(is_point, ord("."), ch)
    ch = torch.where(torch.logical_and(neg[:, None], j[None, :] == 0),
                     ord("-"), ch)
    data = torch.where(j[None, :] < length[:, None], ch, 0).to(torch.uint8)
    return data, length


def str_format_reference(values: torch.Tensor, kind: str, scale: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``str_format``."""
    if kind == "long":
        return int_to_string_device(values)
    if kind == "date":
        return date_to_string_device(values)
    if kind == "decimal":
        return decimal_to_string_device(values, scale)
    if kind == "bool":
        return bool_to_string_device(values)
    raise ValueError(f"str_format: kind {kind!r}")


_FORMAT_DTYPE = {"long": torch.int64, "date": torch.int32,
                 "decimal": torch.int64, "bool": torch.bool}


def str_format(values: torch.Tensor, kind: str, scale: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values -> (uint8 matrix (n, FORMAT_WIDTH[kind]), int32 lengths):
    the plain version for a CPU tensor, else the ``str_format`` kernel."""
    if values.device.type == "cpu":
        return str_format_reference(values, kind, scale)
    if kind not in FORMAT_KINDS or not 0 <= scale <= 18:
        raise ValueError(f"str_format: kind {kind!r}, scale {scale}")
    v = values.to(_FORMAT_DTYPE[kind]).contiguous()
    if kind == "bool":
        v = v.view(torch.uint8)
    n, width = v.shape[0], FORMAT_WIDTH[kind]
    out = torch.empty((n, width), dtype=torch.uint8, device=v.device)
    lengths = torch.empty(n, dtype=torch.int32, device=v.device)
    if n:
        launch(str_format, "srt_str_format", v.device, v.data_ptr(), n,
               FORMAT_KINDS[kind], scale, width, out.data_ptr(),
               lengths.data_ptr())
    return out, lengths


#: kernel launches so far (a test or smoke run resets it to 0)
str_format.launches = 0


# ---------------------------------------------------------------------------
# string -> number/bool/date (the plain versions of str_parse)
# ---------------------------------------------------------------------------
def _cols(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=device)


def _trim_bounds(data: torch.Tensor, lengths: torch.Tensor):
    """-> (start, end) per row after trimming ASCII whitespace."""
    n, w = data.shape
    j = _cols(w, data.device)
    in_str = j[None, :] < lengths[:, None]
    ws = (data == 32) | ((data >= 9) & (data <= 13))
    content = torch.logical_and(in_str, torch.logical_not(ws))
    any_content = content.any(1)
    c8 = content.to(torch.uint8)
    start = torch.argmax(c8, 1).to(torch.int32)
    end = (w - torch.argmax(c8.flip(1), 1)).to(torch.int32)
    zero = torch.zeros_like(start)
    return (torch.where(any_content, start, zero),
            torch.where(any_content, end, zero))


def _at(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[row, idx[row]], idx clipped into the matrix."""
    i = idx.clamp(0, max(data.shape[1] - 1, 0)).to(torch.int64)
    return torch.gather(data, 1, i[:, None])[:, 0]


def _first(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    """The first column where ``mask`` holds, else ``default``."""
    hit = torch.argmax(mask.to(torch.uint8), 1).to(torch.int32)
    return torch.where(mask.any(1), hit, default)


def _parse_digits_u64(data: torch.Tensor, sel: torch.Tensor):
    """The selected digits left to right into a wrapping uint64 (in int64
    bits) and their count."""
    n, w = data.shape
    acc = torch.zeros(n, dtype=torch.int64, device=data.device)
    cnt = torch.zeros(n, dtype=torch.int32, device=data.device)
    d = data.to(torch.int64) - ord("0")
    for c in range(w):
        pick = sel[:, c]
        acc = torch.where(pick, acc * 10 + d[:, c], acc)
        cnt = cnt + pick.to(torch.int32)
    return acc, cnt


def _parse_digits_float(data: torch.Tensor, sel: torch.Tensor):
    """The selected digits left to right into a float64, each step one
    fused multiply-add as XLA:CPU computes it, and their count."""
    n, w = data.shape
    acc = torch.zeros(n, dtype=torch.float64, device=data.device)
    cnt = torch.zeros(n, dtype=torch.int32, device=data.device)
    d = (data.to(torch.int32) - ord("0")).to(torch.float64)
    for c in range(w):
        pick = sel[:, c]
        acc = torch.where(pick, _fma10(acc, d[:, c]), acc)
        cnt = cnt + pick.to(torch.int32)
    return acc, cnt


def _lower(data: torch.Tensor) -> torch.Tensor:
    up = (data >= ord("A")) & (data <= ord("Z"))
    return torch.where(up, data + 32, data).to(torch.uint8)


def _u64_le(a: torch.Tensor, b) -> torch.Tensor:
    """a <= b for uint64 bit patterns held in int64."""
    return (a ^ _SIGN) <= (b ^ _SIGN)


def string_to_long_device(data: torch.Tensor, lengths: torch.Tensor):
    """bytes -> (int64 values, ok). Accepts [+-]digits[.digits] (fraction
    truncated), Spark non-ANSI: malformed or overflowing -> null."""
    n, w = data.shape
    j = _cols(w, data.device)[None, :]
    start, end = _trim_bounds(data, lengths)
    first = _at(data, start)
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg = first == ord("-")
    dstart = start + has_sign.to(torch.int32)
    in_tok = (j >= dstart[:, None]) & (j < end[:, None])
    is_digit = (data >= ord("0")) & (data <= ord("9"))
    is_point = data == ord(".")
    point_pos = _first(is_point & in_tok, end)
    int_sel = in_tok & is_digit & (j < point_pos[:, None])
    valid_chars = torch.all(torch.logical_not(in_tok) | is_digit
                            | (is_point & (j == point_pos[:, None])), 1)
    acc, cnt = _parse_digits_u64(data, int_sel)
    # uint64 accumulation wraps silently: a float64 shadow sees magnitudes
    # past the int64 range (leading zeros keep longer strings legal)
    facc, _ = _parse_digits_float(data, int_sel)
    limit = torch.where(neg, _SIGN, 2**63 - 1)     # INT64_MAX + neg
    ok = valid_chars & (cnt > 0) & (facc <= 9.3e18) & _u64_le(acc, limit)
    vals = torch.where(neg, -acc, acc)
    return torch.where(ok, vals, 0), ok


def string_to_double_device(data: torch.Tensor, lengths: torch.Tensor):
    """bytes -> (float64, ok). [+-]digits[.digits][eE[+-]digits] plus the
    Spark special tokens Infinity/-Infinity/NaN (case-insensitive)."""
    n, w = data.shape
    dev = data.device
    jj = _cols(w, dev)
    j = jj[None, :]
    start, end = _trim_bounds(data, lengths)
    low = _lower(data)
    first = _at(data, start)
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg = first == ord("-")
    dstart = start + has_sign.to(torch.int32)
    tok_len = end - dstart

    def matches(token: bytes):
        t = np.zeros(w, dtype=np.uint8)
        k = min(len(token), w)
        t[:k] = np.frombuffer(token[:k], dtype=np.uint8)
        idx = (dstart[:, None] + jj[None, :]).clamp(0, w - 1).to(torch.int64)
        shifted = torch.gather(low, 1, idx)
        want = _const(f"{token!r}{w}", lambda: t, dev)[None, :]
        k_in = j < len(token)
        return torch.all(torch.logical_not(k_in) | (shifted == want), 1) \
            & (tok_len == len(token))

    is_inf = matches(b"infinity") | matches(b"inf")
    is_nan = matches(b"nan") & torch.logical_not(has_sign)
    in_tok = (j >= dstart[:, None]) & (j < end[:, None])
    is_digit = (data >= ord("0")) & (data <= ord("9"))
    is_point = data == ord(".")
    is_e = low == ord("e")
    e_pos = _first(is_e & in_tok, end)
    before_e = j < e_pos[:, None]
    point_pos = _first(is_point & in_tok & before_e, e_pos)
    mant_int = in_tok & is_digit & before_e & (j < point_pos[:, None])
    mant_frac = in_tok & is_digit & before_e & (j > point_pos[:, None])
    es = e_pos + 1
    echar = _at(data, es)
    e_sign = (echar == ord("-")) | (echar == ord("+"))
    e_neg = echar == ord("-")
    e_dstart = es + e_sign.to(torch.int32)
    exp_sel = (j >= e_dstart[:, None]) & (j < end[:, None]) & is_digit
    has_e = e_pos < end
    mant, icnt = _parse_digits_float(data, mant_int)
    frac, fcnt = _parse_digits_float(data, mant_frac)
    expv, ecnt = _parse_digits_float(data, exp_sel)
    classified = torch.logical_not(in_tok) | is_digit \
        | (is_point & (j == point_pos[:, None]) & before_e) \
        | (is_e & (j == e_pos[:, None])) \
        | (((data == ord("-")) | (data == ord("+")))
           & (j == es[:, None]) & has_e[:, None])
    valid = torch.all(classified, 1) & ((icnt + fcnt) > 0) \
        & (torch.logical_not(has_e) | (ecnt > 0))
    expo = torch.where(e_neg, -expv, expv)
    value = _fma(frac, _pow10(-fcnt.to(torch.float64)), mant) * _pow10(expo)
    value = torch.where(value.abs() < _MIN_NORMAL, 0.0, value)   # flush
    value = torch.where(neg, -value, value)
    value = torch.where(is_inf, torch.where(neg, float("-inf"),
                                            float("inf")), value)
    value = torch.where(is_nan, float("nan"), value)
    ok = (valid | is_inf | is_nan) & ((end - start) > 0)
    return torch.where(ok, value, 0.0), ok


_TRUE_TOKENS = (b"true", b"t", b"yes", b"y", b"1")
_FALSE_TOKENS = (b"false", b"f", b"no", b"n", b"0")


def string_to_bool_device(data: torch.Tensor, lengths: torch.Tensor):
    n, w = data.shape
    dev = data.device
    jj = _cols(w, dev)
    start, end = _trim_bounds(data, lengths)
    low = _lower(data)
    tok_len = end - start
    idx = (start[:, None] + jj[None, :]).clamp(0, w - 1).to(torch.int64)
    shifted = torch.gather(low, 1, idx)

    def matches(token: bytes):
        t = np.zeros(w, dtype=np.uint8)
        k = min(len(token), w)
        t[:k] = np.frombuffer(token[:k], dtype=np.uint8)
        k_in = jj[None, :] < len(token)
        return torch.all(torch.logical_not(k_in) | (
            shifted == _const(f"{token!r}{w}", lambda: t, dev)[None, :]), 1) \
            & (tok_len == len(token))

    is_true = torch.zeros(n, dtype=torch.bool, device=dev)
    for tk in _TRUE_TOKENS:
        is_true = is_true | matches(tk)
    is_false = torch.zeros(n, dtype=torch.bool, device=dev)
    for tk in _FALSE_TOKENS:
        is_false = is_false | matches(tk)
    return is_true, is_true | is_false


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    base = _const("dim", lambda: np.array(
        [0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], np.int64),
        y.device)
    dim = base[m.clamp(0, 12)]
    return torch.where((m == 2) & leap, 29, dim)


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


def string_to_date_device(data: torch.Tensor, lengths: torch.Tensor):
    """'yyyy[-m[m][-d[d]]]' -> (days-since-epoch int32, ok)."""
    n, w = data.shape
    j = _cols(w, data.device)[None, :]
    start, end = _trim_bounds(data, lengths)
    in_tok = (j >= start[:, None]) & (j < end[:, None])
    is_digit = (data >= ord("0")) & (data <= ord("9"))
    is_dash = data == ord("-")
    dash = is_dash & in_tok
    ndash = dash.sum(1)
    d1 = _first(dash, end)
    after1 = dash & (j > d1[:, None])
    d2 = _first(after1, end)
    ysel = in_tok & is_digit & (j < d1[:, None])
    msel = in_tok & is_digit & (j > d1[:, None]) & (j < d2[:, None])
    dsel = in_tok & is_digit & (j > d2[:, None])
    yv, ycnt = _parse_digits_u64(data, ysel)
    mv, mcnt = _parse_digits_u64(data, msel)
    dv, dcnt = _parse_digits_u64(data, dsel)
    classified = torch.logical_not(in_tok) | is_digit | (
        is_dash & ((j == d1[:, None]) | (j == d2[:, None])))
    one = torch.ones_like(yv)
    mv = torch.where(ndash >= 1, mv, one)
    dv = torch.where(ndash >= 2, dv, one)
    mcnt_ok = torch.where(ndash >= 1, (mcnt >= 1) & (mcnt <= 2), True)
    dcnt_ok = torch.where(ndash >= 2, (dcnt >= 1) & (dcnt <= 2), True)
    dim = _days_in_month(yv, mv)
    # year >= 1: Python's datetime (the host engine) has no year 0
    ok = torch.all(classified, 1) & (ndash <= 2) & (ycnt == 4) \
        & mcnt_ok & dcnt_ok & (yv >= 1) \
        & (mv >= 1) & (mv <= 12) & (dv >= 1) & (dv <= dim) \
        & ((end - start) > 0)
    days = _days_from_civil(yv, mv, dv).to(torch.int32)
    return torch.where(ok, days, 0), ok


_PARSE_PLAIN = {"long": string_to_long_device,
                "double": string_to_double_device,
                "bool": string_to_bool_device,
                "date": string_to_date_device}
_PARSE_DTYPE = {"long": torch.int64, "double": torch.float64,
                "bool": torch.bool, "date": torch.int32}


def str_parse_reference(data: torch.Tensor, lengths: torch.Tensor,
                        kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``str_parse``."""
    if kind not in _PARSE_PLAIN:
        raise ValueError(f"str_parse: kind {kind!r}")
    return _PARSE_PLAIN[kind](data, lengths.to(torch.int32))


def str_parse(data: torch.Tensor, lengths: torch.Tensor, kind: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """String rows -> (values, ok) as ``kind`` ('long', 'double', 'bool',
    'date'): the plain version for CPU tensors, else the ``str_parse``
    kernel. ``data`` may be a broadcast row (stride 0 between rows)."""
    if data.device.type == "cpu":
        return str_parse_reference(data, lengths, kind)
    if kind not in PARSE_KINDS or data.dim() != 2 \
            or data.dtype != torch.uint8:
        raise ValueError(f"str_parse: kind {kind!r}, matrix "
                         f"{tuple(data.shape)} {data.dtype}")
    dev = data.device
    n, width = data.shape
    if data.stride(1) != 1:
        data = data.contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty(n, dtype=_PARSE_DTYPE[kind], device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        launch(str_parse, "srt_str_parse", dev, data.data_ptr(),
               data.stride(0), width, lens.data_ptr(), n, PARSE_KINDS[kind],
               _pow10_table(dev).data_ptr(), out.data_ptr(), ok.data_ptr())
    return out, ok


#: kernel launches so far (a test or smoke run resets it to 0)
str_parse.launches = 0
