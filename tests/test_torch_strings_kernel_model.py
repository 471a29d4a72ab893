"""``csrc/strings_cast.cu``'s ``str_parse`` and ``str_format`` on the CPU,
held bit for bit against their plain versions (``str_parse_reference``,
``str_format_reference``), which ``test_torch_cast_strings.py`` holds
against the JAX package. Two ways:

- the CUDA source itself, compiled by ``g++`` against the runtime
  emulation of ``test_torch_shuffle_kernel_model.py`` (each launch a call;
  3 blocks a grid-stride loop, so every thread walks several rows), plus
  the few intrinsics these kernels use;
- a numpy model of each kernel's per-row arithmetic as the source writes
  it: the magnitude's split into three 8-digit parts, the SWAR digits by
  reciprocal multiplies, the count of leading zeros, the decimal point's
  one-byte shift and the left-align shift of the words; the date's 32-bit
  formulas; the parse's class masks four bytes a step, the trims from the
  non-space mask (only where an end is a space), the shift of a trimmed
  row to byte 0, a token's shape from its first non-digits, and the
  double's one-pass chain (rows of up to 64 bytes: one mask word).

Inputs: the edge values of each grammar (int64 extremes, every power of
ten and its neighbours, decimals at scales 1, 2 and 18, the int32 day
extremes and the year clip points; spaces only, rows filling their width,
widths 8 to 128, a wider row on the byte loop, a broadcast row, a view
that is not 16-byte aligned) and 10^4 random values a kind, made from a
seed with numpy. Tolerance: exact."""
import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.expr.cast_kernels import (
    FORMAT_KINDS, FORMAT_WIDTH, PARSE_KINDS, POW10, _fma10,
    str_format_reference, str_parse_reference)
from test_torch_cast_kernels import (edge_strings, format_inputs, matrix,
                                     random_numeric_strings)
from test_torch_shuffle_kernel_model import _EMULATION

_SRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc" / "strings_cast.cu"


@functools.lru_cache(maxsize=None)
def _strings(n: int, seed: int) -> tuple:
    """random_numeric_strings, made once for every kind."""
    return tuple(random_numeric_strings(n, seed))

#: what these kernels use beyond the shuffle kernels' emulation
_INTRINSICS = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include "emul.h"
using std::max;
using std::min;
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >>
                               32);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return static_cast<unsigned>(
      ((static_cast<unsigned long long>(hi) << 32) | lo) >> (s & 31));
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

inline double __longlong_as_double(long long x) {
  return emu::from<double>(static_cast<unsigned long long>(x));
}
inline double __hiloint2double(int hi, int lo) {
  return emu::from<double>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
      static_cast<unsigned>(lo));
}
inline double __fma_rn(double a, double b, double c) {
  return std::fma(a, b, c);
}
inline double __dmul_rn(double a, double b) { return a * b; }
// every vector load and store: counted if its address is not aligned
inline long long emu_misaligned_count = 0;
template <class T> T* emu_aligned(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % alignof(T)) ++emu_misaligned_count;
  return static_cast<T*>(const_cast<void*>(p));
}
extern "C" long long emu_misaligned() { return emu_misaligned_count; }
"""

_LAUNCH = re.compile(r"([\w]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*(.*?),"
                     r"\s*(.*?)>>>\(", re.S)


def _emulated_source() -> str:
    """strings_cast.cu for g++: the emulation for the runtime, every launch
    a call, 3 blocks a grid, each vector access checked for alignment."""
    src = _SRC.read_text().replace("#include <cuda_runtime.h>",
                                   '#include "strings_emul.h"')
    subs = [(r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;", 1),
            (r"\*reinterpret_cast<((?:const )?uint[24])\*>\(",
             r"*emu_aligned<\1>(", 4)]
    for pat, rep, count in subs:
        src, n = re.subn(pat, rep, src)
        assert n == count, pat
    src, n = _LAUNCH.subn(r"emu_launch(\1, \2, \3, ", src)
    assert n == 7, "every launch of strings_cast.cu is rewritten"
    return src


def _build(tmp: Path) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "strings_emul.h").write_text(_INTRINSICS)
    (tmp / "strings.cpp").write_text(_emulated_source())
    so = tmp / "libstringsmodel.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                          "-fno-gnu-unique", "-fno-strict-aliasing",
                          "-ffp-contract=off", "-w", "-fPIC", "-o", str(so),
                          str(tmp / "strings.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_str_parse.argtypes = [ptr, i64, i32, ptr, i64, i32, ptr, ptr,
                                  ptr, ptr]
    lib.srt_str_format.argtypes = [ptr, i64, i32, i32, i32, ptr, ptr, ptr]
    lib.emu_launches.restype = i64
    lib.emu_misaligned.restype = i64
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("strings_model"))


_POW10 = torch.from_numpy(POW10)
_OUT = {"long": torch.int64, "double": torch.float64, "bool": torch.bool,
        "date": torch.int32}


def _model_parse(lib, data: torch.Tensor, lengths: torch.Tensor, kind: str):
    n = data.shape[0]
    out = torch.empty(n, dtype=_OUT[kind])
    ok = torch.empty(n, dtype=torch.bool)
    before = lib.emu_launches()
    assert lib.srt_str_parse(data.data_ptr(), data.stride(0), data.shape[1],
                             lengths.data_ptr(), n, PARSE_KINDS[kind],
                             _POW10.data_ptr(), out.data_ptr(),
                             ok.data_ptr(), None) == 0
    assert lib.emu_launches() == before + 1
    assert lib.emu_misaligned() == 0
    return out, ok


def _model_format(lib, values: torch.Tensor, kind: str, scale: int = 0,
                  width: int = 0):
    n, width = values.shape[0], width or FORMAT_WIDTH[kind]
    v = values.contiguous()
    out = torch.full((n, width), 0xA5, dtype=torch.uint8)
    lengths = torch.empty(n, dtype=torch.int32)
    assert lib.srt_str_format(v.data_ptr(), n, FORMAT_KINDS[kind], scale,
                              width, out.data_ptr(), lengths.data_ptr(),
                              None) == 0
    assert lib.emu_misaligned() == 0
    return out, lengths


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# the source through g++
# ---------------------------------------------------------------------------
_FORMATS = [("long", 0), ("decimal", 0), ("decimal", 1), ("decimal", 2),
            ("decimal", 7), ("decimal", 18), ("date", 0), ("bool", 0)]


@pytest.mark.parametrize("kind,scale", _FORMATS)
def test_format_source_equals_the_plain_version(lib, kind, scale):
    v = format_inputs(kind, np.random.default_rng(scale + 7), 10000)
    got, lens = _model_format(lib, v, kind, scale)
    want, wlens = str_format_reference(v, kind, scale)
    assert torch.equal(lens, wlens), kind
    assert torch.equal(got, want), kind


@pytest.mark.parametrize("width", [8, 16, 24])
def test_format_source_cuts_narrow_rows(lib, width):
    """A row narrower than its text keeps the text's first bytes (8-byte
    stores where the width is not a multiple of 16)."""
    v = format_inputs("long", np.random.default_rng(width), 500)
    got, lens = _model_format(lib, v, "long", 0, width)
    want, wlens = str_format_reference(v, "long")
    assert torch.equal(lens, wlens)
    assert torch.equal(got, want[:, :width])


@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
@pytest.mark.parametrize("width", [8, 16, 20, 24, 32, 64, 128, 136])
def test_parse_source_equals_the_plain_version(lib, kind, width):
    """Widths 8-128 in registers (16-byte vectors at 16, 32, 64, 128;
    8-byte ones at 8 and 24; bytes one by one at 20), 136 on the byte
    loop."""
    strs = edge_strings(width) + list(_strings(
        3000 if width in (16, 32) else 800, width))
    data, lens = matrix(strs, width, width)
    got, ok = _model_parse(lib, data, lens, kind)
    want, wok = str_parse_reference(data, lens, kind)
    assert torch.equal(ok, wok), kind
    assert _same(got, want), kind


@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
def test_parse_source_on_views(lib, kind):
    """A view one byte into its rows (no vector loads), one 8 bytes in (8-
    byte vectors), and a broadcast row (stride 0) of each edge string."""
    strs = edge_strings(32) + list(_strings(500, 3))
    big, lens = matrix(strs, 48, 11)
    for lo in (1, 8):
        view = big[:, lo:lo + 32]
        assert view.stride(0) == 48 and view.data_ptr() % 16 == lo % 16
        vlens = torch.clamp(lens - lo, 0, 32).to(torch.int32)
        got, ok = _model_parse(lib, view, vlens, kind)
        want, wok = str_parse_reference(view, vlens, kind)
        assert torch.equal(ok, wok) and _same(got, want), (kind, lo)
    for s in edge_strings(16)[::7]:
        row, ln = matrix([s], 16, 0)
        d = row.expand(40, -1)
        lens40 = ln.expand(40).contiguous()
        got, ok = _model_parse(lib, d, lens40, kind)
        want, wok = str_parse_reference(d, lens40, kind)
        assert torch.equal(ok, wok) and _same(got, want), (kind, s)


def test_the_entries_refuse_what_the_kernels_do_not_take(lib):
    buf = torch.zeros(64, dtype=torch.int64)
    p = buf.data_ptr()
    for width, scale, kind in ((12, 0, 0), (40, 0, 0), (0, 0, 0), (32, 19, 2),
                               (32, -1, 2), (32, 0, 4)):
        assert lib.srt_str_format(p, 4, kind, scale, width, p, p, None) != 0
    assert lib.srt_str_format(p, 0, 0, 0, 32, p, p, None) != 0
    for width, kind, stride in ((0, 0, 8), (8, 4, 8), (8, 0, -8)):
        assert lib.srt_str_parse(p, stride, width, p, 4, kind, p, p, p,
                                 None) != 0


# ---------------------------------------------------------------------------
# the numpy model of the arithmetic
# ---------------------------------------------------------------------------
_U32, _U64 = np.uint32, np.uint64
_ZEROS8 = _U64(0x3030303030303030)


def _u64(x) -> np.ndarray:
    return np.asarray(x).astype(_U64)


def np_digits8(x: np.ndarray) -> np.ndarray:
    """digits8: x / 10^4 by the 32-bit multiply-high (0xD1B71759, then 13
    bits), then / 100 and / 10 in 32- and 16-bit lanes of one word."""
    x = _u64(x)
    hi = (x * _U64(0xD1B71759)) >> _U64(45)
    v = hi | ((x - hi * _U64(10000)) << _U64(32))
    q2 = ((v * _U64(5243)) >> _U64(19)) & _U64(0x0000007F0000007F)
    v = q2 | ((v - q2 * _U64(100)) << _U64(16))
    q1 = ((v * _U64(103)) >> _U64(10)) & _U64(0x000F000F000F000F)
    v = q1 | ((v - q1 * _U64(10)) << _U64(8))
    return v | _ZEROS8


def np_shift_down(w: np.ndarray, k: np.ndarray) -> np.ndarray:
    """shift_down: each row's words moved k bytes toward byte 0, whole
    words by 1, 2, 4 (selects), then 0-3 bytes (funnel shifts)."""
    w = w.astype(_U32).copy()
    n_words = w.shape[1]
    q = (k >> 2)[:, None]
    s = 1
    while s < n_words:
        moved = np.zeros_like(w)
        moved[:, :n_words - s] = w[:, s:]
        w = np.where((q & s) != 0, moved, w)
        s <<= 1
    r = _u64(8 * (k & 3))[:, None]
    hi = np.zeros_like(w)
    hi[:, :-1] = w[:, 1:]
    return (((_u64(hi) << _U64(32)) | _u64(w)) >> r).astype(_U32)


def _words(*u64s) -> np.ndarray:
    """uint64 columns -> (n, 8) little-endian uint32 words."""
    w = np.zeros((len(u64s[0]), 8), dtype=_U32)
    for i, d in enumerate(u64s):
        w[:, 2 * i] = (d & _U64(0xFFFFFFFF)).astype(_U32)
        w[:, 2 * i + 1] = (d >> _U64(32)).astype(_U32)
    return w


def np_format_number(v: np.ndarray, scale: int):
    """format_number -> ((n, 32) bytes, lengths)."""
    neg = v < 0
    mag = np.where(neg, _U64(0) - v.view(_U64), v.view(_U64))
    hi8 = mag // _U64(10**8)
    c = mag - hi8 * _U64(10**8)
    a = hi8 // _U64(10**8)
    b = hi8 - a * _U64(10**8)
    d = [np_digits8(x) for x in (a, b, c)]
    lead = np.full(len(v), 24)
    for i in (2, 1, 0):                 # the first word with a digit wins
        x = d[i] ^ _ZEROS8
        low = x & (~x + _U64(1))        # its lowest set bit
        byte = np.log2(np.maximum(low, 1).astype(np.float64)).astype(int) >> 3
        lead = np.where(x != 0, 8 * i + byte, lead)
    nd = np.maximum(24 - lead, scale + 1)
    w = _words(*d)
    point = 1 if scale > 0 else 0
    if point:
        s = np_shift_down(w, np.ones(len(v), dtype=np.int64))
        at = 23 - scale
        for i in range(6):
            k = at - 4 * i
            below = 0 if k <= 0 else (0xFFFFFFFF if k >= 4
                                      else (1 << (8 * k)) - 1)
            dot = 0xFF << (8 * k) if 0 <= k < 4 else 0
            w[:, i] = (s[:, i] & _U32(below)) | _U32(dot & 0x2E2E2E2E) \
                | (w[:, i] & _U32(~(below | dot) & 0xFFFFFFFF))
    w = np_shift_down(w, 24 - nd - point - neg.astype(np.int64))
    w[:, 0] = np.where(neg, (w[:, 0] & _U32(0xFFFFFF00)) | _U32(ord("-")),
                       w[:, 0])
    return w.view(np.uint8).reshape(-1, 32), (nd + point + neg).astype(
        np.int32)


def np_format_date(days: np.ndarray):
    """format_date: the era by one 64-bit division of the days moved past
    zero, the rest in 32-bit integers (wrapping, as on the card)."""
    eras_k = 14700
    u = (days.astype(np.int64) + 719468 + eras_k * 146097).astype(_U64)
    eras = u // _U64(146097)
    doe = (u - eras * _U64(146097)).astype(_U32)
    era = eras.astype(np.int32) - np.int32(eras_k)
    yoe = (doe - doe // _U32(1460) + doe // _U32(36524)
           - doe // _U32(146096)) // _U32(365)
    doy = doe - (_U32(365) * yoe + yoe // _U32(4) - yoe // _U32(100))
    mp = (_U32(5) * doy + _U32(2)) // _U32(153)
    d = doy - (_U32(153) * mp + _U32(2)) // _U32(5) + _U32(1)
    m = np.where(mp < 10, mp + _U32(3), mp - _U32(9)).astype(_U32)
    y = yoe.astype(np.int32) + era * np.int32(400) + (m <= 2).astype(
        np.int32)
    y = np.clip(y, 0, 9999).astype(_U32)
    yh = y // _U32(100)
    v = yh | ((y - yh * _U32(100)) << _U32(16))
    q = ((v * _U32(103)) >> _U32(10)) & _U32(0x000F000F)
    v = q | ((v - q * _U32(10)) << _U32(8))
    mt, dt = (m * _U32(103)) >> _U32(10), (d * _U32(103)) >> _U32(10)
    w = np.zeros((len(days), 8), dtype=_U32)
    w[:, 0] = v | _U32(0x30303030)
    w[:, 1] = _U32(0x2D00002D) | ((mt + _U32(48)) << _U32(8)) \
        | ((m - _U32(10) * mt + _U32(48)) << _U32(16))
    w[:, 2] = (dt + _U32(48)) | ((d - _U32(10) * dt + _U32(48)) << _U32(8))
    return w.view(np.uint8).reshape(-1, 32), np.full(len(days), 10,
                                                     dtype=np.int32)


@pytest.mark.parametrize("kind,scale", _FORMATS[:-1])
def test_format_arithmetic_model(kind, scale):
    v = format_inputs(kind, np.random.default_rng(scale + 70), 10000)
    fn = np_format_date if kind == "date" else \
        (lambda x: np_format_number(x, scale))
    got, lens = fn(v.numpy())
    want, wlens = str_format_reference(v, kind, scale)
    assert np.array_equal(lens, wlens.numpy()), kind
    assert np.array_equal(got[:, :FORMAT_WIDTH[kind]], want.numpy()), kind


def np_nib(hi: np.ndarray) -> np.ndarray:
    """The high bits of a class word's bytes as bits 0-3 (a 32-bit
    multiply, wrapping)."""
    return ((hi >> _U32(7)) * _U32(0x10204080)) >> _U32(28)


def np_eq(x, c: int):
    t = x ^ _U32(c)
    return ~(((t & _U32(0x7F7F7F7F)) + _U32(0x7F7F7F7F)) | t) \
        & _U32(0x80808080)


def np_digit(x):
    t = x ^ _U32(0x30303030)
    return ~(((t & _U32(0x7F7F7F7F)) + _U32(0x76767676)) | t) \
        & _U32(0x80808080)


def np_space(x):
    lo = x & _U32(0x7F7F7F7F)
    ge9 = (lo + _U32(0x77777777)) | x
    ge14 = (lo + _U32(0x72727272)) | x
    return (ge9 & ~ge14 & _U32(0x80808080)) | np_eq(x, 0x20202020)


def np_bits(w: np.ndarray, n_bytes: np.ndarray, cls) -> np.ndarray:
    """A class as one uint64 bit mask a row (rows of up to 64 bytes),
    bytes [0, n_bytes)."""
    m = np.zeros(w.shape[0], dtype=_U64)
    for i in range(w.shape[1]):
        m |= _u64(np_nib(cls(w[:, i]))) << _U64(4 * i)
    return m & np_range(0, n_bytes)


def np_range(lo, hi) -> np.ndarray:
    """Bits [lo, hi) of a uint64, each end clipped to [0, 64]."""
    def low(k):
        k = np.clip(np.asarray(k, dtype=np.int64), 0, 64)
        return np.where(k >= 64, _U64(0xFFFFFFFFFFFFFFFF),
                        (_U64(1) << _u64(np.minimum(k, 63))) - _U64(1))
    return low(hi) & ~low(lo)


def np_first(m: np.ndarray, none) -> np.ndarray:
    low = m & (~m + _U64(1))
    pos = np.log2(np.maximum(low, 1).astype(np.float64)).astype(np.int64)
    return np.where(m != 0, pos, none)


def np_last(m: np.ndarray) -> np.ndarray:
    """The highest set bit, or -1 (exact: each step halves the word)."""
    pos = np.full(m.shape, -1, dtype=np.int64)
    x = m.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        up = x >> _U64(shift)
        pos = np.where(up != 0, pos + shift, pos)
        x = np.where(up != 0, up, x)
    return np.where(m != 0, pos + 1, -1)


def _bit(m, j):
    return ((m >> _u64(np.clip(j, 0, 63))) & _U64(1)).astype(bool) & (j < 64)


def np_trim(data: np.ndarray, lengths: np.ndarray):
    """The row in words, trimmed: the class masks only where an end is a
    space, then the row shifted down to its start -> (words, token
    length)."""
    n, width = data.shape
    pad = -width % 16
    w = np.ascontiguousarray(np.pad(data, ((0, 0), (0, pad)))).view(_U32)
    ln = np.clip(lengths.astype(np.int64), 0, width)
    rows = np.arange(n)
    first = data[:, 0] if width else np.zeros(n, np.uint8)
    last = data[rows, np.maximum(ln - 1, 0)]
    spaced = (ln > 0) & (np.isin(first, _SPACE) | np.isin(last, _SPACE))
    content = np_range(0, ln) & ~np_bits(w, ln, np_space)
    start = np.where(spaced, np_first(content, 0), 0)
    tl = np.where(spaced, np_last(content) + 1 - start, ln)
    return np_shift_down(w, start), tl


_SPACE = np.array([9, 10, 11, 12, 13, 32], dtype=np.uint8)


def _byte(w: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Byte j of each row (j clipped into the row)."""
    b = w.view(np.uint8)
    return b[np.arange(len(b)), np.clip(j, 0, b.shape[1] - 1)].astype(
        np.int64)


def _chain(w, lo, hi, float_only=False):
    """The digits in [lo, hi) of each row, left to right, into a wrapping
    uint64 and a float64 of fused multiply-adds (exact, ``_fma10``)."""
    n, width = w.shape[0], 4 * w.shape[1]
    acc = np.zeros(n, dtype=_U64)
    facc = torch.zeros(n, dtype=torch.float64)
    for j in range(width):
        pick = (j >= lo) & (j < hi)
        if not pick.any():
            continue
        d = _byte(w, np.full(n, j)) - ord("0")
        if not float_only:
            acc = np.where(pick, acc * _U64(10) + _u64(np.maximum(d, 0)),
                           acc)
        fd = torch.from_numpy(d.astype(np.float64))
        facc = torch.where(torch.from_numpy(pick), _fma10(facc, fd), facc)
    return acc, facc


def _one(j) -> np.ndarray:
    """The bit of position j (none past 63)."""
    return np.where(j < 64, _U64(1) << _u64(np.clip(j, 0, 63)), _U64(0))


def np_parse_long(data, lengths):
    """parse_long: the token is well formed when its first non-digit past
    the sign is its only one and a point."""
    w, tl = np_trim(data, lengths)
    c0 = _byte(w, np.zeros(len(tl), np.int64))
    neg = c0 == ord("-")
    ds = (neg | (c0 == ord("+"))).astype(np.int64)
    other = np_range(ds, tl) & ~np_bits(w, tl, np_digit)
    p = np_first(other, tl)
    valid = (tl > 0) & ((p == tl) | ((_byte(w, p) == ord("."))
                                     & ((other & ~_one(p)) == 0)))
    acc, facc = _chain(w, np.where(valid, ds, 0), np.where(valid, p, 0))
    limit = np.where(neg, _U64(2**63), _U64(2**63 - 1))
    ok = valid & (p > ds) & (facc.numpy() <= 9.3e18) & (acc <= limit)
    val = np.where(neg, _U64(0) - acc, acc).view(np.int64)
    return np.where(ok, val, 0), ok


def np_parse_double(data, lengths):
    """parse_double: the shape from the first three non-digits past the
    sign ([.] [e [sign]], and no more), then one chain through the
    mantissa and the fraction that hands its value to the mantissa at the
    point and starts again from 0.0, and the exponent's own chain."""
    from spark_rapids_tpu_torch.expr.cast_kernels import _fma, _pow10
    w, tl = np_trim(data, lengths)
    n = len(tl)
    c0 = _byte(w, np.zeros(n, np.int64))
    neg = c0 == ord("-")
    sign = neg | (c0 == ord("+"))
    ds = sign.astype(np.int64)
    sh = _u64(8 * ds)
    t0 = ((((_u64(w[:, 1]) << _U64(32)) | _u64(w[:, 0])) >> sh)
          & _U64(0xFFFFFFFF)) | _U64(0x20202020)
    t1 = ((((_u64(w[:, 2]) << _U64(32)) | _u64(w[:, 1])) >> sh)
          & _U64(0xFFFFFFFF)) | _U64(0x20202020)
    tn = tl - ds
    is_inf = ((tn == 8) & (t0 == 0x69666E69) & (t1 == 0x7974696E)) \
        | ((tn == 3) & ((t0 & _U64(0xFFFFFF)) == 0x666E69))
    is_nan = ~sign & (tn == 3) & ((t0 & _U64(0xFFFFFF)) == 0x6E616E)
    other = np_range(ds, tl) & ~np_bits(w, tl, np_digit)
    o, b = [], []
    for _ in range(3):
        o.append(np_first(other, tl))
        b.append(_byte(w, o[-1]))
        other &= ~_one(o[-1])
    k1 = (o[0] < tl) & (b[0] == ord("."))
    at, c = np.where(k1, o[1], o[0]), np.where(k1, b[1], b[0])
    nxt, cn = np.where(k1, o[2], o[1]), np.where(k1, b[2], b[1])
    after = np.where(k1, tl, o[2])
    has_e = at < tl
    e_pos = np.where(has_e, at, tl)
    e_sign = has_e & (nxt == at + 1) & (nxt < tl) \
        & ((cn == ord("-")) | (cn == ord("+")))
    e_neg = e_sign & (cn == ord("-"))
    shape = (other == 0) & (~has_e | (((c | 0x20) == ord("e"))
                                      & np.where(e_sign, after == tl,
                                                 nxt == tl)))
    p = np.where(k1, o[0], e_pos)
    e_ds = e_pos + 1 + e_sign
    fcnt = np.where(p < e_pos, e_pos - p - 1, 0)
    valid = (tl > 0) & shape & ((p - ds) + fcnt > 0) & (~has_e | (tl > e_ds))
    # the one-pass chain over [0, e_pos)
    acc = torch.zeros(n, dtype=torch.float64)
    mant = torch.zeros(n, dtype=torch.float64)
    for j in range(4 * w.shape[1]):
        live = torch.from_numpy(valid & (j < e_pos))
        if not live.any():
            continue
        d = torch.from_numpy((_byte(w, np.full(n, j)) - ord("0")).astype(
            np.float64))
        nxt_acc = _fma10(acc, d)
        at_p = torch.from_numpy(j == p) & live
        mant = torch.where(at_p, acc, mant)
        acc = torch.where(at_p, 0.0, torch.where(
            live & torch.from_numpy(j >= ds), nxt_acc, acc))
    has_p = torch.from_numpy(p < e_pos)
    frac = torch.where(has_p, acc, 0.0)
    mant = torch.where(has_p, mant, acc)
    _, expv = _chain(w, np.where(valid, e_ds, 0), np.where(valid, tl, 0),
                     True)
    expo = torch.where(torch.from_numpy(e_neg), -expv, expv)
    v = _fma(frac, _pow10(-torch.from_numpy(fcnt).to(torch.float64)), mant) \
        * _pow10(expo)
    v = torch.where(v.abs() < 2.2250738585072014e-308, 0.0, v)
    v = torch.where(torch.from_numpy(neg), -v, v).numpy()
    v = np.where(is_inf, np.where(neg, -np.inf, np.inf), v)
    v = np.where(is_nan, np.nan, v)
    ok = valid | is_inf | is_nan
    return np.where(ok, v, 0.0), ok


def np_parse_bool(data, lengths):
    w, tl = np_trim(data, lengths)
    t0 = w[:, 0] | _U32(0x20202020)
    b0 = w[:, 0] & _U32(0xFF)
    l0 = b0 | _U32(0x20)
    one = tl == 1
    t = (one & ((b0 == ord("1")) | (l0 == ord("t")) | (l0 == ord("y")))) \
        | ((tl == 3) & ((t0 & _U32(0xFFFFFF)) == 0x736579)) \
        | ((tl == 4) & (t0 == 0x65757274))
    f = (one & ((b0 == ord("0")) | (l0 == ord("f")) | (l0 == ord("n")))) \
        | ((tl == 2) & ((t0 & _U32(0xFFFF)) == 0x6F6E)) \
        | ((tl == 5) & (t0 == 0x736C6166)
           & (((w[:, 1] | _U32(0x20)) & _U32(0xFF)) == 0x65))
    return t, t | f


def np_parse_date(data, lengths):
    from spark_rapids_tpu_torch.expr.cast_kernels import _days_from_civil
    w, tl = np_trim(data, lengths)
    tok = np_range(0, tl)
    dash = np_bits(w, tl, lambda x: np_eq(x, 0x2D2D2D2D)) & tok
    ndash = np.array([bin(int(x)).count("1") for x in dash])
    d1 = np_first(dash, tl)
    one1 = np.where(d1 < 64, _U64(1) << _u64(np.minimum(d1, 63)), _U64(0))
    d2 = np_first(dash & ~one1, tl)
    one2 = np.where(d2 < 64, _U64(1) << _u64(np.minimum(d2, 63)), _U64(0))
    classified = (tok & ~(np_bits(w, tl, np_digit) | one1 | one2)) == 0
    mcnt, dcnt = d2 - d1 - 1, tl - d2 - 1
    shape = (tl > 0) & (tl <= 10) & classified & (ndash <= 2) & (d1 == 4) \
        & ((ndash < 1) | ((mcnt >= 1) & (mcnt <= 2))) \
        & ((ndash < 2) | ((dcnt >= 1) & (dcnt <= 2)))

    def dig(j):
        return _byte(w, j) - ord("0")
    z = np.zeros(len(tl), np.int64)
    y = dig(z) * 1000 + dig(z + 1) * 100 + dig(z + 2) * 10 + dig(z + 3)
    m = np.where(mcnt == 2, 10 * dig(d1 + 1) + dig(d1 + 2), dig(d1 + 1))
    m = np.where(ndash >= 1, m, 1)
    d = np.where(dcnt == 2, 10 * dig(d2 + 1) + dig(d2 + 2), dig(d2 + 1))
    d = np.where(ndash >= 2, d, 1)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    dim = np.where(m == 2, np.where(leap, 29, 28), 30 + ((m ^ (m >> 3)) & 1))
    ok = shape & (y >= 1) & (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim)
    days = _days_from_civil(*(torch.from_numpy(np.where(ok, x, 1))
                              for x in (y, m, d))).numpy()
    return np.where(ok, days, 0).astype(np.int32), ok


_NP_PARSE = {"long": np_parse_long, "double": np_parse_double,
             "bool": np_parse_bool, "date": np_parse_date}


@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
def test_parse_arithmetic_model(kind):
    """Widths 16, 32 and 64 (one mask word), the edge strings and 10^4
    random ones a kind."""
    for width, count in ((16, 4000), (32, 5000), (64, 1000)):
        data, lens = matrix(edge_strings(width)
                            + list(_strings(count, width + 50)),
                            width, width + 50)
        got, ok = _NP_PARSE[kind](data.numpy(), lens.numpy())
        want, wok = str_parse_reference(data, lens, kind)
        assert np.array_equal(ok, wok.numpy()), (kind, width)
        assert np.array_equal(np.asarray(got).view(np.uint8),
                              want.numpy().view(np.uint8)), (kind, width)
