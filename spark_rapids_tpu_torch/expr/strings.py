"""String functions — the port of ``spark_rapids_tpu/expr/strings.py``
(reference: stringFunctions.scala): case mapping, lengths, substring,
substring_index, the predicates, locate, concat, concat_ws, pads, repeat,
trims, replace, LIKE, RLIKE, regexp_extract, regexp_replace, chr, ascii and
get_json_object.

Device strings are fixed-width padded uint8 matrices ``(capacity, width)``
plus int32 byte ``lengths`` (columnar/device.py). Most device ops here are a
handful of whole-matrix torch ops:

- character-aware ops (length, substring, reverse, locate) derive a
  per-byte *character index* from the UTF-8 continuation-bit mask
  ``(b & 0xC0) != 0x80`` — exact for all of UTF-8;
- variable-length outputs (substring, trim) are produced by *stable
  left-compaction*: select the surviving bytes, stable-argsort the
  inverted selection per row, gather; concat and pads by an index-select
  merge;
- search ops compare shifted copies of the matrix against a literal
  pattern.

The loops run as hand-written kernels: LIKE past equality, prefix, suffix
and contains, and RLIKE, on ``nfa_match`` (expr/regex.py); replace,
regexp_replace and regexp_extract on ``regex_replace`` and ``regex_extract``
(Java's find() loop, one thread a row); substring_index's delimiter scan on
``delim_select`` (expr/regex_kernels.py).

Case mapping and the pads are ASCII-exact on the device (the rules carry a
ps-note), as in the JAX package; the host engine is full Unicode. Where the
JAX device path leaves Spark on a local point, the port follows Spark:
``ascii`` gives the first character's code point, ``locate`` reads its
start and gives its answer in characters (a start of 0 gives 0), and RLIKE
takes the empty match at the end of a row (a nullable pattern anchored at
the end and not at the start matches every row), as Java's find() does.

The host engine evaluates the same expressions with Python strings.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from ..columnar import dtypes as dt
from ..columnar.device import bucket_width
from .arithmetic import _combine_validity
from .base import Alias, EvalCol, EvalContext, Expression, Literal

__all__ = [
    "Upper", "Lower", "Length", "OctetLength", "BitLength", "Substring",
    "StartsWith", "EndsWith", "Contains", "StringLocate", "Concat",
    "ConcatWs", "StringTrim", "StringTrimLeft", "StringTrimRight",
    "StringLpad", "StringRpad", "StringRepeat", "StringReplace",
    "SubstringIndex", "StringReverse", "InitCap", "Ascii", "Chr",
    "Like", "RLike", "RegExpExtract", "RegExpReplace", "GetJsonObject",
    "literal_value", "UnaryString"]


# ---------------------------------------------------------------------------
# device helpers (torch)
# ---------------------------------------------------------------------------

def _pos_mask(w: int, lengths: torch.Tensor) -> torch.Tensor:
    """(n, w) bool — byte position is inside the string."""
    return torch.arange(w, dtype=torch.int32,
                        device=lengths.device)[None, :] < lengths[:, None]


def _char_starts(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(n, w) bool — byte begins a UTF-8 character and is inside the
    string."""
    return ((vals & 0xC0) != 0x80) & _pos_mask(vals.shape[1], lengths)


def _stable_argsort(a: torch.Tensor) -> torch.Tensor:
    """Stable per-row argsort of a bool or small-int matrix."""
    return torch.argsort(a.to(torch.int8), dim=1, stable=True)


def _compact(vals: torch.Tensor, sel: torch.Tensor):
    """Stable left-compaction of selected bytes. Returns (data, lengths)."""
    order = _stable_argsort(~sel)
    data = torch.take_along_dim(vals, order, dim=1)
    lengths = sel.sum(dim=1, dtype=torch.int32)
    data = torch.where(_pos_mask(vals.shape[1], lengths), data, 0)
    return data.to(torch.uint8), lengths


def _zero_tail(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.where(_pos_mask(vals.shape[1], lengths), vals,
                       0).to(vals.dtype)


def _pad_to(m: torch.Tensor, w: int) -> torch.Tensor:
    if m.shape[1] >= w:
        return m
    return F.pad(m, (0, w - m.shape[1]))


def literal_value(e: Expression):
    """The python value if ``e`` is a (possibly aliased) literal, else
    None."""
    while isinstance(e, Alias):
        e = e.child
    if isinstance(e, Literal):
        return e.value
    return None


def _pattern_bytes(nb: bytes, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(nb, dtype=np.uint8).copy()) \
        .to(device)


# ---------------------------------------------------------------------------
# substring
# ---------------------------------------------------------------------------

class Substring(Expression):
    """substring(str, pos, len) — Spark 1-based, negative pos from the end.

    Device path is UTF-8 character-exact: a byte is selected iff its
    character index falls in [start, start+len); survivors stable-compact
    left.
    """

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        self.child, self.pos, self.length = child, pos, length
        self.children = (child, pos, length)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        p = self.pos.eval(ctx)
        l = self.length.eval(ctx)  # noqa: E741
        validity = _combine_validity(ctx, c, p, l)
        if not ctx.is_device:
            out = [_host_substr(s, int(pos), int(ln))
                   for s, pos, ln in zip(c.values, p.values, l.values)]
            return EvalCol(np.asarray(out, dtype=object), validity,
                           dt.STRING)
        v, lengths = c.values, c.lengths
        w = v.shape[1]
        starts = _char_starts(v, lengths)
        cidx = torch.cumsum(starts.to(torch.int32), dim=1) - 1
        nchars = starts.sum(dim=1, dtype=torch.int32)
        pos = p.values.to(torch.int32)
        ln = torch.clamp(l.values.to(torch.int32), min=0)
        # 0-based start char: pos>0 -> pos-1; pos==0 -> 0; pos<0 -> n+pos
        start0 = torch.where(pos > 0, pos - 1,
                             torch.where(pos == 0, 0, nchars + pos))
        # a negative start before the beginning shortens the result
        ln = torch.where(start0 < 0, torch.clamp(ln + start0, min=0), ln)
        start0 = torch.clamp(start0, min=0)
        sel = (cidx >= start0[:, None]) & (cidx < (start0 + ln)[:, None])
        sel = sel & _pos_mask(w, lengths)
        data, out_len = _compact(v, sel)
        return EvalCol(data, validity, dt.STRING, out_len)


def _host_substr(s: str, pos: int, ln: int) -> str:
    if ln <= 0:
        return ""
    n = len(s)
    start = pos - 1 if pos > 0 else (0 if pos == 0 else n + pos)
    if start < 0:
        ln = max(ln + start, 0)
        start = 0
    return s[start:start + ln]


# ---------------------------------------------------------------------------
# startswith / endswith / contains
# ---------------------------------------------------------------------------

class BinaryStringPredicate(Expression):
    """Base for startswith/endswith/contains: boolean, null-propagating."""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalCol:
        l = self.left.eval(ctx)  # noqa: E741
        r = self.right.eval(ctx)
        validity = _combine_validity(ctx, l, r)
        if not ctx.is_device:
            vals = np.asarray([self._host_one(a, b)
                               for a, b in zip(l.values, r.values)],
                              dtype=bool)
            return EvalCol(vals, validity, dt.BOOLEAN)
        return EvalCol(self._eval_device(l, r), validity, dt.BOOLEAN)

    def _host_one(self, a: str, b: str) -> bool:
        raise NotImplementedError

    def _eval_device(self, l: EvalCol, r: EvalCol) -> torch.Tensor:
        raise NotImplementedError


class StartsWith(BinaryStringPredicate):
    def _host_one(self, a, b):
        return a.startswith(b)

    def _eval_device(self, l, r):
        w = max(l.values.shape[1], r.values.shape[1])
        lv = _pad_to(l.values, w)
        rv = _pad_to(r.values, w)
        match = (lv == rv) | ~_pos_mask(w, r.lengths)
        return match.all(dim=1) & (l.lengths >= r.lengths)


class EndsWith(BinaryStringPredicate):
    def _host_one(self, a, b):
        return a.endswith(b)

    def _eval_device(self, l, r):
        w = max(l.values.shape[1], r.values.shape[1])
        lv = _pad_to(l.values, w)
        rv = _pad_to(r.values, w)
        shift = (l.lengths - r.lengths)[:, None]
        idx = torch.arange(w, dtype=torch.int32,
                           device=lv.device)[None, :] + shift
        tail = torch.take_along_dim(lv, torch.clamp(idx, 0, w - 1).long(),
                                    dim=1)
        match = (tail == rv) | ~_pos_mask(w, r.lengths)
        return match.all(dim=1) & (l.lengths >= r.lengths)


def _device_find(l: EvalCol, pattern: bytes) -> torch.Tensor:
    """First byte offset of literal ``pattern`` in each row, -1 if
    absent."""
    return _device_find_from(l, pattern, 0)


class Contains(BinaryStringPredicate):
    """contains — the device requires a literal pattern (reference:
    GpuContains); tagging sends the rest to the host engine."""

    def _host_one(self, a, b):
        return b in a

    def _eval_device(self, l, r):
        pat = literal_value(self.right)
        if pat is None:
            raise ValueError("device contains requires a literal pattern")
        return _device_find(l, pat.encode()) >= 0


def _device_find_from(l: EvalCol, pattern: bytes, from_byte) -> torch.Tensor:
    """First byte offset of a non-empty literal ``pattern`` at or past
    ``from_byte`` (an int, or a tensor of one a row) in each row, -1 if
    absent."""
    v, lengths = l.values, l.lengths
    n, w = v.shape
    p = len(pattern)
    if p > w:
        return torch.full((n,), -1, dtype=torch.int32, device=v.device)
    pat = pattern
    hit = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    for k in range(p):
        shifted = _pad_to(v[:, k:], w) if k else v
        hit = hit & (shifted == pat[k])
    pos = torch.arange(w, dtype=torch.int32, device=v.device)[None, :]
    if isinstance(from_byte, torch.Tensor):
        from_byte = from_byte[:, None]
    hit = hit & (pos <= (lengths - p)[:, None]) & (pos >= from_byte)
    any_hit = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int8), dim=1).to(torch.int32)
    return torch.where(any_hit, first, -1)


def _device_startswith(c: EvalCol, nb: bytes) -> torch.Tensor:
    n, w = c.values.shape
    if len(nb) > w:
        return torch.zeros(n, dtype=torch.bool, device=c.values.device)
    pat = _pattern_bytes(nb, c.values.device)
    head = c.values[:, :len(nb)]
    return (head == pat[None, :]).all(dim=1) & (c.lengths >= len(nb))


def _device_endswith(c: EvalCol, nb: bytes) -> torch.Tensor:
    n, w = c.values.shape
    dev = c.values.device
    if len(nb) == 0:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if len(nb) > w:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    pat = _pattern_bytes(nb, dev)
    j = torch.arange(len(nb), dtype=torch.int32, device=dev)[None, :]
    idx = torch.clamp((c.lengths - len(nb))[:, None] + j, 0, w - 1)
    tail = torch.take_along_dim(c.values, idx.long(), dim=1)
    return (tail == pat[None, :]).all(dim=1) & (c.lengths >= len(nb))


# ---------------------------------------------------------------------------
# LIKE
# ---------------------------------------------------------------------------

class Like(Expression):
    """LIKE with a literal pattern (reference: GpuLike requires one too).

    Simple patterns (equality / prefix / suffix / contains, no ``_``) lower
    to the search ops above; everything else compiles to the regex NFA
    (expr/regex.py) and runs on the ``nfa_match`` kernel, or is tagged to
    the host engine when outside the NFA subset. ``%`` and ``_`` match every
    character, line terminators included (Spark's semantics, on both
    paths).
    """

    def __init__(self, child: Expression, pattern: Expression,
                 escape: str = "\\"):
        self.child, self.pattern, self.escape = child, pattern, escape
        self.children = (child, pattern)
        self._nfa = None

    def with_children(self, children):
        return Like(children[0], children[1], self.escape)

    @property
    def data_type(self):
        return dt.BOOLEAN

    def runs_kernel(self) -> bool:
        # a pattern past the four search ops runs on nfa_match
        return self.simple_kind() is None

    # -- pattern analysis (used by tagging AND execution) --------------------
    def simple_kind(self):
        """('equals'|'prefix'|'suffix'|'contains', needle) or None."""
        pat = literal_value(self.pattern)
        if pat is None:
            return None
        body = pat
        lead = body.startswith("%")
        trail = body.endswith("%") and not body.endswith(self.escape + "%")
        core = body[1 if lead else 0: len(body) - 1 if trail else len(body)]
        # no remaining wildcards/escapes allowed in the core
        if any(ch in core for ch in ("%", "_", self.escape)):
            return None
        if lead and trail:
            return ("contains", core)
        if lead:
            return ("suffix", core)
        if trail:
            return ("prefix", core)
        return ("equals", core)

    def to_regex(self):
        """The pattern as an anchored regex; ``%`` -> ``.*``, ``_`` -> ``.``
        (compile it so that ``.`` matches line terminators)."""
        pat = literal_value(self.pattern)
        if pat is None:
            return None
        out = []
        i = 0
        while i < len(pat):
            ch = pat[i]
            if ch == self.escape and i + 1 < len(pat):
                out.append(re.escape(pat[i + 1]))
                i += 2
                continue
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(re.escape(ch))
            i += 1
        return "^" + "".join(out) + "$"

    def device_nfa(self):
        """The compiled device NFA (``.`` = every character), or None when
        the pattern is outside its subset."""
        if self._nfa is None:
            from .regex import compile_device_nfa
            self._nfa = compile_device_nfa(self.to_regex(), dotall=True)
        return self._nfa

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            # fullmatch: "$" must not stop before a trailing newline
            rx = re.compile(self.to_regex(), re.DOTALL)
            vals = np.asarray([rx.fullmatch(s) is not None
                               for s in c.values], dtype=bool)
            return EvalCol(vals, c.validity, dt.BOOLEAN)
        kind = self.simple_kind()
        if kind is not None:
            op, needle = kind
            nb = needle.encode()
            if op == "contains":
                vals = _device_find(c, nb) >= 0
            elif op == "prefix":
                vals = _device_startswith(c, nb)
            elif op == "suffix":
                vals = _device_endswith(c, nb)
            else:  # equals
                vals = _device_startswith(c, nb) & (c.lengths == len(nb))
            return EvalCol(vals, c.validity, dt.BOOLEAN)
        nfa = self.device_nfa()
        if nfa is None:
            raise ValueError(f"device LIKE on pattern "
                             f"{literal_value(self.pattern)!r} outside the "
                             "device regex subset")
        return EvalCol(nfa.matches(ctx, c), c.validity, dt.BOOLEAN)


def _utf8_len(s) -> int:
    return len(s.encode() if isinstance(s, str) else s)


def _host_strings(values, fn) -> np.ndarray:
    return np.asarray([fn(s) for s in values], dtype=object)


# ---------------------------------------------------------------------------
# unary string ops
# ---------------------------------------------------------------------------

class UnaryString(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.STRING

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if ctx.is_device:
            return self._eval_device(c)
        return EvalCol(_host_strings(c.values, self._host_one), c.validity,
                       self.data_type)

    def _host_one(self, s: str):
        raise NotImplementedError

    def _eval_device(self, c: EvalCol) -> EvalCol:
        raise NotImplementedError


def _ascii_lower(v: torch.Tensor) -> torch.Tensor:
    return torch.where((v >= 65) & (v <= 90), v + 32, v)


class Upper(UnaryString):
    """upper() — the device path is ASCII-only (ps-note), the host engine
    full Unicode."""

    def _host_one(self, s):
        return s.upper()

    def _eval_device(self, c):
        v = c.values
        return EvalCol(torch.where((v >= 97) & (v <= 122), v - 32, v),
                       c.validity, dt.STRING, c.lengths)


class Lower(UnaryString):
    def _host_one(self, s):
        return s.lower()

    def _eval_device(self, c):
        return EvalCol(_ascii_lower(c.values), c.validity, dt.STRING,
                       c.lengths)


class InitCap(UnaryString):
    """initcap() — the device is ASCII-only; a word starts after a space
    (Spark's semantics)."""

    def _host_one(self, s):
        return " ".join(w[:1].upper() + w[1:].lower() for w in s.split(" "))

    def _eval_device(self, c):
        lo = _ascii_lower(c.values)
        prev = torch.cat([torch.full((lo.shape[0], 1), 32, dtype=lo.dtype,
                                     device=lo.device), lo[:, :-1]], dim=1)
        up = torch.where((lo >= 97) & (lo <= 122) & (prev == 32), lo - 32, lo)
        return EvalCol(up, c.validity, dt.STRING, c.lengths)


class StringReverse(UnaryString):
    """reverse() — UTF-8 character-exact on the device: bytes are
    re-ordered by (reversed character index, byte offset within the
    character)."""

    def _host_one(self, s):
        return s[::-1]

    def _eval_device(self, c):
        v, lengths = c.values, c.lengths
        w = v.shape[1]
        pos = torch.arange(w, dtype=torch.int64, device=v.device)[None, :]
        starts = _char_starts(v, lengths)
        cidx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
        nchars = starts.sum(dim=1)
        # byte offset of the character this byte belongs to
        start_pos = torch.cummax(torch.where(starts, pos, -1), dim=1).values
        key = torch.where(_pos_mask(w, lengths),
                          (nchars[:, None] - 1 - cidx) * w + (pos - start_pos),
                          2 * w * w)
        order = torch.argsort(key, dim=1, stable=True)
        data = torch.take_along_dim(v, order, dim=1)
        return EvalCol(_zero_tail(data, lengths), c.validity, dt.STRING,
                       lengths)


class _IntOfString(Expression):
    """An int function of one string."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.INT

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if ctx.is_device:
            return EvalCol(self._device(c).to(torch.int32), c.validity,
                           dt.INT)
        vals = np.asarray([self._host_one(s) for s in c.values],
                          dtype=np.int32)
        return EvalCol(vals, c.validity, dt.INT)


class Length(_IntOfString):
    """length() — the number of characters (UTF-8 aware on both paths)."""

    def _device(self, c):
        return _char_starts(c.values, c.lengths).sum(dim=1)

    def _host_one(self, s):
        return len(s)


class OctetLength(_IntOfString):
    def _device(self, c):
        return c.lengths

    def _host_one(self, s):
        return _utf8_len(s)


class BitLength(OctetLength):
    def _device(self, c):
        return c.lengths * 8

    def _host_one(self, s):
        return _utf8_len(s) * 8


class Ascii(_IntOfString):
    """ascii() — the code point of the first character (0 for ''). The
    device decodes the first character's UTF-8 bytes: Spark's answer,
    where the JAX device path gives the first byte."""

    def _device(self, c):
        v = c.values
        n, w = v.shape
        b = [v[:, k].to(torch.int32) if k < w
             else torch.zeros(n, dtype=torch.int32, device=v.device)
             for k in range(4)]
        cont = [x & 0x3F for x in b[1:]]
        cp = torch.where(b[0] < 0x80, b[0], torch.where(
            b[0] < 0xE0, ((b[0] & 0x1F) << 6) | cont[0], torch.where(
                b[0] < 0xF0, ((b[0] & 0x0F) << 12) | (cont[0] << 6)
                | cont[1], ((b[0] & 0x07) << 18) | (cont[0] << 12)
                | (cont[1] << 6) | cont[2])))
        return torch.where(c.lengths > 0, cp, 0)

    def _host_one(self, s):
        return ord(s[0]) if len(s) else 0


class Chr(Expression):
    """chr(n): the character for n & 0xFF (empty for n < 0).

    Device: the output is at most 2 UTF-8 bytes (code points 0-255), a
    static 8-byte matrix with computed lengths."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            vals = _host_strings(c.values, lambda v: chr(int(v) & 0xFF)
                                 if int(v) >= 0 else "")
            return EvalCol(vals, c.validity, dt.STRING)
        iv = c.values.to(torch.int64)      # the sign before narrowing
        b = iv & 0xFF
        one = b < 0x80
        byte0 = torch.where(one, b, 0xC0 | (b >> 6))
        byte1 = torch.where(one, 0, 0x80 | (b & 0x3F))
        data = _pad_to(torch.stack([byte0, byte1], dim=1).to(torch.uint8),
                       bucket_width(2))
        lengths = torch.where(iv < 0, 0, torch.where(one, 1, 2)) \
            .to(torch.int32)
        return EvalCol(_zero_tail(data, lengths), c.validity, dt.STRING,
                       lengths)


# ---------------------------------------------------------------------------
# substring_index
# ---------------------------------------------------------------------------

class SubstringIndex(Expression):
    """substring_index(str, delim, count) with a literal delimiter and
    count.

    Device: the ``delim_select`` kernel finds each row's cut, one thread a
    row walking the delimiter's occurrences left to right, each kept when
    it starts past the last one kept (UTF-8 is self-synchronizing, so byte
    matching is character-exact); count > 0 keeps a prefix (tail zeroed),
    count < 0 a suffix (a left-shift gather). Reference: GpuSubstringIndex
    in stringFunctions.scala."""

    def __init__(self, child: Expression, delim: Expression,
                 count: Expression):
        self.child, self.delim, self.count = child, delim, count
        self.children = (child, delim, count)

    @property
    def data_type(self):
        return dt.STRING

    def runs_kernel(self) -> bool:
        return bool(literal_value(self.delim)) \
            and int(literal_value(self.count) or 0) != 0

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        delim = literal_value(self.delim)
        cnt = int(literal_value(self.count))
        if ctx.is_device:
            return self._eval_device(c, delim, cnt)
        vals = _host_strings(c.values,
                             lambda s: _substring_index(s, delim, cnt))
        return EvalCol(vals, c.validity, dt.STRING)

    @staticmethod
    def _eval_device(c: EvalCol, delim: str, cnt: int) -> EvalCol:
        from .regex_kernels import delim_select
        v, lengths = c.values, c.lengths
        w = v.shape[1]
        db = delim.encode() if delim else b""
        if not db or cnt == 0 or len(db) > w:
            out_len = torch.zeros_like(lengths) if not db or cnt == 0 \
                else lengths
            return EvalCol(_zero_tail(v, out_len), c.validity, dt.STRING,
                           out_len)
        cut = delim_select(v, lengths, db, cnt)
        if cnt > 0:
            return EvalCol(_zero_tail(v, cut), c.validity, dt.STRING, cut)
        j = torch.arange(w, dtype=torch.int32, device=v.device)[None, :]
        src = torch.clamp(j + cut[:, None], 0, w - 1).long()
        out_len = (lengths - cut).to(torch.int32)
        data = torch.take_along_dim(v, src, dim=1)
        return EvalCol(_zero_tail(data, out_len), c.validity, dt.STRING,
                       out_len)


def _substring_index(s: str, delim: str, count: int) -> str:
    if not delim or count == 0:
        return ""
    parts = s.split(delim)
    return delim.join(parts[:count] if count > 0 else parts[count:])


# ---------------------------------------------------------------------------
# locate / instr
# ---------------------------------------------------------------------------

class StringLocate(Expression):
    """locate/instr(substr, str[, start]) — the 1-based character position
    of the first occurrence at or after character ``start``, 0 if absent
    or if ``start`` < 1.

    Device: the byte offset of the start character, the first hit of the
    literal pattern's shifted compares at or past it, and that byte's
    character index (UTF-8 exact) — the host engine's (and Spark's)
    character positions, where the JAX device path reads ``start`` as a
    byte offset and a literal 0 as 1."""

    def __init__(self, substr: Expression, string: Expression,
                 start: Expression = None):
        self.substr, self.string = substr, string
        self.start = start if start is not None else Literal(1)
        self.children = (substr, string, self.start)

    @property
    def data_type(self):
        return dt.INT

    def eval(self, ctx: EvalContext) -> EvalCol:
        sub = self.substr.eval(ctx)
        s = self.string.eval(ctx)
        st = self.start.eval(ctx)
        validity = _combine_validity(ctx, sub, s)
        if not ctx.is_device:
            out = [0 if int(k) <= 0 else a.find(b, int(k) - 1) + 1
                   for a, b, k in zip(s.values, sub.values, st.values)]
            return EvalCol(np.asarray(out, dtype=np.int32), validity, dt.INT)
        pat = literal_value(self.substr)
        if pat is None:
            raise ValueError("device locate requires a literal pattern")
        pb = pat.encode()
        v, lengths = s.values, s.lengths
        n, w = v.shape
        k = st.values.to(torch.int64)
        starts = _char_starts(v, lengths)
        cidx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
        nchars = starts.sum(dim=1)
        # the byte offset of character k - 1 (the length past the last)
        in_str = _pos_mask(w, lengths)
        from_byte = ((cidx < (k - 1)[:, None]) & in_str).sum(dim=1)
        if not pb:
            found = torch.where(k - 1 <= nchars, k, 0)
        else:
            off = _device_find_from(s, pb, from_byte)
            char_of = torch.take_along_dim(
                cidx, torch.clamp(off, 0, w - 1).long()[:, None], dim=1)[:, 0]
            found = torch.where(off >= 0, char_of + 1, 0)
        return EvalCol(torch.where(k <= 0, 0, found).to(torch.int32),
                       validity, dt.INT)


# ---------------------------------------------------------------------------
# concatenation / padding
# ---------------------------------------------------------------------------

class Concat(Expression):
    """concat(s1, s2, ...) — null if any input is null. Device: a pairwise
    fold of an index-select merge (out[j] = left[j] if j < len_l else
    right[j - len_l])."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return dt.STRING

    def with_children(self, children):
        return Concat(*children)

    def eval(self, ctx: EvalContext) -> EvalCol:
        cols = [c.eval(ctx) for c in self.children]
        validity = _combine_validity(ctx, *cols)
        if not ctx.is_device:
            vals = np.asarray(["".join(parts) for parts in
                               zip(*[c.values for c in cols])], dtype=object)
            return EvalCol(vals, validity, dt.STRING)
        acc = cols[0]
        for c in cols[1:]:
            acc = _device_concat2(acc, c)
        return EvalCol(acc.values, validity, dt.STRING, acc.lengths)


def _device_concat2(l: EvalCol, r: EvalCol) -> EvalCol:  # noqa: E741
    out_w = bucket_width(l.values.shape[1] + r.values.shape[1])
    lv = _pad_to(l.values, out_w)
    rv = _pad_to(r.values, out_w)
    j = torch.arange(out_w, dtype=torch.int32, device=lv.device)[None, :]
    ll = l.lengths[:, None]
    r_sel = torch.take_along_dim(rv, torch.clamp(j - ll, 0, out_w - 1)
                                 .long(), dim=1)
    data = torch.where(j < ll, lv, r_sel)
    lengths = torch.clamp(l.lengths + r.lengths, max=out_w).to(torch.int32)
    return EvalCol(_zero_tail(data, lengths), None, dt.STRING, lengths)


class ConcatWs(Expression):
    """concat_ws(sep, ...) — skips null inputs; null only when sep is null.

    Device: a fold of the Concat merge, with per-row lengths zeroed for
    null inputs and for separators before the first non-null part
    (reference: GpuConcatWs in stringFunctions.scala)."""

    def __init__(self, sep: Expression, *children: Expression):
        self.sep = sep
        self.children = (sep,) + tuple(children)

    @property
    def data_type(self):
        return dt.STRING

    @property
    def nullable(self):
        return self.sep.nullable

    def with_children(self, children):
        return ConcatWs(*children)

    def eval(self, ctx: EvalContext) -> EvalCol:
        sep = self.sep.eval(ctx)
        cols = [c.eval(ctx) for c in self.children[1:]]
        if ctx.is_device:
            return self._eval_device(ctx, sep, cols)
        masks = [c.valid_mask(ctx) for c in cols]
        out = [sep.values[i].join(c.values[i] for c, m in zip(cols, masks)
                                  if m[i])
               for i in range(ctx.num_rows)]
        return EvalCol(np.asarray(out, dtype=object), sep.validity,
                       dt.STRING)

    @staticmethod
    def _eval_device(ctx, sep: EvalCol, cols) -> EvalCol:
        n = sep.shape0()
        dev = sep.lengths.device
        acc = EvalCol(torch.zeros((n, 1), dtype=torch.uint8, device=dev),
                      None, dt.STRING,
                      torch.zeros(n, dtype=torch.int32, device=dev))
        started = torch.zeros(n, dtype=torch.bool, device=dev)
        for c in cols:
            valid = c.valid_mask(ctx)
            sep_eff = EvalCol(sep.values, None, dt.STRING, torch.where(
                started & valid, sep.lengths, 0).to(torch.int32))
            part = EvalCol(c.values, None, dt.STRING,
                           torch.where(valid, c.lengths, 0).to(torch.int32))
            acc = _device_concat2(_device_concat2(acc, sep_eff), part)
            started = started | valid
        return EvalCol(acc.values, sep.validity, dt.STRING, acc.lengths)


class StringRpad(Expression):
    """rpad(str, len, pad) — ASCII-exact on the device, where ``len``
    counts bytes (the JAX package's device path; the rule's ps-note); the
    host engine counts characters."""

    pad_left = False

    def __init__(self, child: Expression, length: Expression,
                 pad: Expression):
        self.child, self.length, self.pad = child, length, pad
        self.children = (child, length, pad)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        ln = self.length.eval(ctx)
        pd = self.pad.eval(ctx)
        validity = _combine_validity(ctx, c, ln, pd)
        if not ctx.is_device:
            out = [_host_pad(s, int(k), p, self.pad_left)
                   for s, k, p in zip(c.values, ln.values, pd.values)]
            return EvalCol(np.asarray(out, dtype=object), validity,
                           dt.STRING)
        pad = literal_value(self.pad)
        tgt = literal_value(self.length)
        if pad is None or tgt is None:
            raise ValueError("device pad requires a literal length and pad")
        tgt = max(int(tgt), 0)
        pb = pad.encode() or b" "
        out_w = bucket_width(max(tgt, c.values.shape[1], 1))
        v = _pad_to(c.values, out_w)
        slen = c.lengths
        j = torch.arange(out_w, dtype=torch.int64, device=v.device)[None, :]
        patv = _pattern_bytes(pb, v.device)
        if self.pad_left:
            shift = torch.clamp(tgt - slen, min=0)[:, None]
            src = torch.take_along_dim(v, torch.clamp(j - shift, 0,
                                                      out_w - 1), dim=1)
            data = torch.where(j < shift, patv[j % len(pb)], src)
        else:
            fill = patv[(j - slen[:, None]) % len(pb)]
            data = torch.where(j < slen[:, None], v, fill)
        out_len = torch.full_like(slen, tgt)
        # truncation when tgt < len
        return EvalCol(_zero_tail(data, out_len), validity, dt.STRING,
                       out_len.to(torch.int32))


class StringLpad(StringRpad):
    pad_left = True


def _host_pad(s: str, k: int, p: str, left: bool) -> str:
    if k <= 0:
        return ""
    if k <= len(s):
        return s[:k]
    if not p:
        return s
    fill = (p * ((k - len(s)) // len(p) + 1))[:k - len(s)]
    return fill + s if left else s + fill


class StringRepeat(Expression):
    """repeat(str, n) — the device requires a literal n (the output width
    is static)."""

    def __init__(self, child: Expression, times: Expression):
        self.child, self.times = child, times
        self.children = (child, times)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        t = self.times.eval(ctx)
        validity = _combine_validity(ctx, c, t)
        if not ctx.is_device:
            vals = np.asarray([s * max(int(k), 0)
                               for s, k in zip(c.values, t.values)],
                              dtype=object)
            return EvalCol(vals, validity, dt.STRING)
        n_rep = literal_value(self.times)
        if n_rep is None:
            raise ValueError("device repeat requires a literal count")
        n_rep = int(n_rep)
        if n_rep <= 0:
            return EvalCol(torch.zeros_like(c.values), validity, dt.STRING,
                           torch.zeros_like(c.lengths))
        out_w = bucket_width(c.values.shape[1] * n_rep)
        v = _pad_to(c.values, out_w)
        j = torch.arange(out_w, dtype=torch.int64, device=v.device)[None, :]
        slen = torch.clamp(c.lengths, min=1)[:, None]
        data = torch.take_along_dim(v, j % slen, dim=1)
        lengths = torch.clamp(c.lengths * n_rep, max=out_w).to(torch.int32)
        return EvalCol(_zero_tail(data, lengths), validity, dt.STRING,
                       lengths)


# ---------------------------------------------------------------------------
# trim family
# ---------------------------------------------------------------------------

class StringTrim(Expression):
    """trim / ltrim / rtrim (space trimming, Spark's default)."""

    trim_left = True
    trim_right = True

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def data_type(self):
        return dt.STRING

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if not ctx.is_device:
            if self.trim_left and self.trim_right:
                vals = _host_strings(c.values, lambda s: s.strip(" "))
            elif self.trim_left:
                vals = _host_strings(c.values, lambda s: s.lstrip(" "))
            else:
                vals = _host_strings(c.values, lambda s: s.rstrip(" "))
            return EvalCol(vals, c.validity, dt.STRING)
        v, lengths = c.values, c.lengths
        w = v.shape[1]
        pos = torch.arange(w, dtype=torch.int32, device=v.device)[None, :]
        inside = _pos_mask(w, lengths)
        nonspace = (v != 32) & inside
        any_ns = nonspace.any(dim=1)
        first_ns = torch.argmax(nonspace.to(torch.int8), dim=1)
        last_ns = w - 1 - torch.argmax(nonspace.flip(1).to(torch.int8),
                                       dim=1)
        lo = first_ns if self.trim_left else torch.zeros_like(first_ns)
        hi = last_ns + 1 if self.trim_right else lengths.long()
        lo = torch.where(any_ns, lo, 0)
        hi = torch.where(any_ns, hi, 0)
        sel = (pos >= lo[:, None]) & (pos < hi[:, None]) & inside
        data, out_len = _compact(v, sel)
        return EvalCol(data, c.validity, dt.STRING, out_len)


class StringTrimLeft(StringTrim):
    trim_right = False


class StringTrimRight(StringTrim):
    trim_left = False


# ---------------------------------------------------------------------------
# replace, RLIKE and the regex span functions
# ---------------------------------------------------------------------------

class StringReplace(Expression):
    """replace(str, search, replace). Device: the ``regex_replace`` kernel
    with a literal search (reference: GpuStringReplace in
    stringFunctions.scala delegates to cudf replace)."""

    def __init__(self, child: Expression, search: Expression,
                 replace: Expression):
        self.child, self.search, self.replace = child, search, replace
        self.children = (child, search, replace)
        self._program = None

    @property
    def data_type(self):
        return dt.STRING

    def runs_kernel(self) -> bool:
        return bool(literal_value(self.search))

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        if ctx.is_device:
            search = literal_value(self.search)
            repl = literal_value(self.replace)
            if search is None or repl is None:
                raise ValueError("device replace requires a literal search "
                                 "and replacement (the rule's tag gates "
                                 "this)")
            if not search:
                return c          # Spark's replace('', x) is the identity
            if self._program is None:
                from .regex_kernels import replace_program
                self._program = replace_program(search.encode(), repl)
            return _device_replace(c, self._program)
        s = self.search.eval(ctx)
        r = self.replace.eval(ctx)
        validity = _combine_validity(ctx, c, s, r)
        out = [a.replace(b, rep) if b else a
               for a, b, rep in zip(c.values, s.values, r.values)]
        return EvalCol(np.asarray(out, dtype=object), validity, dt.STRING)


def _device_replace(c: EvalCol, program) -> EvalCol:
    """Device replace: the match spans re-emitted by the ``regex_replace``
    kernel into rows wide enough for every match to grow."""
    from .regex_kernels import regex_replace, replace_width
    out, out_len = regex_replace(c.values, c.lengths, program,
                                 replace_width(program, c.values.shape[1]))
    return EvalCol(out, c.validity, dt.STRING, out_len)


class RLike(Expression):
    """rlike — Java find() semantics. The device runs the bitmask NFA on the
    ``nfa_match`` kernel (expr/regex.py, ``.`` without line terminators);
    tagging sends a pattern outside the NFA subset to the host engine
    (reference: CudfRegexTranspiler's rejection path). A nullable pattern
    anchored at the end and not at the start matches every row: find()
    takes the empty match at the row's end (``DeviceNfa.matches`` never
    takes an empty match after a row's start)."""

    def __init__(self, child: Expression, pattern: Expression):
        self.child, self.pattern = child, pattern
        self.children = (child, pattern)
        self._nfa = None

    @property
    def data_type(self):
        return dt.BOOLEAN

    def device_nfa(self):
        if self._nfa is None:
            from .regex import compile_device_nfa
            self._nfa = compile_device_nfa(literal_value(self.pattern))
        return self._nfa

    def matches_every_row(self) -> bool:
        nfa = self.device_nfa()
        return nfa is not None and nfa.nullable and nfa.anchored_end \
            and not nfa.anchored_start

    def runs_kernel(self) -> bool:
        return not self.matches_every_row()

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        pat = literal_value(self.pattern)
        if not ctx.is_device:
            rx = re.compile(pat)
            vals = np.asarray([rx.search(s) is not None for s in c.values],
                              dtype=bool)
            return EvalCol(vals, c.validity, dt.BOOLEAN)
        nfa = self.device_nfa()
        if nfa is None:
            raise ValueError(f"device rlike on pattern {pat!r} outside the "
                             "device regex subset")
        if self.matches_every_row():
            vals = torch.ones(c.lengths.shape[0], dtype=torch.bool,
                              device=c.lengths.device)
        else:
            vals = nfa.matches(ctx, c)
        return EvalCol(vals, c.validity, dt.BOOLEAN)


class RegExpExtract(Expression):
    """regexp_extract(str, pattern, idx). Device, for the span subset: the
    ``regex_extract`` kernel copies the first match (idx 0) or its capture
    group idx (the group plan's greedy walk) to byte 0."""

    def __init__(self, child: Expression, pattern: Expression,
                 idx: Expression = None):
        self.child, self.pattern = child, pattern
        self.idx = idx if idx is not None else Literal(1)
        self.children = (child, pattern, self.idx)
        self._program = None

    @property
    def data_type(self):
        return dt.STRING

    def runs_kernel(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        pat = literal_value(self.pattern)
        gi = int(literal_value(self.idx))
        if not ctx.is_device:
            rx = re.compile(pat)

            def one(s):
                m = rx.search(s)
                return m.group(gi) if m and m.group(gi) is not None else ""
            return EvalCol(_host_strings(c.values, one), c.validity,
                           dt.STRING)
        if self._program is None:
            from .regex_kernels import extract_program
            self._program = extract_program(pat, gi)
        from .regex_kernels import regex_extract
        out, out_len = regex_extract(c.values, c.lengths, self._program, gi)
        return EvalCol(out, c.validity, dt.STRING, out_len)


class RegExpReplace(Expression):
    """regexp_replace(str, pattern, replacement). Device, for the span
    subset: the ``regex_replace`` kernel; ``$n`` group references over the
    deterministic group-plan subset (reference: GpuRegExpReplace,
    stringFunctions.scala:895)."""

    def __init__(self, child: Expression, pattern: Expression,
                 replacement: Expression):
        self.child, self.pattern, self.replacement = \
            child, pattern, replacement
        self.children = (child, pattern, replacement)
        self._program = None

    @property
    def data_type(self):
        return dt.STRING

    def runs_kernel(self) -> bool:
        return True

    def eval(self, ctx: EvalContext) -> EvalCol:
        c = self.child.eval(ctx)
        pat = literal_value(self.pattern)
        repl = literal_value(self.replacement)
        if not ctx.is_device:
            rx = re.compile(pat)
            rep = _java_repl_to_python(repl)
            return EvalCol(_host_strings(c.values, lambda s: rx.sub(rep, s)),
                           c.validity, dt.STRING)
        if repl is None:
            raise ValueError("device regexp_replace: a null replacement "
                             "stays on the host (the rule's tag gates this)")
        if self._program is None:
            from .regex_kernels import replace_program
            self._program = replace_program(pat, repl)
        return _device_replace(c, self._program)


def _java_repl_to_python(repl: str) -> str:
    """Java Matcher replacement -> Python re template: ``$n`` becomes
    ``\\g<n>``, ``\\x`` escapes stay literal, lone Python-special
    backslashes get escaped."""
    out = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "\\" and i + 1 < len(repl):
            nxt = repl[i + 1]
            out.append("\\\\" if nxt == "\\" else _re_escape_lit(nxt))
            i += 2
            continue
        if ch == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            j = i + 1
            while j < len(repl) and repl[j].isdigit():
                j += 1
            # \g<n> form: unambiguous for $0 and when digits follow
            out.append("\\g<" + repl[i + 1:j] + ">")
            i = j
            continue
        out.append("\\\\" if ch == "\\" else ch)
        i += 1
    return "".join(out)


def _re_escape_lit(ch: str) -> str:
    return "\\\\" if ch == "\\" else ch


# ---------------------------------------------------------------------------
# get_json_object (host only, as in the JAX package)
# ---------------------------------------------------------------------------

class GetJsonObject(Expression):
    """get_json_object(json, path) with the $.a.b[0] JSONPath subset
    (reference: GpuGetJsonObject.scala; evaluated by the host engine
    only)."""

    def __init__(self, json: Expression, path: Expression):
        self.json, self.path = json, path
        self.children = (json, path)

    @property
    def data_type(self):
        return dt.STRING

    def with_children(self, children):
        return GetJsonObject(children[0], children[1])

    @staticmethod
    def _parse_path(path):
        """Validate and tokenize once (the path is a literal). -> token
        list, or None for a malformed path (Spark returns null rather than
        best-effort parsing)."""
        if not isinstance(path, str) \
                or not re.fullmatch(r"\$(?:\.[A-Za-z0-9_]+|\[\d+\])*", path):
            return None
        return [(key if key else None, int(idx) if idx else None)
                for key, idx in
                re.findall(r"\.([A-Za-z0-9_]+)|\[(\d+)\]", path)]

    @staticmethod
    def _extract(doc, tokens):
        import json as _json
        if not isinstance(doc, str):
            return None
        try:
            cur = _json.loads(doc)
        except Exception:
            return None
        for key, idx in tokens:
            if key is not None:
                if not isinstance(cur, dict) or key not in cur:
                    return None
                cur = cur[key]
            else:
                if not isinstance(cur, list) or idx >= len(cur):
                    return None
                cur = cur[idx]
        if cur is None:
            return None
        if isinstance(cur, str):
            return cur
        return _json.dumps(cur, separators=(",", ":"))

    def eval(self, ctx: EvalContext) -> EvalCol:
        if ctx.is_device:
            raise ValueError("get_json_object runs on the host engine only")
        jc = self.json.eval(ctx)
        tokens = self._parse_path(literal_value(self.path))
        n = len(jc.values)
        out = np.empty(n, dtype=object)
        validity = np.ones(n, dtype=bool)
        jvalid = jc.validity if jc.validity is not None \
            else np.ones(n, dtype=bool)
        for i in range(n):
            r = self._extract(jc.values[i], tokens) \
                if jvalid[i] and tokens is not None else None
            if r is None:
                validity[i] = False
                out[i] = ""
            else:
                out[i] = r
        return EvalCol(out, validity, dt.STRING)

    def __repr__(self):
        return f"get_json_object({self.json!r}, {self.path!r})"
