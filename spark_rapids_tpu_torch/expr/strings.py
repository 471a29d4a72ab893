"""String functions the TPC-H queries use — the port of those parts of
``spark_rapids_tpu/expr/strings.py`` (reference: stringFunctions.scala):
``Substring``, ``StartsWith``, ``EndsWith``, ``Contains`` and ``Like``.

Device strings are fixed-width padded uint8 matrices ``(capacity, width)``
plus int32 byte ``lengths`` (columnar/device.py). Every device op here is a
handful of whole-matrix torch ops:

- character-aware ops (substring) derive a per-byte *character index* from
  the UTF-8 continuation-bit mask ``(b & 0xC0) != 0x80`` — exact for all of
  UTF-8;
- variable-length outputs are produced by *stable left-compaction*: select
  the surviving bytes, stable-argsort the inverted selection per row,
  gather;
- search ops compare shifted copies of the matrix against a literal
  pattern;
- a LIKE pattern beyond equality/prefix/suffix/contains runs the bitmask
  NFA of expr/regex.py on the hand-written ``nfa_match`` kernel.

The host engine evaluates the same expressions with Python strings.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from ..columnar import dtypes as dt
from .arithmetic import _combine_validity
from .base import Alias, EvalCol, EvalContext, Expression, Literal

__all__ = ["Substring", "StartsWith", "EndsWith", "Contains", "Like",
           "literal_value"]


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


def _device_find_from(l: EvalCol, pattern: bytes,
                      from_byte: int) -> torch.Tensor:
    v, lengths = l.values, l.lengths
    n, w = v.shape
    p = len(pattern)
    if p == 0:
        return torch.full((n,), max(from_byte, 0), dtype=torch.int32,
                          device=v.device)
    if p > w:
        return torch.full((n,), -1, dtype=torch.int32, device=v.device)
    pat = pattern
    hit = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    for k in range(p):
        shifted = _pad_to(v[:, k:], w) if k else v
        hit = hit & (shifted == pat[k])
    pos = torch.arange(w, dtype=torch.int32, device=v.device)[None, :]
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
