"""Regex matching on the device — the port of the matching half of
``spark_rapids_tpu/expr/regex.py`` (reference: RegexParser.scala:41 +
CudfRegexTranspiler:414).

- ``RegexParser``  — Java-style regex -> AST, rejecting constructs Spark's
  semantics or the device engine can't honor (backrefs, lookaround, \\p
  classes...), so the expression runs on the host engine instead.
- ``transpile``    — validation for the host engine's Python ``re`` (the
  supported subset is dialect-identical).
- ``compile_device_nfa`` — AST -> byte-class **bitmask NFA**: states are
  bits of a uint32, the 256-byte alphabet is compressed to equivalence
  classes, and ``DeviceNfa.matches`` runs it over a string matrix through
  the hand-written CUDA kernel ``nfa_match`` (csrc/nfa_match.cu), one thread
  per row walking a byte-indexed DFA built from the NFA (or, past the DFA's
  state cap, chunked NFA successor tables); on the CPU through its plain
  version.

Match semantics follow Java ``Matcher.find()`` (unanchored unless ^/$).
One difference from the JAX package, on purpose: ``dotall=True`` makes
``.`` match line terminators too, which LIKE needs (Spark's ``%`` and ``_``
match every character; the JAX device LIKE misses ``\\n`` and ``\\r``).
Match spans (``match_ends``, regexp_replace/extract) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..udf.kernels import NfaKernelTables

__all__ = ["RegexUnsupported", "RegexParser", "transpile",
           "compile_device_nfa", "DeviceNfa", "unique_rows"]

MAX_STATES = 32          # state set must fit a uint32 bitmask
# The device NFA is run per *character*: continuation bytes (0x80-0xBF) are
# skipped by the scan, so a symbol is an ASCII byte or a UTF-8 lead byte.
# "any char" classes therefore include the lead-byte range — this keeps `.`,
# negated classes and \D/\W/\S character-exact for all UTF-8 input. Literal
# non-ASCII characters in a *pattern* are rejected from the device subset
# (lead bytes don't identify a character uniquely); host handles those.
_LEAD_BYTES = frozenset(range(0xC2, 0xF5))
_ALL_BYTES = frozenset(range(1, 128)) | _LEAD_BYTES   # NUL excluded (padding)


class RegexUnsupported(Exception):
    """Pattern uses a construct outside the supported subset."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RNode:
    pass


@dataclasses.dataclass
class RChars(RNode):
    """A one-byte matcher: set of accepted byte values."""
    bytes_: frozenset


@dataclasses.dataclass
class RSeq(RNode):
    items: List[RNode]


@dataclasses.dataclass
class RAlt(RNode):
    options: List[RNode]


@dataclasses.dataclass
class RRepeat(RNode):
    child: RNode
    lo: int
    hi: Optional[int]       # None = unbounded


@dataclasses.dataclass
class RGroup(RNode):
    """Capturing group (index is 1-based, Java numbering)."""
    child: RNode
    index: int


@dataclasses.dataclass
class RStartAnchor(RNode):
    pass


@dataclasses.dataclass
class REndAnchor(RNode):
    pass


_CLASS_D = frozenset(range(48, 58))
_CLASS_W = _CLASS_D | frozenset(range(65, 91)) | frozenset(range(97, 123)) | {95}
_CLASS_S = frozenset(b" \t\n\x0b\f\r")


class RegexParser:
    """Recursive-descent parser for the supported Java-regex subset."""

    def __init__(self, pattern: str, dotall: bool = False):
        self.p = pattern
        self.i = 0
        #: ``.`` matches every character, line terminators included (LIKE's
        #: ``%`` and ``_``); else Java's ``.`` without DOTALL
        self.dotall = dotall
        #: lazy quantifiers seen — harmless for boolean matching, but they
        #: change SPAN lengths, so span-based ops must stay on host
        self.saw_lazy = False
        #: capturing groups seen (Java numbering)
        self.ngroups = 0

    def parse(self) -> RNode:
        node = self._alt()
        if self.i != len(self.p):
            raise RegexUnsupported(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    # alt := seq ('|' seq)*
    def _alt(self) -> RNode:
        opts = [self._seq()]
        while self._peek() == "|":
            self.i += 1
            opts.append(self._seq())
        return opts[0] if len(opts) == 1 else RAlt(opts)

    def _seq(self) -> RNode:
        items: List[RNode] = []
        while True:
            ch = self._peek()
            if ch is None or ch in "|)":
                break
            items.append(self._quantified())
        return RSeq(items)

    def _quantified(self) -> RNode:
        atom = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self.i += 1
                atom = RRepeat(atom, 0, None)
            elif ch == "+":
                self.i += 1
                atom = RRepeat(atom, 1, None)
            elif ch == "?":
                self.i += 1
                atom = RRepeat(atom, 0, 1)
            elif ch == "{":
                atom = RRepeat(atom, *self._braces())
            else:
                break
            nxt = self._peek()
            if nxt in ("+",):   # possessive quantifiers: Java-only semantics
                raise RegexUnsupported("possessive quantifier")
            if nxt == "?":      # lazy: irrelevant for pure matching, consume
                self.saw_lazy = True
                self.i += 1
        return atom

    def _braces(self) -> Tuple[int, Optional[int]]:
        try:
            j = self.p.index("}", self.i)
            body = self.p[self.i + 1:j]
            self.i = j + 1
            if "," not in body:
                n = int(body)
                return n, n
            lo_s, hi_s = body.split(",", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s else None
            return lo, hi
        except ValueError as e:
            raise RegexUnsupported(f"malformed {{m,n}} quantifier: {e}")

    def _atom(self) -> RNode:
        ch = self._next()
        if ch == "(":
            capturing = True
            if self._peek() == "?":
                # (?:...) ok; lookaround/named groups unsupported
                if self.p[self.i:self.i + 2] == "?:":
                    self.i += 2
                    capturing = False
                else:
                    raise RegexUnsupported("special group")
            if capturing:
                self.ngroups += 1
                gidx = self.ngroups
            node = self._alt()
            if self._next() != ")":
                raise RegexUnsupported("unbalanced group")
            return RGroup(node, gidx) if capturing else node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return RChars(_ALL_BYTES if self.dotall
                          else frozenset(_ALL_BYTES - {10, 13}))
        if ch == "^":
            return RStartAnchor()
        if ch == "$":
            return REndAnchor()
        if ch == "\\":
            return self._escape()
        if ch in "*+?{":
            raise RegexUnsupported(f"dangling quantifier {ch!r}")
        b = ch.encode()
        if len(b) == 1:
            return RChars(frozenset(b))
        # non-ASCII literal: a lead byte doesn't identify the character
        # uniquely under the per-character scan, so reject (host handles it)
        raise RegexUnsupported("non-ASCII literal in pattern")

    def _escape(self) -> RNode:
        ch = self._next()
        if ch is None:
            raise RegexUnsupported("trailing backslash")
        simple = {"d": _CLASS_D, "D": _ALL_BYTES - _CLASS_D,
                  "w": _CLASS_W, "W": _ALL_BYTES - _CLASS_W,
                  "s": _CLASS_S, "S": _ALL_BYTES - _CLASS_S}
        if ch in simple:
            return RChars(frozenset(simple[ch]))
        if ch == "n":
            return RChars(frozenset({10}))
        if ch == "t":
            return RChars(frozenset({9}))
        if ch == "r":
            return RChars(frozenset({13}))
        if ch == "0":
            raise RegexUnsupported("octal escape")
        if ch.isdigit():
            raise RegexUnsupported("backreference")
        if ch in ("p", "P"):
            raise RegexUnsupported("\\p class")
        if ch in ("b", "B", "A", "Z", "z", "G"):
            raise RegexUnsupported(f"\\{ch} boundary")
        b = ch.encode()
        if len(b) != 1:
            raise RegexUnsupported("non-ASCII escape")
        return RChars(frozenset(b))

    def _char_class(self) -> RNode:
        neg = False
        if self._peek() == "^":
            neg = True
            self.i += 1
        accepted: Set[int] = set()
        first = True
        while True:
            ch = self._next()
            if ch is None:
                raise RegexUnsupported("unterminated class")
            if ch == "]" and not first:
                break
            first = False
            if ch == "\\":
                sub = self._escape()
                if not isinstance(sub, RChars):
                    raise RegexUnsupported("class escape")
                accepted |= set(sub.bytes_)
                continue
            b = ch.encode()
            if len(b) != 1:
                raise RegexUnsupported("non-ASCII in class")
            lo = b[0]
            if self._peek() == "-" and self.p[self.i + 1:self.i + 2] not in ("]", ""):
                self.i += 1
                hi_ch = self._next()
                if hi_ch == "\\":
                    hi_node = self._escape()
                    if not isinstance(hi_node, RChars) or len(hi_node.bytes_) != 1:
                        raise RegexUnsupported("bad range end")
                    hi = next(iter(hi_node.bytes_))
                else:
                    hb = hi_ch.encode()
                    if len(hb) != 1:
                        raise RegexUnsupported("non-ASCII range")
                    hi = hb[0]
                accepted |= set(range(lo, hi + 1))
            else:
                accepted.add(lo)
        if neg:
            accepted = set(_ALL_BYTES) - accepted
        return RChars(frozenset(accepted))

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> Optional[str]:
        ch = self._peek()
        if ch is not None:
            self.i += 1
        return ch


# ---------------------------------------------------------------------------
# host transpile
# ---------------------------------------------------------------------------

def transpile(pattern: str) -> str:
    """Validate ``pattern`` against the supported subset; return a Python
    ``re``-compatible pattern (identical dialect for the subset) or raise
    ``RegexUnsupported`` so tagging falls the expression back."""
    RegexParser(pattern).parse()
    return pattern


# ---------------------------------------------------------------------------
# device NFA
# ---------------------------------------------------------------------------

class _NfaBuilder:
    """Glushkov-style position automaton: one state per RChars occurrence
    (+ start). No epsilon states to eliminate; state count = #char positions."""

    def __init__(self):
        self.accept_sets: List[frozenset] = []   # byte set per state (1-based)

    def new_state(self, bytes_: frozenset) -> int:
        self.accept_sets.append(bytes_)
        return len(self.accept_sets)             # state 0 is start


@dataclasses.dataclass
class _Frag:
    first: Set[int]          # states reachable on first char
    last: Set[int]           # states that can end the match
    nullable: bool
    pairs: Set[Tuple[int, int]]   # follow pairs (a, b): after a comes b


def _build(node: RNode, nb: _NfaBuilder) -> _Frag:
    if isinstance(node, RGroup):    # transparent for matching
        return _build(node.child, nb)
    if isinstance(node, RChars):
        if not node.bytes_:
            raise RegexUnsupported("empty char class")
        s = nb.new_state(node.bytes_)
        return _Frag({s}, {s}, False, set())
    if isinstance(node, RSeq):
        frag = _Frag(set(), set(), True, set())
        for it in node.items:
            if isinstance(it, (RStartAnchor, REndAnchor)):
                raise RegexUnsupported("inner anchor")  # handled at top level
            f = _build(it, nb)
            frag.pairs |= f.pairs
            frag.pairs |= {(a, b) for a in frag.last for b in f.first}
            if frag.nullable:
                frag.first |= f.first
            if f.nullable:
                frag.last |= f.last
            else:
                frag.last = set(f.last)
            frag.nullable = frag.nullable and f.nullable
        return frag
    if isinstance(node, RAlt):
        frags = [_build(o, nb) for o in node.options]
        return _Frag(set().union(*[f.first for f in frags]),
                     set().union(*[f.last for f in frags]),
                     any(f.nullable for f in frags),
                     set().union(*[f.pairs for f in frags]))
    if isinstance(node, RRepeat):
        lo, hi = node.lo, node.hi
        if hi is None:
            if lo == 0:      # e*
                f = _build(node.child, nb)
                f.pairs |= {(a, b) for a in f.last for b in f.first}
                f.nullable = True
                return f
            # e{lo,} = e^(lo-1) e+
            seq = RSeq([node.child] * (lo - 1) + [RRepeat(node.child, 1, None)])
            if lo == 1:       # e+
                f = _build(node.child, nb)
                f.pairs |= {(a, b) for a in f.last for b in f.first}
                return f
            return _build(seq, nb)
        # bounded: expand (keeps state count explicit; guarded by MAX_STATES)
        items: List[RNode] = [node.child] * lo
        items += [RRepeat(node.child, 0, 1)] * (hi - lo)
        if not items:
            return _Frag(set(), set(), True, set())
        if hi == lo and lo == 1:
            return _build(node.child, nb)
        if node.lo == 0 and node.hi == 1:
            f = _build(node.child, nb)
            f.nullable = True
            return f
        return _build(RSeq(items), nb)
    raise RegexUnsupported(f"unsupported node {type(node).__name__}")


class DeviceNfa:
    """Byte-class bitmask NFA runnable over (n, w) uint8 string matrices."""

    def __init__(self, class_of_byte: np.ndarray, masks: np.ndarray,
                 start_bits: int, accept_bits: int, anchored_start: bool,
                 anchored_end: bool, nullable: bool):
        self.class_of_byte = class_of_byte   # (256,) int32
        self.masks = masks                   # (n_classes, n_states) uint32
        self.start_bits = start_bits
        self.accept_bits = accept_bits
        self.anchored_start = anchored_start
        self.anchored_end = anchored_end
        self.nullable = nullable
        #: every matchable byte < 0x80 (match spans are char-aligned)
        self.ascii_only = False
        #: alternation (or a lazy quantifier) present
        self.has_alt = True
        #: shortest non-empty accepted length
        self.min_len = 0
        #: the tables as tensors, per device (uploaded once)
        self._tables: Dict[torch.device, Tuple[torch.Tensor,
                                               torch.Tensor]] = {}
        #: the nfa_match kernel's tables, built once, per device
        self._kernel_tables: Dict[torch.device, "NfaKernelTables"] = {}

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(class_of_byte int32 (256,), masks int64 (classes, states)) on
        ``device``."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = (
                torch.from_numpy(self.class_of_byte.astype(np.int32))
                .to(device),
                torch.from_numpy(self.masks.astype(np.int64)).to(device))
        return self._tables[device]

    def kernel_tables(self, device) -> "NfaKernelTables":
        """The ``nfa_match`` kernel's tables (the byte-indexed DFA, or the
        NFA path's chunked successor tables) on ``device``, built on the
        host once per pattern."""
        from ..udf.kernels import nfa_kernel_tables
        device = torch.device(device)
        if device not in self._kernel_tables:
            self._kernel_tables[device] = nfa_kernel_tables(
                self.class_of_byte, self.masks, self.start_bits,
                self.accept_bits, self.anchored_start, self.anchored_end,
                self.nullable).to(device)
        return self._kernel_tables[device]

    def matches(self, ctx, col) -> torch.Tensor:
        """col: device EvalCol (string). Returns (n,) bool of find()
        matches: the ``nfa_match`` kernel on a CUDA batch, its plain
        version on a CPU one."""
        from ..udf.kernels import nfa_match
        values = col.values.contiguous()
        cls, masks = self.tables(values.device)
        tabs = self.kernel_tables(values.device) \
            if values.device.type == "cuda" else None
        return nfa_match(values, col.lengths.to(torch.int32), cls, masks,
                         self.start_bits, self.accept_bits,
                         self.anchored_start, self.anchored_end,
                         self.nullable, kernel_tables=tabs)


def unique_rows(mat: np.ndarray):
    """``np.unique(axis=0)`` with a flat inverse whatever the numpy major
    (numpy 2.0 returns an inverse shaped like the input rows)."""
    uniq, first, inv = np.unique(mat, axis=0, return_index=True,
                                 return_inverse=True)
    return uniq, first, inv.reshape(-1)


def compile_device_nfa(pattern: str,
                       dotall: bool = False) -> Optional[DeviceNfa]:
    """Compile ``pattern`` to a DeviceNfa, or None when outside the subset.
    ``dotall``: ``.`` matches line terminators too (LIKE)."""
    try:
        parser = RegexParser(pattern, dotall=dotall)
        ast = parser.parse()
    except RegexUnsupported:
        return None
    # peel top-level anchors
    anchored_start = anchored_end = False
    if isinstance(ast, RSeq):
        items = list(ast.items)
        if items and isinstance(items[0], RStartAnchor):
            anchored_start = True
            items = items[1:]
        if items and isinstance(items[-1], REndAnchor):
            anchored_end = True
            items = items[:-1]
        ast = RSeq(items)
    try:
        nb = _NfaBuilder()
        frag = _build(ast, nb)
    except RegexUnsupported:
        return None
    n_states = len(nb.accept_sets) + 1          # + start state 0
    if n_states > MAX_STATES:
        return None
    # byte equivalence classes
    sets = nb.accept_sets
    sig = np.zeros((256, len(sets)), dtype=bool)
    for si, bs in enumerate(sets):
        for b in bs:
            sig[b, si] = True
    _, _, class_of_byte = unique_rows(sig)
    n_classes = class_of_byte.max() + 1
    # transition masks: masks[c, t] = bitmask of source states from which we
    # reach state t on a byte of class c
    follow = {}
    for (a, b) in frag.pairs:
        follow.setdefault(b, set()).add(a)
    for b in frag.first:
        follow.setdefault(b, set()).add(0)
    masks = np.zeros((n_classes, n_states), dtype=np.uint32)
    rep_byte_of_class = {}
    for byte in range(256):
        rep_byte_of_class.setdefault(class_of_byte[byte], byte)
    for c in range(n_classes):
        byte = rep_byte_of_class[c]
        for t in range(1, n_states):
            if byte in sets[t - 1]:
                srcs = follow.get(t, set())
                m = 0
                for s in srcs:
                    m |= (1 << s)
                masks[c, t] = m
    accept_bits = 0
    for s in frag.last:
        accept_bits |= (1 << s)
    nfa = DeviceNfa(class_of_byte.astype(np.int32), masks,
                    start_bits=1, accept_bits=accept_bits,
                    anchored_start=anchored_start, anchored_end=anchored_end,
                    nullable=frag.nullable)
    nfa.ascii_only = all(max(bs, default=0) < 0x80 for bs in sets)
    nfa.has_alt = _contains_alt(ast) or parser.saw_lazy
    nfa.min_len = _nfa_min_len(frag, len(sets))
    return nfa


def _contains_alt(node: RNode) -> bool:
    if isinstance(node, RAlt):
        return True
    if isinstance(node, RSeq):
        return any(_contains_alt(i) for i in node.items)
    if isinstance(node, RRepeat):
        return _contains_alt(node.child)
    if isinstance(node, RGroup):
        return _contains_alt(node.child)
    return False


def _nfa_min_len(frag: _Frag, n_positions: int) -> int:
    """Shortest accepted string length (Bellman-Ford over follow pairs)."""
    if frag.nullable:
        return 0
    INF = n_positions + 2
    dist = [INF] * (n_positions + 1)
    for s in frag.first:
        dist[s] = 1
    for _ in range(n_positions):
        changed = False
        for (a, b) in frag.pairs:
            if dist[a] + 1 < dist[b]:
                dist[b] = dist[a] + 1
                changed = True
        if not changed:
            break
    best = min((dist[s] for s in frag.last), default=INF)
    return max(1, best if best < INF else 1)
