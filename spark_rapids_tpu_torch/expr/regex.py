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
RLIKE compiles with ``dotall=False`` (Java's ``.`` without DOTALL), as the
JAX package does.

The match-span machinery (regexp_replace, regexp_extract, replace) is here
as plain torch functions under the JAX package's names, each the column
loop of its ``lax.scan``: ``DeviceNfa.match_ends``,
``select_leftmost_spans``, ``replace_by_spans``, ``extract_first_span``,
``literal_match_ends``, the capture-group plan (``compile_group_plan``,
``_greedy_walk_bounds``, ``group_bounds_all_starts``), the replacement
template (``parse_replacement_template``, ``replace_by_template``) and
``extract_group_span``. They are the plain versions of the
``regex_replace`` and ``regex_extract`` kernels (expr/regex_kernels.py),
which run Java's find() loop directly, one thread a row.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..udf.kernels import NfaKernelTables

__all__ = ["RegexUnsupported", "RegexParser", "transpile",
           "compile_device_nfa", "DeviceNfa", "unique_rows",
           "select_leftmost_spans", "replace_by_spans", "extract_first_span",
           "literal_match_ends", "GroupPlan", "compile_group_plan",
           "parse_replacement_template", "group_bounds_all_starts",
           "replace_by_template", "extract_group_span"]

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

    @property
    def spans_supported(self) -> bool:
        """Span extraction (regexp_replace/extract) supported: ASCII-only
        byte classes (char-aligned spans), no alternation (NFA longest ==
        Java greedy order for the remaining subset), non-nullable (no
        empty-match insertion semantics)."""
        return self.ascii_only and not self.has_alt and not self.nullable

    def match_ends(self, values: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """Per (row, start byte): the longest match END (exclusive), or -1
        (int32 ``(n, w)``). Byte-level stepping: it requires ``ascii_only``
        so that spans cannot split a UTF-8 character. The column loop of
        the JAX scan, every start of every row in step; state sets are
        int64 holding uint32 bits."""
        n, w = values.shape
        dev = values.device
        cls_t, masks = self.tables(dev)
        cls = cls_t.long()[values.long()]                         # (n, w)
        accept = self.accept_bits
        lengths = lengths.to(torch.int32)
        in_str = torch.arange(w, dtype=torch.int32,
                              device=dev)[None, :] < lengths[:, None]
        states = torch.zeros((n, w), dtype=torch.int64, device=dev)
        ends = torch.full((n, w), -1, dtype=torch.int32, device=dev)
        for j in range(w):
            # open a new match at start j (column j)
            if not self.anchored_start or j == 0:
                states[:, j] = torch.where(in_str[:, j], self.start_bits, 0)
            m = masks[cls[:, j]]                                  # (n, S)
            nxt = torch.zeros_like(states)
            for t in range(masks.shape[1]):
                nxt |= ((states & m[:, t:t + 1]) != 0).long() << t
            states = torch.where(in_str[:, j:j + 1], nxt, 0)
            done = (states & accept) != 0
            if self.anchored_end:
                done = done & (lengths - 1 == j)[:, None]
            ends = torch.where(done & in_str[:, j:j + 1], j + 1, ends)
        return ends

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


# ---------------------------------------------------------------------------
# Match-span machinery (device regexp_replace / regexp_extract / replace):
# select leftmost non-overlapping spans, then re-emit bytes around them.
# Plain torch, each the column loop of the JAX package's lax.scan; on the
# card the regex_replace and regex_extract kernels compute the same.
# ---------------------------------------------------------------------------
def _cols(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=device)


def select_leftmost_spans(ends: torch.Tensor, lengths: torch.Tensor):
    """ends: (n, w) longest-match end per start (or -1). Returns
    (start_mask, in_match): the leftmost non-overlapping selection, the
    order Java Matcher.find() visits matches."""
    n, w = ends.shape
    next_allowed = torch.zeros(n, dtype=torch.int32, device=ends.device)
    starts = torch.zeros((n, w), dtype=torch.bool, device=ends.device)
    in_match = torch.zeros((n, w), dtype=torch.bool, device=ends.device)
    for j in range(w):
        start = (ends[:, j] >= 0) & (next_allowed <= j)
        next_allowed = torch.where(start, ends[:, j], next_allowed)
        starts[:, j] = start
        in_match[:, j] = next_allowed > j
    return starts, in_match


def _put(out: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
         byte: torch.Tensor) -> None:
    """out[r, idx[r]] = byte[r] where keep[r]; ``out`` has one trash column
    past its width, which takes the rows not kept."""
    trash = out.shape[1] - 1
    col = torch.where(keep, idx.long(), trash)[:, None]
    out.scatter_(1, col, byte.to(torch.uint8)[:, None])


def _emit_literal(out, cursor, start, payload: bytes, out_w: int):
    """Writes ``payload`` at ``cursor`` (clipped to ``out_w - 1``) on the
    rows of ``start``; -> the new cursor."""
    for k, b in enumerate(payload):
        idx = torch.clamp(cursor + k, 0, out_w - 1)
        _put(out, idx, start, torch.full_like(idx, b))
    return torch.where(start, cursor + len(payload), cursor)


def _emit_copy(out, cursor, copy, byte, out_w: int):
    _put(out, torch.clamp(cursor, 0, out_w - 1), copy, byte)
    return torch.where(copy, cursor + 1, cursor)


def replace_by_spans(values: torch.Tensor, lengths: torch.Tensor,
                     start_mask: torch.Tensor, in_match: torch.Tensor,
                     repl: bytes, out_w: int):
    """Emit input bytes with each selected span replaced by ``repl``.
    -> (out (n, out_w) uint8, out_lengths int32). Spans must be non-empty.
    A write past ``out_w - 1`` lands on ``out_w - 1``, and the lengths
    count every byte, as in the JAX package."""
    return replace_by_template(values, lengths, start_mask, in_match, None,
                               [("lit", repl)] if repl else [], {}, out_w)


def extract_first_span(values: torch.Tensor, lengths: torch.Tensor,
                       ends: torch.Tensor):
    """First (leftmost) match span copied to column 0; no match -> ''.
    -> (out (n, w) uint8, out_lengths int32)."""
    n, w = values.shape
    valid = ends >= 0
    found = valid.any(dim=1)
    s = torch.argmax(valid.to(torch.int8), dim=1).to(torch.int32)
    e = torch.take_along_dim(ends, s[:, None].long(), dim=1)[:, 0]
    out_len = torch.where(found, e - s, 0).to(torch.int32)
    return _span_rows(values, s, out_len), out_len


def _span_rows(values: torch.Tensor, start: torch.Tensor,
               out_len: torch.Tensor) -> torch.Tensor:
    """Each row's bytes [start, start + out_len) moved to byte 0, the rest
    zero."""
    w = values.shape[1]
    k = _cols(w, values.device)
    idx = torch.clamp(start[:, None] + k[None, :], 0, w - 1)
    out = torch.take_along_dim(values, idx.long(), dim=1)
    return torch.where(k[None, :] < out_len[:, None], out,
                       0).to(torch.uint8)


def literal_match_ends(values: torch.Tensor, lengths: torch.Tensor,
                       search: bytes) -> torch.Tensor:
    """The ends matrix for a literal byte-string search (StringReplace)."""
    n, w = values.shape
    pos = _cols(w, values.device)
    match = torch.ones((n, w), dtype=torch.bool, device=values.device)
    for k, b in enumerate(search):
        idx = torch.clamp(pos + k, 0, w - 1).long()
        match &= values[:, idx] == b
    match &= (pos[None, :] + len(search)) <= lengths[:, None]
    return torch.where(match, pos[None, :] + len(search), -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Capture groups (reference: CudfRegexTranspiler keeps capture groups in the
# transpiled pattern, RegexParser.scala:414; cuDF extracts them natively).
# For the deterministic no-alternation subset the pattern linearizes into
# charset items; after the NFA finds the match span, a greedy walk over the
# items recovers every group boundary.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroupPlan:
    """Linearized pattern: items are (charset, lo, hi); groups maps group
    index -> [first_item, end_item) ranges over ``items``."""
    items: List[Tuple[frozenset, int, Optional[int]]]
    groups: dict
    ngroups: int


def _linearize(node: RNode, items: List, groups: dict,
               in_group: Optional[int]) -> None:
    if isinstance(node, RSeq):
        for it in node.items:
            _linearize(it, items, groups, in_group)
        return
    if isinstance(node, RGroup):
        if in_group is not None:
            raise RegexUnsupported("nested capture group")
        start = len(items)
        _linearize(node.child, items, groups, node.index)
        groups[node.index] = (start, len(items))
        return
    if isinstance(node, RChars):
        items.append((node.bytes_, 1, 1))
        return
    if isinstance(node, RRepeat):
        if not isinstance(node.child, RChars):
            raise RegexUnsupported("repeat over a non-class in group plan")
        items.append((node.child.bytes_, node.lo, node.hi))
        return
    raise RegexUnsupported(f"group plan: {type(node).__name__}")


def compile_group_plan(pattern: str) -> Optional[GroupPlan]:
    """Linearize ``pattern`` for device capture-group extraction, or None.

    Subset: no alternation/lazy, ASCII-only classes (char-aligned spans),
    non-nullable, groups flat (not nested, not repeated), and greedy
    consumption DETERMINISTIC: every variable-length item's charset is
    disjoint from the first-sets of the items that may follow it up to and
    including the next mandatory item — under that condition the greedy
    left-to-right walk reproduces Java's backtracking parse exactly."""
    try:
        parser = RegexParser(pattern)
        ast = parser.parse()
    except RegexUnsupported:
        return None
    if parser.saw_lazy or parser.ngroups == 0 or _contains_alt(ast):
        return None
    if isinstance(ast, RSeq):
        its = list(ast.items)
        if its and isinstance(its[0], RStartAnchor):
            its = its[1:]
        if its and isinstance(its[-1], REndAnchor):
            its = its[:-1]
        ast = RSeq(its)
    items: List[Tuple[frozenset, int, Optional[int]]] = []
    groups: dict = {}
    try:
        _linearize(ast, items, groups, None)
    except RegexUnsupported:
        return None
    if not items or all(lo == 0 for _, lo, _ in items):
        return None                       # nullable: empty-match semantics
    for cs, _, _ in items:
        if not cs or max(cs) >= 0x80:
            return None                   # spans must stay char-aligned
    # determinism of greedy consumption
    for i, (cs, lo, hi) in enumerate(items):
        if hi is not None and hi == lo:
            continue                      # fixed width: nothing to choose
        for cs2, lo2, _ in items[i + 1:]:
            if cs & cs2:
                return None
            if lo2 >= 1:
                break                     # first mandatory follower reached
    return GroupPlan(items, groups, parser.ngroups)


def parse_replacement_template(repl: str, ngroups: int):
    """Java Matcher.appendReplacement template -> segment list
    [('lit', bytes) | ('grp', int)], or None if un-parsable.

    ``$`` followed by digits is a group reference (digits consumed
    greedily while the number still names an existing group, Java
    semantics); ``\\`` escapes the next character (``\\$`` is a literal
    dollar). Group 0 is the whole match. (reference: GpuRegExpReplace with
    group refs, stringFunctions.scala:895.)"""
    segs = []
    lit = bytearray()
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "\\":
            if i + 1 >= len(repl):
                return None
            lit += repl[i + 1].encode()
            i += 2
            continue
        if ch == "$":
            j = i + 1
            if j >= len(repl) or not repl[j].isdigit():
                return None               # bare $: Java throws
            g = 0
            k = j
            while k < len(repl) and repl[k].isdigit():
                cand = g * 10 + int(repl[k])
                if cand > ngroups and k > j:
                    break
                if cand > ngroups:
                    return None           # first digit already invalid
                g = cand
                k += 1
            if lit:
                segs.append(("lit", bytes(lit)))
                lit = bytearray()
            segs.append(("grp", g))
            i = k
            continue
        lit += ch.encode()
        i += 1
    if lit:
        segs.append(("lit", bytes(lit)))
    return segs


def charset_lut(cs) -> np.ndarray:
    """A charset as a bool (256,) table."""
    lut = np.zeros(256, dtype=bool)
    lut[list(cs)] = True
    return lut


#: (charset, device) -> its bool (256,) table on the device, copied once (a
#: copy from host memory cannot run inside a CUDA graph's capture)
_LUTS: Dict[Tuple[frozenset, torch.device], torch.Tensor] = {}


def _device_lut(cs, device) -> torch.Tensor:
    key = (frozenset(cs), torch.device(device))
    if key not in _LUTS:
        _LUTS[key] = torch.from_numpy(charset_lut(cs)).to(device)
    return _LUTS[key]


def _greedy_walk_bounds(values: torch.Tensor, lengths: torch.Tensor,
                        plan: GroupPlan, pos: torch.Tensor) -> list:
    """Greedy item walk from start positions ``pos`` (n, k). Returns the
    bounds list: bounds[i] is the position after item i-1. The ONE
    implementation of the deterministic greedy consumption:
    extract_group_span (k=1) and the all-starts replace path (k=w) both run
    through it. An item's ``lo`` is never checked, as in the JAX package."""
    n, w = values.shape
    dev = values.device
    idxs = _cols(w, dev)
    vi = values.long()
    in_str = idxs[None, :] < lengths[:, None]
    bounds = [pos]
    for cs, lo, hi in plan.items:
        lut = _device_lut(cs, dev)
        member = lut[vi] & in_str
        bad_at = torch.where(member, w, idxs[None, :])
        nb = torch.cummin(bad_at.flip(1), dim=1).values.flip(1)
        next_bad = torch.take_along_dim(nb, torch.clamp(pos, 0, w - 1).long(),
                                        dim=1)
        avail = torch.clamp(next_bad - pos, min=0)
        take = avail if hi is None else torch.clamp(avail, max=hi)
        pos = (pos + take).to(torch.int32)
        bounds.append(pos)
    return bounds


def group_bounds_all_starts(values: torch.Tensor, lengths: torch.Tensor,
                            plan: GroupPlan) -> dict:
    """Greedy-walk group bounds for EVERY potential match start j.
    -> {g: (GS, GE)} with (n, w) int32 matrices: the bounds of group g for
    a match beginning at column j. Only meaningful where the NFA reported
    a match at j (same deterministic-subset contract as
    extract_group_span)."""
    n, w = values.shape
    pos = _cols(w, values.device)[None, :].expand(n, w)
    bounds = _greedy_walk_bounds(values, lengths, plan, pos)
    return {g: (bounds[lo_i], bounds[hi_i])
            for g, (lo_i, hi_i) in plan.groups.items()}


def _emit_group(out, cursor, start, values, gs, ge, out_w: int):
    """Copies each started row's bytes [gs, ge) to ``cursor``: the JAX
    package's loop over k in [0, w) in one scatter. A write at or past
    ``out_w - 1`` lands on ``out_w - 1``, so the last such k wins there."""
    n, w = values.shape
    glen = torch.where(start, torch.clamp(ge - gs, min=0), 0)
    k = _cols(w, values.device)[None, :]
    src = torch.clamp(gs[:, None] + k, 0, w - 1).long()
    byte = torch.take_along_dim(values, src, dim=1)
    idx = cursor[:, None] + k
    plain = (k < glen[:, None]) & (idx < out_w - 1)
    trash = out.shape[1] - 1
    out.scatter_(1, torch.where(plain, idx.long(), trash), byte)
    last = glen - 1
    clip = (glen > 0) & (cursor + last >= out_w - 1)
    lb = torch.take_along_dim(values, torch.clamp(gs + last, 0, w - 1)
                              .long()[:, None], dim=1)[:, 0]
    _put(out, torch.full_like(cursor, out_w - 1), clip, lb)
    return cursor + glen


def replace_by_template(values: torch.Tensor, lengths: torch.Tensor,
                        start_mask: torch.Tensor, in_match: torch.Tensor,
                        ends: Optional[torch.Tensor], segments,
                        group_bounds: dict, out_w: int):
    """replace_by_spans generalized to a segment template: literals are
    emitted verbatim, group segments copy that match's captured span from
    the input. -> (out (n, out_w) uint8, out_lengths int32)."""
    n, w = values.shape
    dev = values.device
    in_str = _cols(w, dev)[None, :] < lengths[:, None]
    out = torch.zeros((n, out_w + 1), dtype=torch.uint8, device=dev)
    cursor = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(w):
        start = start_mask[:, j]
        for kind, payload in segments:
            if kind == "lit":
                cursor = _emit_literal(out, cursor, start, payload, out_w)
            else:
                if payload == 0:           # whole match: [j, ends[:, j])
                    gs = torch.full_like(cursor, j)
                    ge = torch.clamp(ends[:, j], min=0)
                else:
                    gs = group_bounds[payload][0][:, j]
                    ge = group_bounds[payload][1][:, j]
                cursor = _emit_group(out, cursor, start, values, gs, ge,
                                     out_w)
        copy = in_str[:, j] & ~in_match[:, j]
        cursor = _emit_copy(out, cursor, copy, values[:, j], out_w)
    return out[:, :out_w].contiguous(), cursor


def extract_group_span(values: torch.Tensor, lengths: torch.Tensor,
                       ends: torch.Tensor, plan: GroupPlan, gidx: int):
    """Extract capture group ``gidx`` of the leftmost match per row.
    -> (out (n, w) uint8, out_lengths int32). No match -> ''."""
    valid = ends >= 0
    found = valid.any(dim=1)
    start = torch.argmax(valid.to(torch.int8), dim=1).to(torch.int32)
    bounds = _greedy_walk_bounds(values, lengths, plan, start[:, None])
    lo_i, hi_i = plan.groups[gidx]
    gs = bounds[lo_i][:, 0]
    ge = bounds[hi_i][:, 0]
    out_len = torch.where(found, torch.clamp(ge - gs, min=0),
                          0).to(torch.int32)
    return _span_rows(values, gs, out_len), out_len
