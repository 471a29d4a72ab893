"""The match-span kernels of ``csrc/regex.cu`` and their plain versions.

- ``regex_replace(values, lengths, program, out_w)``: regexp_replace and
  replace. The plain version is the JAX package's chain
  ``match_ends`` (or ``literal_match_ends``) -> ``select_leftmost_spans``
  -> ``group_bounds_all_starts`` -> ``replace_by_template`` of
  expr/regex.py; the kernel runs Java's find() loop, one thread a row.
- ``regex_extract(values, lengths, program, group)``: regexp_extract, the
  first match's span (``extract_first_span``) or its capture group
  (``extract_group_span``).
- ``delim_select(values, lengths, delim, count)``: substring_index's
  delimiter scan (the ``lax.scan`` of the JAX ``SubstringIndex``): the cut
  position of each row.

A wrapper takes the plain version for a tensor on the CPU, and launches the
kernel for one on the card, counting it in ``<wrapper>.launches``; it
never falls back. ``values`` may be a broadcast row (stride 0 between rows)
or a view at any byte offset.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..columnar.device import bucket_width
from ..native import launch
from .regex import (DeviceNfa, GroupPlan, charset_lut, compile_device_nfa,
                    compile_group_plan, extract_first_span,
                    extract_group_span, group_bounds_all_starts,
                    literal_match_ends, parse_replacement_template,
                    replace_by_template, select_leftmost_spans)

__all__ = ["RegexProgram", "regex_program", "replace_program",
           "extract_program", "replace_width", "regex_replace",
           "regex_replace_reference", "regex_extract",
           "regex_extract_reference", "delim_select",
           "delim_select_reference", "REGEX_HEADER"]

#: csrc/regex.cu Header: the word of each field of a program's header
REGEX_HEADER = {"kind": 0, "flags": 1, "states": 2, "start": 3, "accept": 4,
                "items": 5, "segs": 6, "groups": 7, "class_at": 8,
                "succ_at": 9, "item_at": 10, "group_at": 11, "seg_at": 12,
                "pool_at": 13, "words": 14, "first_at": 15}
_HEADER_WORDS = 16
_NO_HI = 0xFFFFFFFF


@dataclasses.dataclass
class RegexProgram:
    """What the kernels read besides the strings, built on the host once
    per pattern and template: ``words`` (uint32) for the kernel, and the
    matcher, template and plan for the plain versions."""
    words: np.ndarray
    matcher: Union[DeviceNfa, bytes]
    segments: Tuple
    plan: Optional[GroupPlan]
    _on: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def on(self, device) -> torch.Tensor:
        """The program's words on ``device`` (copied once)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch.from_numpy(
                self.words.view(np.int32).copy()).to(device)
        return self._on[device]


def _successors(masks: np.ndarray) -> np.ndarray:
    """succ[c, s]: the states reached on class c from state s (masks[c, t]
    holds the sources of t)."""
    classes, states = masks.shape
    succ = np.zeros((classes, states), dtype=np.uint32)
    for t in range(states):
        for s in range(states):
            succ[:, s] |= np.where((masks[:, t] >> s) & 1 != 0,
                                   np.uint32(1 << t), np.uint32(0))
    return succ


def regex_program(matcher: Union[DeviceNfa, bytes],
                  segments: Sequence = (),
                  plan: Optional[GroupPlan] = None) -> RegexProgram:
    """The kernels' program: ``matcher`` a DeviceNfa (in the span subset)
    or the non-empty bytes of a literal search; ``segments`` the template
    (``('lit', bytes)`` and ``('grp', g)``, as parse_replacement_template
    gives them); ``plan`` the capture-group plan, needed for a group past
    0."""
    segments = tuple(segments)
    groups = [g for kind, g in segments if kind == "grp" and g > 0]
    if groups and (plan is None or max(groups) > plan.ngroups):
        raise ValueError(f"regex_program: groups {groups} without a plan "
                         "that has them")
    pool = bytearray()
    head = {}
    body = []

    def place(field: str, arr: np.ndarray) -> None:
        """``arr`` as the next section, its word offset in ``field``."""
        head[field] = _HEADER_WORDS + sum(len(b) for b in body)
        body.append(np.asarray(arr, dtype=np.uint32).reshape(-1))

    first = np.zeros(256, dtype=bool)       # bytes that can begin a match
    if isinstance(matcher, DeviceNfa):
        nfa = matcher
        masks = nfa.masks.astype(np.uint32)
        succ = _successors(masks)
        head.update(kind=1, states=masks.shape[1], start=nfa.start_bits,
                    accept=nfa.accept_bits, flags=int(nfa.anchored_start)
                    | int(nfa.anchored_end) << 1)
        place("class_at", nfa.class_of_byte.astype(np.uint8).view(np.uint32))
        place("succ_at", succ)
        from_start = np.zeros(succ.shape[0], dtype=np.uint32)
        for st in range(masks.shape[1]):
            if nfa.start_bits >> st & 1:
                from_start |= succ[:, st]
        first = from_start[nfa.class_of_byte] != 0
    else:
        search = bytes(matcher)
        if not search:
            raise ValueError("regex_program: an empty literal search")
        head["states"] = len(search)
        pool += search
        first[search[0]] = True
    place("first_at", np.packbits(first, bitorder="little").view(np.uint32))
    items = plan.items if plan is not None else []
    rows = [np.concatenate([
        np.packbits(charset_lut(cs), bitorder="little").view(np.uint32),
        [lo, _NO_HI if hi is None else hi]]) for cs, lo, hi in items]
    head["items"] = len(items)
    place("item_at", np.concatenate(rows) if rows else np.zeros(0))
    ng = plan.ngroups if plan is not None else 0
    bounds = np.zeros((ng + 1, 2), dtype=np.uint32)
    for g, (lo_i, hi_i) in (plan.groups.items() if plan else ()):
        bounds[g] = (lo_i, hi_i)
    head["groups"] = ng
    place("group_at", bounds)
    segs = []
    for kind, payload in segments:
        if kind == "lit":
            segs.append((0, len(pool), len(payload)))
            pool += payload
        else:
            segs.append((1, payload, 0))
    head["segs"] = len(segs)
    place("seg_at", np.array(segs, dtype=np.uint32).reshape(-1, 3))
    pool += b"\0" * (-len(pool) % 4)
    place("pool_at", np.frombuffer(bytes(pool), dtype=np.uint32))
    header = np.zeros(_HEADER_WORDS, dtype=np.uint32)
    for field, value in head.items():
        header[REGEX_HEADER[field]] = value
    words = np.concatenate([header] + body)
    words[REGEX_HEADER["words"]] = len(words)
    return RegexProgram(words, matcher, segments, plan)


def replace_program(search: Union[str, bytes], repl: str) -> RegexProgram:
    """The program of ``replace`` (``search`` the literal's bytes) or of
    ``regexp_replace`` (``search`` a pattern in the span subset; a
    replacement with ``$n`` references is a template over the pattern's
    group plan, any other is taken as its bytes, as in the JAX package).
    Raises ValueError outside the subsets, which the rules' tags keep off
    the device."""
    if isinstance(search, bytes):
        return regex_program(search, [("lit", repl.encode())])
    nfa = compile_device_nfa(search)
    if nfa is None or not nfa.spans_supported:
        raise ValueError(f"regexp_replace: {search!r} is outside the span "
                         "subset")
    if not re.search(r"\$\d", repl):
        return regex_program(nfa, [("lit", repl.encode())])
    plan = compile_group_plan(search)
    segments = parse_replacement_template(repl, plan.ngroups) \
        if plan is not None else None
    if segments is None:
        raise ValueError(f"regexp_replace: {search!r} with {repl!r} is "
                         "outside the group-plan subset")
    return regex_program(nfa, segments, plan)


def extract_program(pattern: str, group: int) -> RegexProgram:
    """The program of ``regexp_extract`` (a pattern in the span subset, a
    group within its group plan). Raises ValueError outside them."""
    nfa = compile_device_nfa(pattern)
    if nfa is None or not nfa.spans_supported:
        raise ValueError(f"regexp_extract: {pattern!r} is outside the span "
                         "subset")
    plan = compile_group_plan(pattern) if group else None
    if group and (plan is None or group > plan.ngroups):
        raise ValueError(f"regexp_extract: group {group} of {pattern!r} is "
                         "outside the group-plan subset")
    return regex_program(nfa, (), plan)


def replace_width(program: RegexProgram, w: int) -> int:
    """The output width of a replace over rows of width ``w``, as the JAX
    package sizes it: room for every match to grow (capped at 4096
    bytes)."""
    min_len = program.matcher.min_len \
        if isinstance(program.matcher, DeviceNfa) else len(program.matcher)
    lits = [p for k, p in program.segments if k == "lit"]
    n_refs = len(program.segments) - len(lits)
    lit_total = sum(map(len, lits))
    if n_refs:
        # every non-match byte copies (<= w), each group ref's emissions
        # total <= w across all matches ('$1$1' doubles), plus one literal
        # block per match (<= w // min_len matches)
        return bucket_width(w * (1 + n_refs) + (w // max(min_len, 1))
                            * lit_total + lit_total)
    grow = max(lit_total - min_len, 0)
    return bucket_width(w + (w // max(min_len, 1)) * grow)


def _ends(values: torch.Tensor, lengths: torch.Tensor,
          program: RegexProgram) -> torch.Tensor:
    if isinstance(program.matcher, DeviceNfa):
        return program.matcher.match_ends(values, lengths)
    return literal_match_ends(values, lengths, bytes(program.matcher))


def regex_replace_reference(values: torch.Tensor, lengths: torch.Tensor,
                            program: RegexProgram, out_w: int):
    """The plain version of ``regex_replace``."""
    lengths = lengths.to(torch.int32)
    ends = _ends(values, lengths, program)
    starts, in_match = select_leftmost_spans(ends, lengths)
    bounds = group_bounds_all_starts(values, lengths, program.plan) \
        if any(k == "grp" and g > 0 for k, g in program.segments) else {}
    return replace_by_template(values, lengths, starts, in_match, ends,
                               program.segments, bounds, out_w)


def regex_extract_reference(values: torch.Tensor, lengths: torch.Tensor,
                            program: RegexProgram, group: int):
    """The plain version of ``regex_extract``."""
    lengths = lengths.to(torch.int32)
    ends = _ends(values, lengths, program)
    if group == 0:
        return extract_first_span(values, lengths, ends)
    return extract_group_span(values, lengths, ends, program.plan, group)


def _check(name: str, values: torch.Tensor, lengths: torch.Tensor):
    if values.dim() != 2 or values.dtype != torch.uint8 \
            or values.shape[1] == 0:
        raise TypeError(f"{name}: values must be a 2-D uint8 matrix, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if values.device.type != "cuda":
        raise TypeError(f"{name}: no kernel for device {values.device}")
    if values.stride(1) != 1:
        values = values.contiguous()
    lens = lengths.to(device=values.device, dtype=torch.int32).contiguous()
    if lens.shape != (values.shape[0],):
        raise ValueError(f"{name}: {tuple(lens.shape)} lengths for "
                         f"{values.shape[0]} rows")
    return values, lens


def regex_replace(values: torch.Tensor, lengths: torch.Tensor,
                  program: RegexProgram, out_w: int):
    """Each row's leftmost non-overlapping matches replaced by the
    program's template -> (uint8 (n, out_w), int32 lengths). A byte at or
    past ``out_w - 1`` lands on ``out_w - 1`` and the length counts every
    byte (the JAX package's clip; its callers size ``out_w`` to hold the
    worst case up to 4096 bytes)."""
    if values.device.type == "cpu":
        return regex_replace_reference(values, lengths, program, out_w)
    values, lens = _check("regex_replace", values, lengths)
    dev = values.device
    n, width = values.shape
    out = torch.empty((n, out_w), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        prog = program.on(dev)
        launch(regex_replace, "srt_regex_replace", dev, values.data_ptr(),
               values.stride(0), width, lens.data_ptr(), n, prog.data_ptr(),
               prog.numel(), out_w, out.data_ptr(), out_len.data_ptr())
    return out, out_len


#: kernel launches so far (a test or smoke run resets it to 0)
regex_replace.launches = 0


def regex_extract(values: torch.Tensor, lengths: torch.Tensor,
                  program: RegexProgram, group: int):
    """Each row's first match (group 0) or its capture group ``group``
    moved to byte 0, the rest zero; '' without a match -> (uint8 (n, w),
    int32 lengths)."""
    if values.device.type == "cpu":
        return regex_extract_reference(values, lengths, program, group)
    values, lens = _check("regex_extract", values, lengths)
    dev = values.device
    n, width = values.shape
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        prog = program.on(dev)
        launch(regex_extract, "srt_regex_extract", dev, values.data_ptr(),
               values.stride(0), width, lens.data_ptr(), n, prog.data_ptr(),
               prog.numel(), group, out.data_ptr(), out_len.data_ptr())
    return out, out_len


#: kernel launches so far (a test or smoke run resets it to 0)
regex_extract.launches = 0


def delim_select_reference(values: torch.Tensor, lengths: torch.Tensor,
                           delim: bytes, count: int) -> torch.Tensor:
    """The plain version of ``delim_select``: the occurrences by shifted
    compares, the JAX scan's left-to-right overlap resolution as a column
    loop, then the count-th kept occurrence from the left (its start) or
    from the right (its end)."""
    n, w = values.shape
    dev = values.device
    lengths = lengths.to(torch.int32)
    dlen = len(delim)
    j = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    occ = torch.ones((n, w), dtype=torch.bool, device=dev)
    for k, b in enumerate(delim):
        occ &= torch.roll(values, -k, dims=1) == b if k else values == b
    occ &= (j + dlen) <= lengths[:, None]
    keep = torch.zeros_like(occ)
    next_ok = torch.zeros(n, dtype=torch.int32, device=dev)
    for col in range(w):
        k_ = occ[:, col] & (next_ok <= col)
        next_ok = torch.where(k_, col + dlen, next_ok)
        keep[:, col] = k_
    kcum = torch.cumsum(keep.to(torch.int32), dim=1)
    total = kcum[:, -1]
    if count > 0:
        hit = keep & (kcum == count)
        cut = torch.argmax(hit.to(torch.int8), dim=1).to(torch.int32)
        return torch.where(total >= count, cut, lengths).to(torch.int32)
    target = (total + count + 1)[:, None]
    hit = keep & (kcum == target)
    start = torch.argmax(hit.to(torch.int8), dim=1).to(torch.int32) + dlen
    return torch.where(total >= -count, start, 0).to(torch.int32)


#: (delimiter, device) -> its bytes on the device, copied once
_DELIMS: dict = {}


def delim_select(values: torch.Tensor, lengths: torch.Tensor, delim: bytes,
                 count: int) -> torch.Tensor:
    """substring_index's cut in each row, for a delimiter of at least one
    byte and a count other than 0: for ``count`` > 0 the start of the
    count-th kept occurrence (the row's length when there are fewer), for
    ``count`` < 0 the end of the (-count)-th from the right (0 when there
    are fewer). Occurrences are kept left to right, each starting at or
    past the end of the last one kept. -> int32 (n,)."""
    if not delim or count == 0:
        raise ValueError("delim_select: an empty delimiter or a count of 0")
    if values.device.type == "cpu":
        return delim_select_reference(values, lengths, delim, count)
    values, lens = _check("delim_select", values, lengths)
    dev = values.device
    n, width = values.shape
    key = (bytes(delim), dev)
    if key not in _DELIMS:
        _DELIMS[key] = torch.from_numpy(
            np.frombuffer(bytes(delim), dtype=np.uint8).copy()).to(dev)
    d = _DELIMS[key]
    cut = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        launch(delim_select, "srt_delim_select", dev, values.data_ptr(),
               values.stride(0), width, lens.data_ptr(), n, d.data_ptr(),
               len(delim), count, cut.data_ptr())
    return cut


#: kernel launches so far (a test or smoke run resets it to 0)
delim_select.launches = 0
