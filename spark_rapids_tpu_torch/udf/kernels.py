"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper checks its inputs, then:
- for tensors on the CPU, computes the plain version;
- for tensors on a CUDA device, launches the kernel on the current stream
  (building the library at first use) and counts the launch in
  ``<wrapper>.launches``; a failed launch raises. There is no fallback from
  the kernel to the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["axpy", "axpy_reference", "nfa_match", "nfa_match_reference",
           "NfaKernelTables", "nfa_kernel_tables", "DFA_MAX_STATES",
           "SpanDfa", "span_dfa", "SPAN_DFA_MAX_STATES"]


def axpy_reference(a: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Plain version of ``axpy``: two float32 ops, each rounded."""
    return a * x + y


def axpy(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a * x + y`` over 1-D float32 tensors
    (kernel: csrc/axpy.cu, replacing the Pallas ``_axpy_kernel``)."""
    for name, t in (("a", a), ("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError(f"axpy: {name} must be a contiguous 1-D float32 "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != a.device or t.shape != a.shape:
            raise ValueError(f"axpy: {name} is {tuple(t.shape)} on "
                             f"{t.device}, a is {tuple(a.shape)} on "
                             f"{a.device}")
    if a.device.type == "cpu":
        return axpy_reference(a, x, y)
    if a.device.type != "cuda":
        raise TypeError(f"axpy: no kernel for device {a.device}")
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    from ..native import launch
    launch(axpy, "srt_axpy_f32", a.device, a.data_ptr(), x.data_ptr(),
           y.data_ptr(), out.data_ptr(), n)
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
axpy.launches = 0


def nfa_match_reference(values: torch.Tensor, lengths: torch.Tensor,
                        class_of_byte: torch.Tensor, masks: torch.Tensor,
                        start_bits: int, accept_bits: int,
                        anchored_start: bool, anchored_end: bool,
                        nullable: bool,
                        end_newline: bool = False) -> torch.Tensor:
    """Plain version of ``nfa_match``: the column loop of the JAX
    ``DeviceNfa.matches`` scan, every row in step. State sets are int64
    (torch has no shifts on uint32). With ``end_newline`` (a regex ``$``)
    a pattern anchored at the end also matches where it accepts just
    before a final ``\\n``, the row's last character (the JAX scan does
    not: ROADMAP Queue 3)."""
    n, w = values.shape
    dev = values.device
    n_states = masks.shape[1]
    cls = class_of_byte.long()[values.long()]                     # (n, w)
    m_all = masks.long()
    bit = torch.ones(n_states, dtype=torch.int64, device=dev) \
        << torch.arange(n_states, dtype=torch.int64, device=dev)
    pos = torch.arange(w, dtype=torch.int32, device=dev)
    lead_in = ((values & 0xC0) != 0x80) & (pos[None, :] < lengths[:, None])
    # the lead byte of each row's final character (for $ anchoring)
    any_lead = lead_in.any(dim=1)
    last_lead = w - 1 - torch.argmax(lead_in.flip(1).to(torch.int8), dim=1)
    is_last = lead_in & (pos[None, :] == last_lead[:, None]) \
        & any_lead[:, None]
    matched = torch.where(lengths == 0,
                          torch.full((n,), nullable, device=dev),
                          torch.full((n,), nullable and not anchored_end,
                                     device=dev))
    end_newline = end_newline and anchored_end
    if end_newline and nullable:
        # the empty match at 0, before a row's only byte, a newline
        matched |= (lengths == 1) & (values[:, 0] == 10)
    nl_last = is_last & (values == 10)
    active = torch.full((n,), start_bits, dtype=torch.int64, device=dev)
    accept = accept_bits
    for j in range(w):
        if end_newline:
            matched |= nl_last[:, j] & ((active & accept) != 0)
        m = m_all[cls[:, j]]                                       # (n, S)
        hits = (active[:, None] & m) != 0
        nxt = (hits.long() * bit[None, :]).sum(dim=1)
        if not anchored_start:
            nxt = nxt | start_bits
        inside = lead_in[:, j]
        active = torch.where(inside, nxt, active)
        done = (active & accept) != 0
        gate = is_last[:, j] if anchored_end else inside
        matched = torch.where(gate, matched | done, matched)
    return matched


#: The most DFA states the kernel's table path takes (its byte table is 256
#: bytes a state in shared memory: 16 KiB at the cap); a pattern whose DFA
#: has more runs on the NFA path (successor tables over chunks of the
#: active set). The occupancy this leaves is in csrc/nfa_match.cu.
DFA_MAX_STATES = 64
#: the most shared memory the NFA path's tables take with 8-bit chunks of
#: the active set; above it they use 4-bit chunks (at most 128 KiB)
_NFA_TABLE_BYTES_8BIT = 64 * 1024


@dataclasses.dataclass(frozen=True)
class NfaKernelTables:
    """What the ``nfa_match`` kernel reads besides the strings, built on the
    host from one NFA (``nfa_kernel_tables``): a byte ``blob`` that each
    block copies into shared memory, and the scalars that say how to walk
    it.

    DFA path (``dfa``): ``blob`` is a uint8 table ``T[state * 256 + byte]``
    of ``n_states`` rows, then one accept flag a state at ``n_states *
    256``. A continuation byte maps every state to itself. A row starts in
    ``init_state``; states ``>= sink_lo`` are sinks (every byte maps them to
    themselves): a find() match of a pattern unanchored at the end, or the
    empty set of one anchored at the start. A row's answer is the accept
    flag of the state after its last byte (``nullable`` for an empty row).

    NFA path: ``blob`` is the class of each byte as uint16 ``(256,)``
    (continuation bytes in the identity class ``n_classes``), then uint32
    successor tables ``S[c][k][v]``: the states reached on class ``c`` from
    the states ``v`` of the ``k``-th ``chunk_bits``-bit chunk of the active
    set, the start bit folded into chunk 0 unless the pattern is anchored
    at the start. One step is ``OR_k S[c][k][(active >> k * chunk_bits) &
    mask]``."""
    blob: torch.Tensor
    dfa: bool
    n_states: int
    init_state: int
    sink_lo: int
    chunk_bits: int
    n_chunks: int
    #: (start_bits, accept_bits, anchored_start, anchored_end, nullable,
    #: n_classes, n_nfa_states, end_newline) the tables were built for
    built_for: tuple

    def to(self, device) -> "NfaKernelTables":
        return dataclasses.replace(self, blob=self.blob.to(device))


def _nfa_steps(masks: np.ndarray, n_states: int) -> np.ndarray:
    """``succ[c, s]``: the state set reached on class ``c`` from state
    ``s`` alone (``masks[c, t]`` holds the states that reach ``t``)."""
    s = np.arange(n_states, dtype=np.int64)
    hit = (masks[:, :, None] >> s[None, None, :]) & 1        # (C, T, S)
    return (hit << np.arange(masks.shape[1], dtype=np.int64)[None, :, None]
            ).sum(axis=1)


def _subset_dfa(succ: np.ndarray, start_bits: int, accept_bits: int,
                anchored_start: bool, anchored_end: bool, nullable: bool,
                max_states: int, newline_class: Optional[int] = None):
    """Subset construction over byte classes, from the start set, then
    minimised. Returns (transitions (states, classes), accept flags, sink
    ids), the initial state 0, or None past ``max_states`` subsets.
    Unanchored at the end, every set holding an accepting state becomes one
    sink MATCH (find() is settled there); anchored at the start, the empty
    set is a sink.

    ``newline_class`` (a class of ``\\n`` alone; anchored at the end): a
    regex ``$`` that also matches before a final ``\\n``. A state is then
    a set, a bit 32 "the last byte was a ``\\n`` read where the set
    before accepted" and, for a nullable pattern, a bit 33 "no byte read
    yet" (the empty match at 0); a state accepts when its set does or its
    bit 32 is set."""
    n_classes, n_states = succ.shape
    match = -1                                  # key of the MATCH sink
    settle = not anchored_end
    low = (1 << 32) - 1

    def key(a: int) -> int:
        return match if settle and a & accept_bits else a

    def before_newline(a: int) -> int:
        """bit 32 of the state a ``\\n`` leads to from state ``a``"""
        took = a & low & accept_bits or (a >> 33 & 1 and nullable)
        return 1 << 32 if took else 0

    if max_states < 1:
        return None
    init = match if settle and nullable else start_bits
    if newline_class is not None and nullable:
        init |= 1 << 33
    ids = {init: 0}
    order = [init]
    trans = []
    i = 0
    while i < len(order):
        a = order[i]
        if a == match:
            row = [match] * n_classes
        else:
            on = ((a >> np.arange(n_states)) & 1).astype(bool)
            nxt = np.bitwise_or.reduce(np.where(on[None, :], succ, 0),
                                       axis=1)
            if not anchored_start:
                nxt = nxt | start_bits
            row = [key(int(x)) for x in nxt]
            if newline_class is not None:
                row[newline_class] |= before_newline(a)
        for b in row:
            if b not in ids:
                if len(ids) >= max_states:
                    return None
                ids[b] = len(ids)
                order.append(b)
        trans.append([ids[b] for b in row])
        i += 1
    accept = [a == match or (not settle and bool(a & (accept_bits
                                                      | 1 << 32)))
              for a in order]
    sinks = {ids[k] for k in ids if k == match or k == 0}
    return _minimal(np.array(trans, np.int64), np.array(accept), sinks)


def _minimal(trans: np.ndarray, accept: np.ndarray, sinks: set):
    """Moore's partition refinement: states that no byte string tells
    apart (same answer, same sink status, after every string) merge. The
    initial state keeps id 0."""
    is_sink = np.isin(np.arange(len(trans)), sorted(sinks))
    label = np.unique(np.stack([accept, is_sink], 1), axis=0,
                      return_inverse=True)[1].reshape(-1)
    while True:
        sig = np.concatenate([label[:, None], label[trans]], 1)
        _, first, new = np.unique(sig, axis=0, return_index=True,
                                  return_inverse=True)
        new = new.reshape(-1)
        if len(first) == label.max() + 1:
            break
        label = new
    # number the blocks in the order their first state was found
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    label = rank[new]
    rep = np.sort(first)                 # one state of each block
    return (label[trans[rep]], accept[rep],
            {int(label[s]) for s in sinks})


#: The most states of a span DFA (``span_dfa``): its states are uint8
SPAN_DFA_MAX_STATES = 256


@dataclasses.dataclass(frozen=True)
class SpanDfa:
    """The DFA of a match from one start (``span_dfa``): ``trans[state,
    class]`` the next state; state 0 dead (no accepting state is reachable
    from it), ``init`` the start, and states ``accept_lo`` and up
    accepting."""
    trans: np.ndarray
    init: int
    accept_lo: int

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def span_dfa(masks, start_bits: int, accept_bits: int,
             max_states: int = SPAN_DFA_MAX_STATES) -> Optional[SpanDfa]:
    """The subset construction of a match from one start, over the NFA's
    byte classes (``masks`` (classes, states) of uint32 bit sets): the
    ``_subset_dfa`` of a pattern anchored at both ends, so never re-seeded
    and with no sink for a match (a step goes on past an accept, to the
    longest match); the empty set, which every pattern reaches (no class
    holds the NUL byte), its one sink and the only set from which no
    accept is reachable (each NFA state reaches an accept). Numbered dead
    0, then the states that do not accept, then those that do. None past
    ``max_states`` subsets. The kernels of csrc/regex.cu step it from each
    start; where it is None they step the NFA's successor sets."""
    m = np.asarray(masks, dtype=np.int64) & 0xFFFFFFFF
    dfa = _subset_dfa(_nfa_steps(m, m.shape[1]), int(start_bits),
                      int(accept_bits), True, True, False, max_states)
    if dfa is None:
        return None
    trans, accept, sinks = dfa
    (dead,) = sinks
    rest = [k for k in range(len(trans)) if k != dead]
    order = [dead] + [k for k in rest if not accept[k]] \
        + [k for k in rest if accept[k]]
    new = np.empty(len(order), np.int64)
    new[order] = np.arange(len(order))
    return SpanDfa(trans=new[trans[order]], init=int(new[0]),
                   accept_lo=len(order) - int(accept.sum()))


def nfa_kernel_tables(class_of_byte, masks, start_bits: int,
                      accept_bits: int, anchored_start: bool,
                      anchored_end: bool, nullable: bool,
                      dfa_max_states: int = DFA_MAX_STATES,
                      end_newline: bool = False) -> NfaKernelTables:
    """The ``nfa_match`` kernel's tables for one NFA (``class_of_byte``
    int (256,), ``masks`` (classes, states) of uint32 bit sets, numpy or
    CPU tensors), on the CPU: the byte-indexed DFA when the subset
    construction stays within ``dfa_max_states`` states, else the NFA
    path's chunked successor tables. Built once per pattern
    (``DeviceNfa.kernel_tables`` caches them)."""
    cls = np.asarray(class_of_byte, dtype=np.int64).reshape(-1)
    m = np.asarray(masks, dtype=np.int64) & 0xFFFFFFFF
    n_classes, n_states = m.shape
    end_newline = bool(end_newline and anchored_end)
    built_for = (int(start_bits), int(accept_bits), bool(anchored_start),
                 bool(anchored_end), bool(nullable), n_classes, n_states,
                 end_newline)
    succ = _nfa_steps(m, n_states)                       # (C, S)
    cont = (np.arange(256) & 0xC0) == 0x80               # continuation
    nl_class = None
    dfa_cls, dfa_succ = cls, succ
    if end_newline:
        # the DFA's own class for the newline: its states tell apart a
        # row that ended just after one
        nl_class = n_classes
        dfa_succ = np.concatenate([succ, succ[cls[10]][None]])
        dfa_cls = cls.copy()
        dfa_cls[10] = nl_class
    dfa = _subset_dfa(dfa_succ, int(start_bits), int(accept_bits),
                      anchored_start, anchored_end, nullable,
                      min(dfa_max_states, 256), nl_class)
    if dfa is not None:
        trans, accept, sinks = dfa
        # renumber: sinks last, so "settled" is one compare in the kernel
        order = [i for i in range(len(trans)) if i not in sinks] \
            + sorted(sinks)
        new = np.empty(len(order), np.int64)
        new[order] = np.arange(len(order))
        trans = new[trans[order]]
        accept = accept[order]
        n = len(order)
        table = np.where(cont[None, :], np.arange(n)[:, None],
                         trans[:, dfa_cls])              # (n, 256)
        blob = np.concatenate([table.astype(np.uint8).reshape(-1),
                               accept.astype(np.uint8)])
        return NfaKernelTables(
            blob=_padded(blob), dfa=True, n_states=n,
            init_state=int(new[0]), sink_lo=n - len(sinks),
            chunk_bits=0, n_chunks=0, built_for=built_for)
    bits = 8
    if (n_classes + 1) * -(-n_states // 8) * 1024 > _NFA_TABLE_BYTES_8BIT:
        bits = 4
    n_chunks = -(-n_states // bits)
    v = np.arange(1 << bits, dtype=np.int64)
    tables = np.zeros((n_classes + 1, n_chunks, 1 << bits), np.int64)
    for k in range(n_chunks):
        for i in range(bits):
            s = k * bits + i
            if s < n_states:
                on = ((v >> i) & 1).astype(bool)
                tables[:n_classes, k] |= np.where(on[None, :],
                                                  succ[:, s][:, None], 0)
        # the identity class: the chunk's own states, in place
        tables[n_classes, k] = (v << (k * bits)) & 0xFFFFFFFF
    if not anchored_start:
        tables[:n_classes, 0] |= int(start_bits)
    cls16 = np.where(cont, n_classes, cls).astype(np.uint16)
    blob = np.concatenate([cls16.view(np.uint8),
                           tables.astype(np.uint32).reshape(-1)
                           .view(np.uint8)])
    return NfaKernelTables(
        blob=_padded(blob), dfa=False, n_states=n_states, init_state=0,
        sink_lo=0, chunk_bits=bits, n_chunks=n_chunks, built_for=built_for)


def _padded(blob: np.ndarray) -> torch.Tensor:
    """``blob`` as a uint8 tensor padded to a multiple of 16 bytes (the
    kernel copies it in 16-byte pieces)."""
    out = np.zeros(-(-len(blob) // 16) * 16, np.uint8)
    out[:len(blob)] = blob
    return torch.from_numpy(out)


def nfa_match(values: torch.Tensor, lengths: torch.Tensor,
              class_of_byte: torch.Tensor, masks: torch.Tensor,
              start_bits: int, accept_bits: int, anchored_start: bool,
              anchored_end: bool, nullable: bool,
              kernel_tables: Optional[NfaKernelTables] = None,
              end_newline: bool = False) -> torch.Tensor:
    """Per row of the padded string matrix ``values`` (uint8 ``(n, w)``,
    byte ``lengths`` int32 ``(n,)``): does the byte-class NFA accept, with
    find() semantics (kernel: csrc/nfa_match.cu, replacing the XLA scan of
    ``spark_rapids_tpu/expr/regex.py`` ``DeviceNfa.matches``).
    ``class_of_byte`` is int32 ``(256,)``; ``masks`` int64 ``(classes,
    states)`` holding uint32 bit sets, at most 32 states; the start state
    never accepts (an empty match is ``nullable``). ``end_newline``: a
    regex ``$``, which also matches before a final ``\\n``. Returns bool
    ``(n,)``.

    On a CUDA device the kernel walks ``kernel_tables``, the tables of
    ``nfa_kernel_tables`` for these arguments on that device; when it is
    None they are built here from a host copy of ``class_of_byte`` and
    ``masks`` (a device-to-host copy: ``DeviceNfa.kernel_tables`` caches
    them per pattern instead)."""
    if values.dtype != torch.uint8 or values.dim() != 2 \
            or not values.is_contiguous():
        raise TypeError(f"nfa_match: values must be a contiguous 2-D uint8 "
                        f"tensor, got {values.dtype} {tuple(values.shape)}")
    n, w = values.shape
    checks = (("lengths", lengths, torch.int32, (n,)),
              ("class_of_byte", class_of_byte, torch.int32, (256,)),
              ("masks", masks, torch.int64, None))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or (shape is not None
                                and tuple(t.shape) != shape):
            raise TypeError(f"nfa_match: {name} must be {dtype} of shape "
                            f"{shape or '(classes, states)'}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != values.device:
            raise ValueError(f"nfa_match: {name} is on {t.device}, values "
                             f"on {values.device}")
    if masks.dim() != 2 or not 1 <= masks.shape[1] <= 32 \
            or not 1 <= masks.shape[0] <= 256:
        raise ValueError(f"nfa_match: masks must be (1..256 classes, "
                         f"1..32 states), got {tuple(masks.shape)}")
    if start_bits & accept_bits:
        raise ValueError("nfa_match: the start state must not accept (an "
                         "empty match is `nullable`)")
    if values.device.type == "cpu":
        return nfa_match_reference(values, lengths, class_of_byte, masks,
                                   start_bits, accept_bits, anchored_start,
                                   anchored_end, nullable, end_newline)
    if values.device.type != "cuda":
        raise TypeError(f"nfa_match: no kernel for device {values.device}")
    end_newline = bool(end_newline and anchored_end)
    built_for = (int(start_bits), int(accept_bits), bool(anchored_start),
                 bool(anchored_end), bool(nullable), *masks.shape,
                 end_newline)
    if kernel_tables is None:
        kernel_tables = nfa_kernel_tables(
            class_of_byte.cpu().numpy(), masks.cpu().numpy(),
            *built_for[:5], end_newline=end_newline).to(values.device)
    tab = kernel_tables
    if tab.built_for != built_for or tab.blob.device != values.device \
            or tab.blob.dtype != torch.uint8 or not tab.blob.is_contiguous() \
            or tab.blob.data_ptr() % 16 or tab.blob.numel() % 16:
        raise ValueError(f"nfa_match: kernel_tables were built for "
                         f"{tab.built_for} on {tab.blob.device}, not "
                         f"{built_for} on {values.device}")
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if n == 0:
        return out
    lengths = lengths.contiguous()
    flags = (int(anchored_start) | int(anchored_end) << 1
             | int(nullable) << 2 | int(end_newline) << 3)
    from ..native import launch
    launch(nfa_match, "srt_nfa_match", values.device, values.data_ptr(),
           lengths.data_ptr(), n, w, tab.blob.data_ptr(), tab.blob.numel(),
           int(tab.dfa), tab.init_state, tab.sink_lo, tab.n_states * 256,
           tab.chunk_bits, tab.n_chunks, start_bits, accept_bits, flags,
           out.data_ptr())
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
nfa_match.launches = 0
