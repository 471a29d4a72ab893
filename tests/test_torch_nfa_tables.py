"""The ``nfa_match`` kernel's tables (``udf/kernels.py nfa_kernel_tables``:
the byte-indexed DFA and the NFA path's chunked successor tables) walked in
numpy exactly as csrc/nfa_match.cu walks them: chunks of C bytes, aligned
16-byte pieces with the bytes outside the row made 0x80, a row settled at
a sink. Each walk equals ``nfa_match_reference`` and the JAX package's
``DeviceNfa.matches`` for every pattern of the NFA subset, on random UTF-8
matrices, including patterns past the DFA cap and 4-bit chunk tables."""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.expr import regex as jregex

from spark_rapids_tpu_torch.expr import regex
from spark_rapids_tpu_torch.udf.kernels import (DFA_MAX_STATES,
                                                nfa_kernel_tables,
                                                nfa_match_reference)

from test_torch_regex import _SUBSET

#: past the DFA cap (the unanchored a[ab]{6} needs 2^7 subsets), and a
#: literal whose NFA tables take 4-bit chunks (32 classes, 32 states)
_BIG = ["a[ab][ab][ab][ab][ab][ab]", "(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)$",
        "abcdefghijklmnopqrstuvwxyz01234"]
_CHARS = list("ab abcxyz019_-.# \n\r\t") + ["é", "ß", "中", "😀"]
_WORDS = ["ab", "abc", "special", "requests", "Customer", "Complaints",
          "aab", "cd", "abababa"]


def _matrix(n: int, w: int, seed: int):
    """Random UTF-8 rows (one in eight empty, one in eight of length ``w``)
    in the device layout, with random bytes past each row's length."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 256, (n, w)).astype(np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        kind = rng.random()
        if kind < 0.125:
            continue
        target = w if kind < 0.25 else int(rng.integers(1, w + 1))
        b = b""
        while True:
            part = (_WORDS[rng.integers(len(_WORDS))] if rng.random() < 0.2
                    else _CHARS[rng.integers(len(_CHARS))]).encode()
            if len(b) + len(part) > target:
                b += b"z" * (target - len(b)) if kind < 0.25 else b""
                break
            b += part
        values[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return values, lengths


def kernel_walk(values: np.ndarray, lengths: np.ndarray, tab, flags,
                offset: int = 0, end_newline: bool = False) -> np.ndarray:
    """csrc/nfa_match.cu's walk in numpy, all rows in step. ``offset`` is
    the byte address of row 0 modulo 16 (a view's alignment);
    ``end_newline`` a regex `$` (the NFA path's flag ``nl``: the last
    character a newline read where the set before accepted)."""
    start_bits, accept_bits, anchored_start, anchored_end, nullable = flags
    n, w = values.shape
    blob = tab.blob.numpy()
    chunk = 32 if w <= 32 else 64 if w <= 64 else 128
    ln = np.clip(lengths.astype(np.int64), 0, w)
    m = (offset + np.arange(n, dtype=np.int64) * w) % 16
    if tab.dfa:
        table = blob[:tab.n_states * 256].astype(np.int64)
        accept = blob[tab.n_states * 256:tab.n_states * 257]
        state = np.full(n, tab.init_state, np.int64)
        active = (ln > 0) & (state < tab.sink_lo)
    else:
        cls = blob[:512].view(np.uint16).astype(np.int64)
        succ = blob[512:].view(np.uint32).astype(np.int64)
        bits, chunks = tab.chunk_bits, tab.n_chunks
        state = np.full(n, start_bits, np.int64)
        seen = np.zeros(n, np.int64)
        nl = np.zeros(n, bool)
        at0 = np.full(n, nullable)
        active = (ln > 0) & (not (nullable and not anchored_end))
    rows = np.arange(n)
    for k in range(-(-w // chunk)):
        lo = k * chunk
        hi = np.minimum(ln, lo + chunk)
        span = m + (hi - lo)                  # row bytes in the slot
        walking = active & (ln > lo)
        for q in range(chunk // 16 + 1):
            on = walking & (16 * q < span)
            for i in range(16):
                pos = lo + 16 * q + i - m
                inside = (pos >= lo) & (pos < hi)
                byte = np.where(inside, values[rows, np.clip(pos, 0, w - 1)],
                                0x80).astype(np.int64)
                if tab.dfa:
                    state = np.where(on, table[state * 256 + byte], state)
                else:
                    c = cls[byte]
                    if end_newline:
                        lead = on & ((byte & 0xC0) != 0x80)
                        took = ((state & accept_bits) != 0) | at0
                        nl = np.where(lead, (byte == 10) & took, nl)
                        at0 &= ~lead
                    nxt = np.zeros(n, np.int64)
                    for j in range(chunks):
                        v = (state >> (j * bits)) & ((1 << bits) - 1)
                        nxt |= succ[((c * chunks + j) << bits) + v]
                    state = np.where(on, nxt, state)
                    seen = np.where(on, seen | nxt, seen)
            if tab.dfa:
                settled = state >= tab.sink_lo
            else:
                settled = ((seen & accept_bits) != 0) & (not anchored_end)
                if anchored_start:
                    settled |= (state == 0) & ~nl
            stop = on & settled
            active &= ~stop
            walking &= ~stop
    if tab.dfa:
        got = accept[state] != 0
    elif anchored_end:
        got = ((state & accept_bits) != 0) | nl
    else:
        got = nullable | ((seen & accept_bits) != 0)
    return np.where(ln == 0, nullable, got)


def _jax_matches(pattern: str, values, lengths) -> np.ndarray:
    jnfa = jregex.compile_device_nfa(pattern)
    return np.asarray(jnfa.matches(
        types.SimpleNamespace(xp=jnp),
        types.SimpleNamespace(values=jnp.asarray(values),
                              lengths=jnp.asarray(lengths))))


def _flags(nfa):
    return (nfa.start_bits, nfa.accept_bits, nfa.anchored_start,
            nfa.anchored_end, nfa.nullable)


@pytest.mark.parametrize("width", [8, 64, 200])
@pytest.mark.parametrize("pattern", _SUBSET + _BIG)
def test_table_walks_equal_plain_version_and_jax(pattern, width):
    values, lengths = _matrix(160, width, width * 7 + len(pattern))
    nfa = regex.compile_device_nfa(pattern)
    cls, masks = nfa.tables("cpu")
    want = nfa_match_reference(torch.from_numpy(values),
                               torch.from_numpy(lengths), cls, masks,
                               *_flags(nfa)).numpy()
    np.testing.assert_array_equal(want, _jax_matches(pattern, values,
                                                     lengths))
    paths = {}
    for cap in (DFA_MAX_STATES, 0):
        tab = nfa_kernel_tables(nfa.class_of_byte, nfa.masks, *_flags(nfa),
                                dfa_max_states=cap)
        paths["dfa" if tab.dfa else f"nfa{tab.chunk_bits}"] = tab
        for offset in (0, 5):
            got = kernel_walk(values, lengths, tab, _flags(nfa), offset)
            np.testing.assert_array_equal(got, want, err_msg=f"{cap} "
                                          f"{offset}")
    assert "nfa8" in paths or "nfa4" in paths
    if pattern in _BIG[:2]:
        assert "dfa" not in paths      # past the cap: the NFA path only
    else:
        assert "dfa" in paths
    if pattern == _BIG[2]:
        assert "nfa4" in paths


def test_dfa_tables_are_minimal_and_sinks_last():
    """Q13's LIKE (19 NFA states, anchored at both ends) gives a 17-state
    DFA, the minimised subset construction, whose one sink, last, is the
    empty set (a NUL byte, outside LIKE's ``.``, kills the match); an
    unanchored pattern's last state is the find() match sink; continuation
    bytes map each state to itself."""
    from spark_rapids_tpu_torch.expr.base import AttributeReference, Literal
    from spark_rapids_tpu_torch.expr.strings import Like
    nfa = Like(AttributeReference("s"),
               Literal("%special%requests%")).device_nfa()
    tab = nfa_kernel_tables(nfa.class_of_byte, nfa.masks, *_flags(nfa))
    assert tab.dfa and tab.n_states == 17 and tab.sink_lo == 16
    table = tab.blob.numpy()[:17 * 256].reshape(17, 256)
    cont = (np.arange(256) & 0xC0) == 0x80
    assert (table[:, cont] == np.arange(17)[:, None]).all()
    assert (table[:, 0] == 16).all() and (table[16] == 16).all()
    assert tab.blob.numpy()[17 * 256 + 16] == 0
    unanchored = regex.compile_device_nfa("special")
    tab = nfa_kernel_tables(unanchored.class_of_byte, unanchored.masks,
                            *_flags(unanchored))
    t = tab.blob.numpy()[:tab.n_states * 256].reshape(tab.n_states, 256)
    assert tab.sink_lo == tab.n_states - 1
    assert (t[tab.sink_lo] == tab.sink_lo).all()
    assert tab.blob.numpy()[tab.n_states * 256 + tab.sink_lo] == 1


#: `$` patterns, anchored at the start or not, nullable or not, one past
#: the DFA cap
_DOLLAR = ["b$", "^ab$", "^$", "^(ab|c)*x?$", "(ab|c)*x?$", "(a|b)*c{1,3}$",
           "[a-z]+\n$",
           "^.*b$", "(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)$"]


@pytest.mark.parametrize("width", [8, 64])
@pytest.mark.parametrize("pattern", _DOLLAR)
def test_dollar_before_a_final_newline_on_both_paths(pattern, width):
    """A regex `$` (``end_newline``): both kernel paths' walks equal the
    plain version, and on rows ending in a newline Python's re.search (the
    host engines'); the DFA's tables for it differ from those of the same
    NFA with a strict end (LIKE's), and are cached apart."""
    values, lengths = _matrix(300, width, width * 3 + len(pattern))
    ends = [b"ab\n", b"\n", b"b\n\n", b"ab", b"xb\r\n", b"c\n", b"aabc\n"]
    for i, e in enumerate(ends):
        values[i, :len(e)] = np.frombuffer(e, np.uint8)
        lengths[i] = len(e)
    nfa = regex.compile_device_nfa(pattern)
    assert nfa.end_newline
    cls, masks = nfa.tables("cpu")
    want = nfa_match_reference(torch.from_numpy(values),
                               torch.from_numpy(lengths), cls, masks,
                               *_flags(nfa), end_newline=True).numpy()
    if not (nfa.nullable and not nfa.anchored_start):
        # (a pattern that is: nfa_match takes no late empty match; RLIKE
        # answers it without the kernel, matches_every_row)
        for i, e in enumerate(ends):
            assert want[i] == (re.search(pattern, e.decode()) is not None), e
    paths = set()
    for cap in (DFA_MAX_STATES, 0):
        tab = nfa_kernel_tables(nfa.class_of_byte, nfa.masks, *_flags(nfa),
                                dfa_max_states=cap, end_newline=True)
        strict = nfa_kernel_tables(nfa.class_of_byte, nfa.masks,
                                   *_flags(nfa), dfa_max_states=cap)
        assert tab.built_for != strict.built_for
        paths.add(tab.dfa)
        for offset in (0, 5):
            got = kernel_walk(values, lengths, tab, _flags(nfa), offset,
                              end_newline=True)
            np.testing.assert_array_equal(got, want, err_msg=f"{cap}")
    assert paths == ({False} if pattern == _DOLLAR[-1] else {True, False})
