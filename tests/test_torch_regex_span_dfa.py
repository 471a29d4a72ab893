"""The span DFA of the regex kernels (``udf/kernels.py span_dfa``, in
``expr/regex_kernels.py regex_program``), and three faults of the port
against Spark, repaired.

The span DFA: stepped from every start of random rows (numpy, from a seed)
until its dead state or the row's end, keeping the last accepting
position, it gives the JAX package's ``DeviceNfa.match_ends`` on every
span-subset pattern of ``tests/test_torch_regex_spans.py`` and of the
kernels' cases, and with the port's `$` (a match may also stop before a
final newline) the port's ``match_ends``. ST1's patterns stay within the
DFA's 256-state cap; the pattern past it leaves the program without one.
Tolerance: exact.

The faults (ROADMAP Queue 3 items 7-9), each on the port's device path (on
the CPU: its plain tensor code) and its host engine:
- a cast of -2^63 (and 2^63-1, +-10^18) to DECIMAL(p <= 18) is null, as
  in Spark's non-ANSI cast; the JAX package raises (ArrowInvalid) on these
  casts, a reference fault;
- lpad/rpad with an empty pad cut the string to the target or leave it,
  as Spark's UTF8String.lpad/rpad; the JAX device path pads with spaces, a
  reference fault;
- a regex `$` also matches before a final "\\n" (Python's and Java's rule
  for "\\n"), four ways: the port's device path equals both host engines;
  the JAX device path's strict end is a reference fault; LIKE's end stays
  strict; before "\\r\\n" Java's `$` matches and Python's does not, a
  written difference from Spark kept on every path."""
import re
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.expr import regex as JR
from spark_rapids_tpu.session import TpuSession

import chip_smoke as cs
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.expr import regex as TR
from spark_rapids_tpu_torch.expr.regex_kernels import (_without_span_dfa,
                                                       extract_program,
                                                       replace_program)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf.kernels import SPAN_DFA_MAX_STATES, span_dfa

from test_torch_regex_spans import _PATTERNS, _rows
from test_torch_string_functions import _port_and_jax

#: ST1's span patterns (chip_smoke.py _st1_queries)
ST1_PATTERNS = ["[aeiou]+", "([0-9]+)-([0-9]+)",
                "([0-9]+)-([0-9]+)-([0-9]+)", "[0-9]+", "([a-z]+) ([a-z]+)$",
                "[a-z]+"]
_SPAN = sorted({p for p in _PATTERNS + ST1_PATTERNS
                + [p for p, _ in cs.REGEX_EXTRACT_CASES]
                + [p for p, _ in cs.REGEX_REPLACE_CASES if isinstance(p, str)]
                if p != cs.REGEX_PAST_CAP})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strict_end(nfa, lens: np.ndarray, w: int):
    """Where the JAX package lets a match anchored at the end stop: the
    row's last byte alone."""
    if not nfa.anchored_end:
        return None
    return np.arange(w)[None, :] == (lens - 1)[:, None]


def _longest_ends(dfa, class_of_byte, values: np.ndarray,
                  lengths: np.ndarray, at_end=None,
                  anchored_start: bool = False) -> np.ndarray:
    """The end (exclusive) of the longest match from every start of every
    row, or -1 (int32 ``(n, w)``): ``dfa`` stepped from each start (start
    0 alone, ``anchored_start``) until the dead state or the row's end,
    keeping the last accepting position (where ``at_end``, bool ``(n,
    w)``, allows one: a pattern anchored at the end). What the regex
    kernels compute, in numpy."""
    n, w = values.shape
    cls = np.asarray(class_of_byte, np.int64)[values]
    ln = np.clip(lengths.astype(np.int64), 0, w)
    ends = np.full((n, w), -1, np.int32)
    state = np.full((n, w), dfa.init, np.int64)      # [row, start]
    if anchored_start:
        state[:, 1:] = 0
    starts = np.arange(w)[None, :]
    for t in range(w):
        p = starts + t
        live = (p < ln[:, None]) & (state != 0)
        if not live.any():
            break
        c = np.take_along_axis(cls, np.clip(p, 0, w - 1), axis=1)
        state = np.where(live, dfa.trans[state, c], state)
        ok = live & (state >= dfa.accept_lo)
        if at_end is not None:
            ok &= np.take_along_axis(at_end, np.clip(p, 0, w - 1), axis=1)
        ends = np.where(ok, p + 1, ends).astype(np.int32)
        state = np.where(live, state, 0)
    return ends


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("pattern", _SPAN)
def test_span_dfa_longest_ends_equal_match_ends(pattern, width):
    vals, lens = _rows(240, width, width + len(pattern))
    jn, tn = JR.compile_device_nfa(pattern), TR.compile_device_nfa(pattern)
    assert tn.spans_supported
    dfa = span_dfa(tn.masks, tn.start_bits, tn.accept_bits)
    assert dfa is not None and dfa.n_states <= SPAN_DFA_MAX_STATES
    want = np.asarray(jn.match_ends(jnp, jnp.asarray(vals),
                                    jnp.asarray(lens)))
    got = _longest_ends(dfa, tn.class_of_byte, vals, lens,
                        _strict_end(tn, lens, width), tn.anchored_start)
    np.testing.assert_array_equal(got, want)
    tv, tl = torch.from_numpy(vals), torch.from_numpy(lens)
    at_end = tn.end_positions(tv, tl)
    got = _longest_ends(dfa, tn.class_of_byte, vals, lens,
                        None if at_end is None else at_end.numpy(),
                        tn.anchored_start)
    np.testing.assert_array_equal(got, tn.match_ends(tv, tl).numpy())


def test_span_dfa_numbers_dead_first_and_accepting_last():
    """'[aeiou]+': dead 0, the start 1, one accepting state 2 (the runs'
    continuation); every state stepped on a consonant goes dead."""
    nfa = TR.compile_device_nfa("[aeiou]+")
    dfa = span_dfa(nfa.masks, nfa.start_bits, nfa.accept_bits)
    assert (dfa.n_states, dfa.init, dfa.accept_lo) == (3, 1, 2)
    vowel, other = nfa.class_of_byte[ord("a")], nfa.class_of_byte[ord("x")]
    assert list(dfa.trans[:, vowel]) == [0, 2, 2]
    assert list(dfa.trans[:, other]) == [0, 0, 0]


@pytest.mark.parametrize("pattern", ST1_PATTERNS)
def test_st1_patterns_stay_within_the_cap(pattern):
    """Each ST1 pattern's program carries its span DFA (the kernels step
    it, not the NFA's sets), its size reported by the builder."""
    prog = extract_program(pattern, 0)
    assert 0 < prog.dfa_states <= SPAN_DFA_MAX_STATES
    assert prog.dfa_states == span_dfa(
        prog.matcher.masks, prog.matcher.start_bits,
        prog.matcher.accept_bits).n_states


def test_a_dfa_past_its_cap_leaves_the_nfa_sets():
    """[ab]*a[ab]{8} needs 2^9 subsets from one start: no span DFA in its
    program (the kernels step the NFA's successor sets); 7 [ab] need
    2^8 + 1 (the dead set) and pass the cap too, 6 fit."""
    nfa = TR.compile_device_nfa(cs.REGEX_PAST_CAP)
    assert nfa.spans_supported
    assert span_dfa(nfa.masks, nfa.start_bits, nfa.accept_bits) is None
    assert replace_program(cs.REGEX_PAST_CAP, "#").dfa_states == 0
    assert extract_program(cs.REGEX_PAST_CAP, 0).dfa_states == 0
    fits = TR.compile_device_nfa("[ab]*a[ab][ab][ab][ab][ab][ab]")
    assert span_dfa(fits.masks, fits.start_bits,
                    fits.accept_bits).n_states == 129
    assert _without_span_dfa(replace_program("[0-9]+", "#")).dfa_states \
        == 0


# -- Queue 3 item 7: a cast of -2^63 to a decimal -----------------------------
_EXTREMES = [-2 ** 63, 2 ** 63 - 1, 10 ** 18, -10 ** 18]


@pytest.mark.parametrize("scale", [0, 2])
@pytest.mark.parametrize("precision", [5, 10, 12, 18])
def test_cast_of_int64_extremes_to_a_decimal_is_null(precision, scale):
    """Past the precision the cast is null on the port's device path and
    its host engine (Spark's non-ANSI cast); the largest value that fits
    stays. abs(-2^63) wraps to itself: a bound tested on abs lets it pass
    and the multiply wraps (0.00, or -2^63). The JAX package raises on
    these casts (ArrowInvalid: a reference fault), so the port is held to
    its host engine and Spark."""
    top = 10 ** (precision - scale) - 1
    vals = _EXTREMES + [top, -top]
    table = pa.table({"x": pa.array(vals, pa.int64())})
    q = TorchSession({}, device="cpu").create_dataframe(
        table, num_partitions=2).select(
        F.col("x").cast(dt.DecimalType(precision, scale)).alias("d"))
    want = [None] * 4 + [Decimal(v * 10 ** scale).scaleb(-scale)
                         for v in (top, -top)]
    assert q.collect().column("d").to_pylist() == want
    assert q.collect(device=False).column("d").to_pylist() == want
    jq = TpuSession({}).create_dataframe(table).select(
        JF.col("x").cast(jdt.DecimalType(precision, scale)).alias("d"))
    with pytest.raises(pa.ArrowInvalid):
        jq.collect(device=True)


# -- Queue 3 item 8: lpad/rpad with an empty pad ------------------------------
_PAD_ROWS = ["ab", "abcd", "", "abcdef"]


def test_pads_with_an_empty_pad_cut_or_keep_the_string():
    """Targets below, at and above the lengths: the string cut to the
    target, or as it is where it is shorter, on the port's device path
    and both host engines (Spark's UTF8String.lpad/rpad); the JAX device
    path pads with spaces (a reference fault)."""
    dev, host, jdev, jhost = _port_and_jax(
        pa.table({"s": _PAD_ROWS}), lambda M: [
            M.lpad(M.col("s"), k, "").alias(f"l{k}") for k in (0, 2, 4, 6)]
        + [M.rpad(M.col("s"), k, "").alias(f"r{k}") for k in (0, 2, 4, 6)])
    for k in (0, 2, 4, 6):
        want = [s[:k] for s in _PAD_ROWS]
        for got in (dev, host, jhost):
            assert got.column(f"l{k}").to_pylist() == want, k
            assert got.column(f"r{k}").to_pylist() == want, k
    assert jdev.column("r4").to_pylist()[0] == "ab  "
    assert jdev.column("l4").to_pylist()[0] == "  ab"


# -- Queue 3 item 9: `$` before a final newline -------------------------------
_NL_ROWS = ["ab\n", "ab", "ab\n\n", "b\n", "\n", "ab\r\n"]


def _nl_columns(M):
    s = M.col("s")
    return [s.rlike("b$").alias("r1"), s.rlike("(b)$").alias("r2"),
            M.regexp_replace(s, "b$", "X").alias("p1"),
            M.regexp_replace(s, "(b)$", "<$1>").alias("p2"),
            M.regexp_extract(s, "b$", 0).alias("e1"),
            M.regexp_extract(s, "(b)$", 1).alias("e2"),
            s.like("%b").alias("like")]


def _python(pattern: str, kind: str, rows=_NL_ROWS, strict=False) -> list:
    """Python's re on each row (``strict``: `$` at the end alone, as the
    JAX device path has it)."""
    pat = pattern.replace("$", r"\Z") if strict else pattern
    out = []
    for s in rows:
        m = re.search(pat, s)
        if kind == "rlike":
            out.append(m is not None)
        elif kind == "extract":
            out.append(m.group(1 if "(" in pattern else 0) if m else "")
        else:
            out.append(re.sub(pat, "X" if "(" not in pattern else r"<\1>", s))
    return out


def test_dollar_matches_before_a_final_newline_four_ways():
    dev, host, jdev, jhost = _port_and_jax(pa.table({"s": _NL_ROWS}),
                                           _nl_columns)
    cols = {"r1": ("b$", "rlike"), "r2": ("(b)$", "rlike"),
            "p1": ("b$", "replace"), "p2": ("(b)$", "replace"),
            "e1": ("b$", "extract"), "e2": ("(b)$", "extract")}
    for name, (pattern, kind) in cols.items():
        want = _python(pattern, kind)
        for got in (dev, host, jhost):
            assert got.column(name).to_pylist() == want, name
        # the JAX device path's strict end (a reference fault)
        assert jdev.column(name).to_pylist() == _python(pattern, kind,
                                                        strict=True), name
    assert dev.column("r1").to_pylist() == [True, True, False, True, False,
                                            False]
    assert dev.column("p1").to_pylist()[0] == "aX\n"
    assert dev.column("e2").to_pylist()[0] == "b"
    # "\r\n": Java's `$` would match before it, Python's (both host
    # engines) does not; every path keeps Python's (ROADMAP Queue 3 item 4)
    assert dev.column("r1").to_pylist()[5] is False
    # LIKE's end stays strict: "ab\n" LIKE "%b" is false in Spark
    assert dev.column("like").to_pylist()[0] is False
    assert host.column("like").to_pylist()[0] is False
