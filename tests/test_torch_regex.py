"""The port's regex parser, NFA compiler and ``nfa_match`` plain version
against the JAX package's ``spark_rapids_tpu/expr/regex.py``, and LIKE on
strings with line terminators (Spark's answer on both of the port's paths,
where the JAX device path misses ``\\n`` and ``\\r``)."""
import re
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import regex as jregex
from spark_rapids_tpu.expr.functions import col as jcol
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import regex
from spark_rapids_tpu_torch.expr.functions import col
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf.kernels import nfa_match_reference

_PATTERNS = [
    "abc", "a.b", "^a$", "^abc", "abc$", "a*b+c?", "a{2,3}", "a{2}", "a{,3}",
    "a{2,}", "[a-z0-9_]+", "[^abc]", r"\d\w\s\D\W\S", "(ab|cd)*", "(?:ab)+",
    "a|b|", r"\n\t\r", "a+?", "[]a]", r"[a\]]", r"[\d-]", "a-b", "",
    "^.*special.*requests.*$", "^.*Customer.*Complaints.*$", "(a|b)*c{1,3}$",
    r"x\.y", "^$", "[.]", "(((a)))", "^(ab|c)*x?$", "a{0}", "a{0,0}b",
    # rejected by both
    "a++", "(?=a)", "(?<n>a)", r"\1", r"\p{L}", r"\b", "é", "[é]", "a{x}",
    "(a", "a)", "*a", "[a-", r"\0", "\\", "a^b", "a$b", "[a-é]",
]
_SUBSET = [p for p in _PATTERNS if jregex.compile_device_nfa(p) is not None]


def _ast(node):
    """An AST as nested tuples of plain values (the two packages' node
    classes differ)."""
    if isinstance(node, list):
        return tuple(_ast(n) for n in node)
    if hasattr(node, "__dataclass_fields__"):
        return (type(node).__name__,) + tuple(
            _ast(getattr(node, f)) for f in node.__dataclass_fields__)
    if isinstance(node, frozenset):
        return tuple(sorted(node))
    return node


@pytest.mark.parametrize("pattern", _PATTERNS)
def test_parser_accepts_and_rejects_as_the_jax_one(pattern):
    try:
        want = _ast(jregex.RegexParser(pattern).parse())
    except jregex.RegexUnsupported:
        with pytest.raises(regex.RegexUnsupported):
            regex.RegexParser(pattern).parse()
        with pytest.raises(regex.RegexUnsupported):
            regex.transpile(pattern)
        return
    assert _ast(regex.RegexParser(pattern).parse()) == want
    assert regex.transpile(pattern) == jregex.transpile(pattern)


def _same_nfa(a, b):
    np.testing.assert_array_equal(a.class_of_byte, b.class_of_byte)
    np.testing.assert_array_equal(a.masks, b.masks)
    for f in ("start_bits", "accept_bits", "anchored_start", "anchored_end",
              "nullable", "ascii_only", "has_alt", "min_len"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("pattern", _PATTERNS)
def test_compiled_nfa_equals_the_jax_one(pattern):
    want = jregex.compile_device_nfa(pattern)
    got = regex.compile_device_nfa(pattern)
    if want is None:
        assert got is None
        return
    _same_nfa(got, want)
    assert got.class_of_byte.dtype == np.int32
    assert got.masks.dtype == np.uint32


@pytest.mark.parametrize("pattern", ["a.b", "^.*special.*requests.*$",
                                     "^.*Customer.*Complaints.*$", "^.$"])
def test_dotall_nfa_is_the_jax_one_with_every_character(pattern):
    """``dotall``'s ``.`` is the JAX parser's ``[\\s\\S]``: every character,
    line terminators included."""
    want = jregex.compile_device_nfa(pattern.replace(".", r"[\s\S]"))
    _same_nfa(regex.compile_device_nfa(pattern, dotall=True), want)


_CHARS = list("abcxyz019_-.# \n\r\t") + ["é", "ß", "中", "😀"]
_WORDS = ["ab", "abc", "special", "requests", "Customer", "Complaints",
          "aab", "cd"]


def _matrix(n: int, w: int, seed: int):
    """Random UTF-8 rows of up to ``w`` bytes (one in eight empty) as the
    device layout: uint8 (n, w), zero-padded, and int32 byte lengths."""
    rng = np.random.default_rng(seed)
    values = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        if rng.random() < 0.125:
            continue
        target = int(rng.integers(1, w + 1))
        b = b""
        while True:
            part = (_WORDS[rng.integers(len(_WORDS))] if rng.random() < 0.2
                    else _CHARS[rng.integers(len(_CHARS))]).encode()
            if len(b) + len(part) > target:
                break
            b += part
        values[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return values, lengths


@pytest.mark.parametrize("width", [8, 64])
@pytest.mark.parametrize("pattern", _SUBSET)
def test_plain_match_equals_jax_device_matches(pattern, width):
    values, lengths = _matrix(400, width, width + len(pattern))
    jnfa = jregex.compile_device_nfa(pattern)
    want = np.asarray(jnfa.matches(
        types.SimpleNamespace(xp=jnp),
        types.SimpleNamespace(values=jnp.asarray(values),
                              lengths=jnp.asarray(lengths))))
    nfa = regex.compile_device_nfa(pattern)
    v, ln = torch.from_numpy(values), torch.from_numpy(lengths)
    cls, masks = nfa.tables("cpu")
    got = nfa_match_reference(v, ln, cls, masks, nfa.start_bits,
                              nfa.accept_bits, nfa.anchored_start,
                              nfa.anchored_end, nfa.nullable)
    np.testing.assert_array_equal(got.numpy(), want)
    # DeviceNfa.matches on a CPU batch is the plain version, with the
    # port's `$` (end_newline): it also matches before a final "\n". On
    # such rows the JAX device path keeps its end strict (a reference
    # fault, ROADMAP Queue 3: the `$` before a final newline); there the
    # port equals the JAX host engine's re.search
    col_ = types.SimpleNamespace(values=v, lengths=ln)
    port = nfa.matches(None, col_)
    assert torch.equal(port, nfa_match_reference(
        v, ln, cls, masks, nfa.start_bits, nfa.accept_bits,
        nfa.anchored_start, nfa.anchored_end, nfa.nullable,
        nfa.end_newline))
    assert nfa.end_newline == nfa.anchored_end
    differ = np.flatnonzero(port.numpy() != want)
    for i in differ:
        s = values[i, :lengths[i]].tobytes().decode()
        assert nfa.end_newline and s.endswith("\n"), (pattern, s)
        assert bool(port[i]) == (re.search(pattern, s) is not None), s


# -- LIKE and line terminators --------------------------------------------------
_TERMINATOR_ROWS = ["a\nb", "axb", "a\rb", "ab"]
#: Spark's LIKE: ``%`` and ``_`` match every character
_SPARK = {"a%b": [True, True, True, True], "a_b": [True, True, True, False]}
#: the JAX package's device LIKE: its ``.`` leaves out \n and \r
_JAX_DEVICE_FAULT = {"a%b": [False, True, False, True],
                     "a_b": [False, True, False, False]}


@pytest.mark.parametrize("pattern", sorted(_SPARK))
def test_like_matches_line_terminators_as_spark_does(pattern):
    table = pa.table({"s": _TERMINATOR_ROWS})
    conf = {"spark.rapids.sql.test.enabled": True}
    sess = TorchSession(conf, device="cpu")
    q = sess.create_dataframe(table).select(col("s").like(pattern)
                                            .alias("m"))
    assert q.collect().column("m").to_pylist() == _SPARK[pattern]
    assert q.collect(device=False).column("m").to_pylist() == _SPARK[pattern]
    jq = TpuSession(conf).create_dataframe(table).select(
        jcol("s").like(pattern).alias("m"))
    assert jq.collect(device=False).column("m").to_pylist() \
        == _SPARK[pattern]
    # the documented JAX-package fault (ROADMAP Queue 3), not copied
    assert jq.collect(device=True).column("m").to_pylist() \
        == _JAX_DEVICE_FAULT[pattern]


def test_like_does_not_stop_before_a_trailing_newline():
    """``"ab\\n" LIKE "ab"`` is false in Spark. The JAX host engine's
    ``re.match`` lets ``$`` match before a final newline (ROADMAP Queue 3);
    the port's host engine uses ``fullmatch``."""
    table = pa.table({"s": ["ab\n", "ab", "xab\n"]})
    sess = TorchSession({"spark.rapids.sql.test.enabled": True},
                        device="cpu")
    for pattern, want in (("ab", [False, True, False]),
                          ("%a_", [False, True, False]),
                          ("%ab%", [True, True, True])):
        q = sess.create_dataframe(table).select(col("s").like(pattern)
                                                .alias("m"))
        assert q.collect().column("m").to_pylist() == want, pattern
        assert q.collect(device=False).column("m").to_pylist() == want
    jq = TpuSession({}).create_dataframe(table).select(
        jcol("s").like("ab").alias("m"))
    assert jq.collect(device=False).column("m").to_pylist() \
        == [True, True, False]
