"""The port's string functions (``expr/strings.py``) against the JAX
package: case mapping, lengths, reverse, trims, pads, repeat, concat,
concat_ws, locate and instr, ascii, chr, replace, substring_index, RLIKE,
regexp_extract, regexp_replace (with ``$n`` templates) and
get_json_object. Each query runs through the port's device path (on the
CPU: the kernels' plain versions), its host engine, and the JAX package's
device path and host engine, on the same Arrow table; the rows must be
equal exactly (``tests/harness.py assert_tables_equal``), and the port's
plan (``tree_string()``, its device and host placement) must equal the JAX
package's. The cases mirror ``tests/test_strings.py``,
``tests/test_regex_device.py`` and the JSON cases of
``tests/test_bitwise_json_pandas.py``.

Where the JAX device path leaves Spark, the port's decisions are pinned:
RLIKE takes the empty match at a row's end (``a*$`` matches "zz", as
Python's ``re.search`` and both host engines say; the JAX device path
says no); ``ascii`` gives the code point; ``locate`` counts characters and
reads a start of 0 as "not found"; case mapping and the pads stay
ASCII-exact on the device, as in the JAX package."""
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from harness import assert_tables_equal
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_CONF = {"spark.rapids.sql.test.enabled": True}
ASCII_WORDS = ["", "a", "AB", "abc", "tpu", "Spark", "RAPIDS", "xyzzy",
               "  padded  ", "MixedCase", "longer string value", "a b c",
               "%special_", "trailing  ", "  leading"]
UNICODE_WORDS = ["", "é", "héllo", "日本語", "mix日ed", "ünïcode", "a日b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread: the tests run in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ascii_table(seed: int = 0, n: int = 120) -> pa.Table:
    rng = np.random.default_rng(seed)
    w = np.array(ASCII_WORDS, dtype=object)
    return pa.table({"s": pa.array(w[rng.integers(0, len(w), n)],
                                   mask=rng.random(n) < 0.1),
                     "t": pa.array(w[rng.integers(0, len(w), n)])})


def _unicode_table(seed: int = 0, n: int = 60) -> pa.Table:
    rng = np.random.default_rng(seed)
    w = np.array(UNICODE_WORDS, dtype=object)
    return pa.table({"s": pa.array(w[rng.integers(0, len(w), n)])})


def _queries(table: pa.Table, build, conf=_CONF):
    sess = TorchSession(conf, device="cpu")
    jsess = TpuSession(conf)
    q = sess.create_dataframe(table, num_partitions=2).select(*build(F))
    jq = jsess.create_dataframe(table, num_partitions=2).select(*build(JF))
    return sess, q, jsess, jq


def four_ways(table: pa.Table, build, conf=_CONF) -> pa.Table:
    """``build(M)`` (a list of Columns of the functions module M) through
    the port's device path and host engine and the JAX package's two; all
    four equal, and the two plans alike. -> the port's device result."""
    sess, q, jsess, jq = _queries(table, build, conf)
    plan = sess._physical(q.logical, True)
    jplan = jsess._physical(jq.logical, True)
    assert plan.tree_string() == jplan.tree_string()
    dev = q.collect()
    for other in (q.collect(device=False), jq.collect(device=True),
                  jq.collect(device=False)):
        assert_tables_equal(dev, other, ignore_order=False)
    return dev


def _host_only(table: pa.Table, build, reason: str) -> pa.Table:
    """A query the rules keep on the host engine, in both packages (the
    port's explain gives ``reason``): equal rows four ways and alike
    plans."""
    conf = {}
    sess, q, jsess, jq = _queries(table, build, conf)
    assert reason in q.explain("device")
    assert "CpuProjectExec cannot run on TPU" in jq.explain("tpu")
    return four_ways(table, build, conf)


# ---------------------------------------------------------------------------
# tests/test_strings.py, through both packages
# ---------------------------------------------------------------------------

def test_case_mapping():
    four_ways(_ascii_table(), lambda M: [
        M.upper(M.col("s")).alias("u"), M.lower(M.col("s")).alias("l"),
        M.initcap(M.col("s")).alias("ic")])


def test_length_family_and_reverse_unicode():
    out = four_ways(_unicode_table(), lambda M: [
        M.col("s").alias("s"), M.length(M.col("s")).alias("chars"),
        M.octet_length(M.col("s")).alias("bytes"),
        M.bit_length(M.col("s")).alias("bits"),
        M.reverse(M.col("s")).alias("r")])
    for s, c, b, r in zip(*(out.column(k).to_pylist()
                            for k in ("s", "chars", "bytes", "r"))):
        assert (c, b, r) == (len(s), len(s.encode()), s[::-1])


def test_concat_trim_pad():
    four_ways(_ascii_table(1), lambda M: [
        M.concat(M.col("s"), M.lit("-"), M.col("t")).alias("cc"),
        M.trim(M.col("s")).alias("tr"), M.ltrim(M.col("s")).alias("ltr"),
        M.rtrim(M.col("s")).alias("rtr"),
        M.lpad(M.col("s"), 8, "*").alias("lp"),
        M.rpad(M.col("s"), 8, "xy").alias("rp"),
        M.repeat(M.col("s"), 2).alias("rep")])


def test_concat_ws_replace_substring_index():
    four_ways(_ascii_table(2), lambda M: [
        M.concat_ws(",", M.col("s"), M.col("t")).alias("cw"),
        M.replace(M.col("s"), "a", "_").alias("rep"),
        M.substring_index(M.col("s"), " ", 1).alias("si")])


def test_locate_instr_ascii_fn():
    four_ways(_ascii_table(3), lambda M: [
        M.locate("a", M.col("s")).alias("loc"),
        M.locate("a", M.col("s"), 2).alias("loc2"),
        M.instr(M.col("s"), "ar").alias("ins"),
        M.ascii(M.col("s")).alias("asc")])


def test_rlike_device_nfa():
    four_ways(_ascii_table(4), lambda M: [
        M.col("s").rlike("^[A-Z]").alias("anch"),
        M.col("s").rlike("a.c").alias("dot"),
        M.col("s").rlike("ing$").alias("end"),
        M.col("s").rlike("[0-9]+|[a-z]{3}").alias("alt"),
        M.col("s").rlike("Spa?rk").alias("opt")])


def test_regexp_extract_replace():
    four_ways(_ascii_table(5), lambda M: [
        M.regexp_extract(M.col("s"), "([a-z]+)", 1).alias("ex"),
        M.regexp_replace(M.col("s"), "[aeiou]", "#").alias("rr")])


def test_rlike_unicode_char_exact():
    t = pa.table({"s": ["xé", "é", "ab", "日本語", "aé日", ""]})
    four_ways(t, lambda M: [
        M.col("s").alias("s"), M.col("s").rlike("x.").alias("dot"),
        M.col("s").rlike("^.$").alias("one"),
        M.col("s").rlike("^[^a]+$").alias("neg"),
        M.col("s").rlike("a.$").alias("end")])


def test_pad_edge_cases():
    out = four_ways(pa.table({"s": ["abc", "x", ""]}), lambda M: [
        M.rpad(M.col("s"), 0, "*").alias("z"),
        M.lpad(M.col("s"), 2, "*").alias("trunc_l")])
    assert out.column("z").to_pylist() == ["", "", ""]
    assert out.column("trunc_l").to_pylist() == ["ab", "*x", "**"]


def test_device_replace_and_regex_spans():
    t = pa.table({"s": ["hello world", "aaa", "", "ab-12-xy", None,
                        "nums 123 456", "héllo wörld", "aa11bb22"]})
    out = four_ways(t, lambda M: [
        M.replace(M.col("s"), "l", "LL").alias("lit_grow"),
        M.replace(M.col("s"), "aa", "").alias("lit_shrink"),
        M.regexp_replace(M.col("s"), "[0-9]+", "#").alias("re_num"),
        M.regexp_replace(M.col("s"), "l+o?", "L").alias("re_greedy"),
        M.regexp_extract(M.col("s"), "[0-9]+", 0).alias("ex0")])
    assert out.column("re_num").to_pylist()[5] == "nums # #"
    assert out.column("ex0").to_pylist()[7] == "11"


@pytest.mark.parametrize("fn,args,reason", [
    ("regexp_replace", ("a|b", "#"), "spans are host-only"),
    ("regexp_replace", ("[0-9]+?", "#"), "spans are host-only"),
    ("regexp_replace", ("([0-9]+)([0-9]*)", "$1!"),
     "capture-group subset"),
    ("regexp_extract", (r"(\d+)(\d*)", 1), "capture-group subset"),
    ("regexp_replace", ("(ab|zz)-(\\d+)", "$2"), "spans are host-only"),
    ("get_json_object", ("$.a",), "host-only: JSON parsing")])
def test_span_and_json_fallbacks_keep_to_the_host(fn, args, reason):
    t = pa.table({"s": ["ab 12", "zz", "ab-12", None, '{"a": 1}']})
    _host_only(t, lambda M: [getattr(M, fn)(M.col("s"), *args).alias("r")],
               reason)


def test_concat_ws_substring_index_chr_on_device():
    t = pa.table({"s": pa.array(["a,b,c", "", "x", "no-delim", None,
                                 "a,,b", ",lead", "trail,"] * 4),
                  "u": pa.array(["α,β", "日,本,語", "a日,b", "é"] * 8),
                  "n": pa.array([65, 0, 200, 255, -1, 128, 1000, 10] * 4,
                                type=pa.int64())})
    got = four_ways(t, lambda M: [
        M.concat_ws("|", M.col("s"), M.col("u")).alias("cw"),
        M.substring_index(M.col("s"), ",", 2).alias("si2"),
        M.substring_index(M.col("s"), ",", -1).alias("sim1"),
        M.char(M.col("n")).alias("ch")])
    pdf = t.to_pandas()
    for i, (s, u, n) in enumerate(zip(pdf.s, pdf.u, pdf.n)):
        assert got.column("cw")[i].as_py() == "|".join(
            p for p in (s, u) if isinstance(p, str))
        assert got.column("ch")[i].as_py() == (chr(int(n) & 0xFF)
                                               if n >= 0 else "")


@pytest.mark.parametrize("cnt", [1, 2, -1, -2, 3, 0])
def test_substring_index_multibyte_delim_overlap(cnt):
    """Multi-byte delimiters match non-overlapping left to right: 'aaaa'
    split by 'aa' has exactly 2 occurrences."""
    t = pa.table({"s": pa.array(["aaaa", "aaa", "abababa", "xaax", "aa",
                                 "", "ab日ab日ab"] * 4)})
    got = four_ways(t, lambda M: [
        M.substring_index(M.col("s"), "aa", cnt).alias("a"),
        M.substring_index(M.col("s"), "ab", cnt).alias("b"),
        M.substring_index(M.col("s"), "ab日", cnt).alias("c")])
    for i, s in enumerate(t.column("s").to_pylist()):
        for name, d in (("a", "aa"), ("b", "ab"), ("c", "ab日")):
            parts = s.split(d)
            want = "" if cnt == 0 else d.join(
                parts[:cnt] if cnt > 0 else parts[cnt:])
            assert got.column(name)[i].as_py() == want, (s, d, cnt)


def test_concat_ws_all_null_and_empty():
    t = pa.table({"a": pa.array([None, None, "x"], type=pa.string()),
                  "b": pa.array([None, "y", None], type=pa.string())})
    got = four_ways(t, lambda M: [
        M.concat_ws("-", M.col("a"), M.col("b")).alias("c")])
    assert got.column("c").to_pylist() == ["", "y", "x"]


_GROUP_STRINGS = ["ab 12-345 x", "7-8", "no match", "-", "99-", "1-2-3",
                  "mail bob@site.com x", "v12.34 v999.1", "key:123", ""]


@pytest.mark.parametrize("pat,gi", [(r"(\d+)-(\d+)", 1),
                                    (r"(\d+)-(\d+)", 2),
                                    (r"([a-z]+)@([a-z]+)\.com", 2),
                                    (r"v(\d{1,3})\.(\d+)", 1),
                                    (r"^(\d+)-(\d+)$", 2)])
def test_regexp_extract_capture_groups_on_device(pat, gi):
    got = four_ways(pa.table({"s": _GROUP_STRINGS * 3}), lambda M: [
        M.regexp_extract(M.col("s"), pat, gi).alias("g")])
    for i, s in enumerate(_GROUP_STRINGS * 3):
        m = re.search(pat, s)
        assert got.column("g")[i].as_py() == (m.group(gi) if m else "")


_TEMPLATE_STRINGS = ["abc-123 def-456", "x-1", "nope", "", "zz-99 a-1 b-22",
                     "tail abc-7", "-", "ab-12cd-34"]


@pytest.mark.parametrize("pat,repl", [(r"([a-z]+)-(\d+)", "$2:$1"),
                                      (r"([a-z]+)-(\d+)", "[$0]"),
                                      (r"([a-z]+)-(\d+)", "$1"),
                                      (r"([a-z]+)-(\d+)", r"\$$2"),
                                      (r"([a-z]+)-(\d+)", "<$1-$2>"),
                                      (r"(\d)", "$1$1$1")])
def test_regexp_replace_group_refs(pat, repl):
    got = four_ways(pa.table({"s": _TEMPLATE_STRINGS}), lambda M: [
        M.regexp_replace(M.col("s"), pat, repl).alias("r")])
    pyrep = re.sub(r"\$(\d+)", r"\\g<\1>",
                   repl.replace("\\$", "\0")).replace("\0", "$")
    assert got.column("r").to_pylist() == [re.sub(pat, pyrep, s)
                                           for s in _TEMPLATE_STRINGS]


def test_device_regex_subset_detection():
    from spark_rapids_tpu_torch.expr.regex import (RegexUnsupported,
                                                   compile_device_nfa,
                                                   transpile)
    for ok in ("abc", "^a[bc]+d?$", "(ab|cd)*x", r"\d{2,4}"):
        assert compile_device_nfa(ok) is not None
    for bad in (r"(a)\1", "a(?=b)", r"\p{Alpha}", r"a\b", "a{2", "a{b}"):
        assert compile_device_nfa(bad) is None
    with pytest.raises(RegexUnsupported):
        transpile(r"(a)\1")


# ---------------------------------------------------------------------------
# tests/test_bitwise_json_pandas.py's get_json_object cases
# ---------------------------------------------------------------------------

_DOCS = ['{"a": {"b": 1}, "arr": [10, 20, 30]}',
         '{"a": {"b": "txt"}, "arr": []}', 'not json', None,
         '{"a": {"b": {"c": [1, 2]}}, "arr": [{"x": 1}, null]}',
         '{"a": null}']


@pytest.mark.parametrize("paths", [("$.a.b", "$.arr[1]", "$.a.b.c"),
                                   ("$x", "$.a??", "$")])
def test_get_json_object(paths):
    t = pa.table({"j": pa.array(_DOCS, type=pa.string())})
    out = _host_only(t, lambda M: [
        M.get_json_object(M.col("j"), p).alias(f"p{i}")
        for i, p in enumerate(paths)], "host-only: JSON parsing")
    if paths[0] == "$.a.b":
        assert out.column("p0").to_pylist() == ["1", "txt", None, None,
                                                '{"c":[1,2]}', None]
    else:
        assert out.column("p0").null_count == len(_DOCS)


# ---------------------------------------------------------------------------
# the port's decisions: Spark's answer where the JAX device path leaves
# it on a local point; parity pinned elsewhere
# ---------------------------------------------------------------------------

def _port_and_jax(table: pa.Table, build):
    sess, q, jsess, jq = _queries(table, build)
    return (q.collect(), q.collect(device=False), jq.collect(device=True),
            jq.collect(device=False))


@pytest.mark.parametrize("pattern", ["a*$", "(ab|c)*x?$", "[a-z]*$"])
def test_rlike_takes_the_empty_match_at_the_end(pattern):
    """A nullable pattern anchored at the end and not at the start matches
    every row (find()'s empty match at the end): the port's device path
    equals Python's re.search and both host engines, where the JAX device
    path says false on "zz" ("ZZ9" for ``[a-z]*$``; a reference fault the
    port does not copy)."""
    strs = ["zz", "", "ab", "x", "ZZ9", "cab"]
    dev, host, jdev, jhost = _port_and_jax(
        pa.table({"s": strs}),
        lambda M: [M.col("s").rlike(pattern).alias("m")])
    want = [re.search(pattern, s) is not None for s in strs]
    assert all(want)
    for got in (dev, host, jhost):
        assert got.column("m").to_pylist() == want
    assert jdev.column("m").to_pylist() != want


def test_ascii_and_locate_follow_spark_on_characters():
    """ascii is the first character's code point and locate counts
    characters, with a start of 0 or less giving 0: the port's device path
    equals both host engines; the JAX device path gives the first byte,
    byte offsets and reads a start of 0 as 1 (reference faults the port
    does not copy)."""
    strs = ["日本語a", "éa", "a日a", "", "xyz", "ééa"]
    dev, host, jdev, jhost = _port_and_jax(pa.table({"s": strs}), lambda M: [
        M.ascii(M.col("s")).alias("asc"),
        M.locate("a", M.col("s"), 0).alias("l0"),
        M.locate("a", M.col("s"), 2).alias("l2"),
        M.locate("", M.col("s"), 3).alias("le"),
        M.instr(M.col("s"), "a").alias("i")])
    want = {"asc": [ord(s[0]) if s else 0 for s in strs],
            "l0": [0] * len(strs),
            "l2": [s.find("a", 1) + 1 for s in strs],
            "le": [3 if len(s) >= 2 else 0 for s in strs],
            "i": [s.find("a") + 1 for s in strs]}
    for got in (dev, host, jhost):
        assert {k: got.column(k).to_pylist() for k in want} == want
    assert jdev.column("asc").to_pylist()[0] == 0xE6    # the first byte
    assert jdev.column("l0").to_pylist()[0] == 4        # start 0 read as 1
    assert jdev.column("l2").to_pylist()[1] == 2        # a byte offset


def test_case_mapping_and_pads_stay_ascii_exact_on_the_device():
    """Kept parity: upper/lower/initcap map ASCII only and lpad/rpad count
    bytes on the device, in both packages (the rules' ps-notes); the host
    engines are full Unicode and count characters."""
    strs = ["é", "ab", "日本"]
    dev, host, jdev, jhost = _port_and_jax(pa.table({"s": strs}), lambda M: [
        M.upper(M.col("s")).alias("u"),
        M.rpad(M.col("s"), 4, "*").alias("rp"),
        M.lpad(M.col("s"), 1, "x").alias("lp")])
    assert_tables_equal(dev, jdev, ignore_order=False)
    assert_tables_equal(host, jhost, ignore_order=False)
    assert dev.column("u").to_pylist() == ["é", "AB", "日本"]
    assert host.column("u").to_pylist() == ["É", "AB", "日本"]
    assert dev.column("rp").to_pylist()[0] == "é**"
    assert host.column("rp").to_pylist()[0] == "é***"
