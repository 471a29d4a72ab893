"""The port's string functions and date parts against the JAX package:
``Substring``, ``StartsWith``, ``EndsWith``, ``Contains`` and the simple
and NFA kinds of ``LIKE`` (``expr/strings.py``), and every date part of
``expr/datetimes.py``. Each runs through the port's device path (on the
CPU, with ``spark.rapids.sql.test.enabled``), its host engine, the JAX
package's device path and its host engine, on the same Arrow table; the
values must be equal exactly."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_CONF = {"spark.rapids.sql.test.enabled": True,
         "spark.rapids.tpu.batchRowsMinBucket": 64}
_WORDS = ["", "a", "ab", "abc", "abcab", "ünïcode", "日本語のテキスト",
          "13-555-0100", "PROMO BRUSHED TIN", "x" * 40 + "é",
          "forest green", "SM CASE", "b%c", "a_c", "abab"]


def _table(seed: int = 0, n: int = 300) -> pa.Table:
    rng = np.random.default_rng(seed)
    w = np.array(_WORDS, dtype=object)
    return pa.table({
        "s": pa.array(w[rng.integers(0, len(w), n)],
                      mask=rng.random(n) < 0.1),
        "t": pa.array(w[rng.integers(0, len(w), n)]),
    })


def _four_ways(table: pa.Table, build, jbuild) -> pa.Table:
    """Runs ``build(F)`` (a list of Columns) on the port's device path and
    host engine and ``jbuild(JF)`` on the JAX package's two paths; returns
    the port's device result after checking all four equal."""
    sess = TorchSession(_CONF, device="cpu")
    q = sess.create_dataframe(table, num_partitions=2).select(*build(F))
    jq = TpuSession(_CONF).create_dataframe(table, num_partitions=2) \
        .select(*jbuild(JF))
    dev = q.collect()
    for other in (q.collect(device=False), jq.collect(device=True),
                  jq.collect(device=False)):
        assert dev.equals(other)
    return dev


_SUBSTR = [(1, 2), (0, 3), (-3, 2), (-30, 28), (5, 100), (40, 2), (2, -1),
           (-1, 1), (3, 0), (1, 1)]


def test_substring_equals_jax_device_and_host():
    def build(M):
        return [M.substring(M.col("s"), p, n).alias(f"r{i}")
                for i, (p, n) in enumerate(_SUBSTR)]
    out = _four_ways(_table(1), build, build)
    s = _table(1).column("s").to_pylist()
    for i, (p, n) in enumerate(_SUBSTR):
        want = [None if v is None else _spark_substring(v, p, n) for v in s]
        assert out.column(f"r{i}").to_pylist() == want, (p, n)


def _spark_substring(s: str, pos: int, ln: int) -> str:
    if ln <= 0:
        return ""
    start = pos - 1 if pos > 0 else (0 if pos == 0 else len(s) + pos)
    if start < 0:
        ln, start = max(ln + start, 0), 0
    return s[start:start + ln]


_NEEDLES = ["", "a", "ab", "ünï", "日本", "TIN", "x" * 70]


def test_startswith_endswith_contains_equal_jax_device_and_host():
    def build(M):
        c = M.col("s")
        cols = []
        for i, nd in enumerate(_NEEDLES):
            cols += [c.startswith(nd).alias(f"sw{i}"),
                     c.endswith(nd).alias(f"ew{i}"),
                     c.contains(nd).alias(f"ct{i}")]
        # a column as the prefix and suffix
        return cols + [c.startswith(M.col("t")).alias("swt"),
                       c.endswith(M.col("t")).alias("ewt")]
    out = _four_ways(_table(2), build, build)
    s, t = (_table(2).column(c).to_pylist() for c in ("s", "t"))
    for i, nd in enumerate(_NEEDLES):
        assert out.column(f"ct{i}").to_pylist() == [
            None if v is None else nd in v for v in s]
        assert out.column(f"ew{i}").to_pylist() == [
            None if v is None else v.endswith(nd) for v in s]
    assert out.column("swt").to_pylist() == [
        None if a is None else a.startswith(b) for a, b in zip(s, t)]


_LIKES = ["abc", "ab%", "%ab", "%ab%", "%", "", "a_c", "%a%b%", "_b%",
          "b\\%c", "%te_t", "%special%requests%"]


def test_like_simple_and_nfa_kinds_equal_jax_device_and_host():
    def build(M):
        return [M.col("s").like(p).alias(f"l{i}")
                for i, p in enumerate(_LIKES)]
    out = _four_ways(_table(3), build, build)
    assert out.column("l1").to_pylist().count(True) > 0
    assert out.column("l6").to_pylist().count(True) > 0


def test_contains_on_a_column_is_tagged_to_the_host_as_in_jax():
    table = _table(4)
    sess = TorchSession({}, device="cpu")
    q = sess.create_dataframe(table).filter(F.col("s").contains(F.col("t")))
    jq = TpuSession({}).create_dataframe(table).filter(
        JF.col("s").contains(JF.col("t")))
    reason = "device contains pattern requires a literal"
    assert reason in q.explain("device")
    assert reason in jq.explain("tpu")
    assert q.collect().equals(jq.collect(device=False))


_PARTS = ["year", "month", "dayofmonth", "dayofweek", "weekday",
          "dayofyear", "weekofyear", "quarter"]


def test_date_parts_equal_jax_functions_over_days_around_the_epoch():
    """Every date part over days -800,000..800,000 (years -220..4160):
    leap days, century years and dates before 1970 included."""
    days = np.arange(-800_000, 800_001, dtype=np.int32)
    mask = np.zeros(len(days), bool)
    mask[::1001] = True
    table = pa.table({"d": pa.array(days, pa.int32(), mask=mask)
                      .cast(pa.date32())})

    def build(M):
        return [getattr(M, p)(M.col("d")).alias(p) for p in _PARTS]
    out = _four_ways(table, build, build)
    year = out.column("year").to_numpy(zero_copy_only=False)
    # spot checks: 1970-01-01, 2000-02-29, 1600-03-01, 1969-12-31
    for d, y, m, dom in ((0, 1970, 1, 1), (11016, 2000, 2, 29),
                         (-135080, 1600, 3, 1), (-1, 1969, 12, 31)):
        i = d + 800_000
        assert (year[i], out.column("month")[i].as_py(),
                out.column("dayofmonth")[i].as_py()) == (y, m, dom)
    assert out.column("year").null_count == mask.sum()


def test_like_outside_the_nfa_subset_is_tagged_to_the_host_as_in_jax():
    """A non-ASCII literal beside a wildcard is outside the device NFA's
    subset (a lead byte does not name a character): both packages tag the
    LIKE and run it on the host engine."""
    table = pa.table({"s": ["éa", "éab", "a", "xéy"]})
    sess = TorchSession({}, device="cpu")
    q = sess.create_dataframe(table).filter(F.col("s").like("é_"))
    jq = TpuSession({}).create_dataframe(table).filter(
        JF.col("s").like("é_"))
    reason = "LIKE pattern outside the device regex subset"
    assert reason in q.explain("device")
    assert reason in jq.explain("tpu")
    assert q.collect().column("s").to_pylist() == ["éa"]
    assert q.collect().equals(jq.collect(device=False))
    with pytest.raises(AssertionError, match="fell off the device"):
        TorchSession(_CONF, device="cpu").create_dataframe(table).filter(
            F.col("s").like("é_")).collect()
