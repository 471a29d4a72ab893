"""Window functions through the port (``TorchSession(device="cpu")``), its
host engine and the JAX package, in the cases of the JAX package's
``tests/test_window.py``: row number, ranks, lag/lead, running and bounded
ROWS frames, whole-partition aggregates, ntile, bounded RANGE frames
(decimal, NaN and large long keys), string partition and order keys,
stacked specs and ``with_column`` overwriting a column. The three results
are equal (doubles at rel 1e-9), and so are the plans (``tree_string()``
after the run) and AQE's events, with AQE on and off.

An order-dependent function (row_number, ntile, lag, lead) is compared row
by row only where its order keys are unique: the JAX cases' order keys
(v, x) can tie, so those queries order by a unique ``i`` after them.

Three faults of the JAX package are pinned by bits, and the port gives
Spark's answers: a running or whole-partition min/max over -inf (or +inf)
beside a null gives +-1.8e308 on the JAX device path; a float window sum
is a difference of prefix sums over the whole sorted batch in both JAX
engines, so a partition after one holding 1e20 sums to 0.0; and a window
average over a decimal averages the scaled integers (150.0 for 1.50) in
both JAX engines."""
import math
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.expr import window as JW
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.expr import window as W
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession

from harness import assert_tables_equal, data_gen

_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 64}


@pytest.fixture(scope="module")
def jax_sessions():
    """One JAX session per AQE setting, shared by the module."""
    return {aqe: TpuSession(dict(_CONF, **{
        "spark.rapids.tpu.aqe.enabled": aqe})) for aqe in (True, False)}


def _three(build, table, jax_sessions, parts=2, aqe=True, rel_tol=1e-9,
           host_on_device=False):
    """``build(F, W, dt, df)`` through the port's device path, its host
    engine and the JAX package's device path: equal results, equal plans
    and AQE events -> (port result, port plan)."""
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe})
    sess = TorchSession(conf if host_on_device else dict(
        conf, **{"spark.rapids.sql.test.enabled": True}), device="cpu")
    q = build(F, W, dt, sess.create_dataframe(table, num_partitions=parts))
    plan = sess._physical(q.logical, True)
    out = plan.collect().to_arrow()
    host = q.collect(device=False)
    js = jax_sessions[aqe]
    jq = build(JF, JW, jdt, js.create_dataframe(table, num_partitions=parts))
    jplan = js._physical(jq.logical, True)
    jout = jplan.collect().to_arrow()
    assert out.schema == host.schema == jout.schema
    assert_tables_equal(out, host, True, rel_tol)
    assert_tables_equal(out, jout, True, rel_tol)
    text = plan.tree_string()
    assert text == jplan.tree_string()
    if isinstance(plan, AdaptiveExec):
        assert plan.events == jplan.events
    return out, plan


@pytest.fixture(scope="module")
def table():
    """tests/test_window.py's frame, with a unique ``i`` to order ties."""
    rng = np.random.default_rng(0)
    t = data_gen(rng, 200, {"k": ("int32", 0, 6), "v": ("int64", 0, 50),
                            "x": "float64"}, null_prob=0.1)
    return t.append_column("i", pa.array(np.arange(200, dtype=np.int64)))


def _w(f, w):
    col = f.col
    return w.Window.partition_by("k").order_by(col("v").asc(),
                                                col("x").asc(),
                                                col("i").asc())


@pytest.mark.parametrize("aqe", [True, False])
def test_ranking_and_offset_functions(table, jax_sessions, aqe):
    """row_number, rank, dense_rank, ntile, lag and lead (with a default)
    over one spec: one window node."""
    def build(f, w, d, df):
        s = _w(f, w)
        col = f.col
        return df.select(
            col("k"), col("v"), col("x"), col("i"),
            w.row_number().over(s).alias("rn"),
            w.rank().over(s).alias("r"),
            w.dense_rank().over(s).alias("dr"),
            w.ntile(3).over(s).alias("nt"),
            w.lag(col("v"), 1).over(s).alias("lg"),
            w.lead(col("v"), 2).over(s).alias("ld"),
            w.lag(col("v"), 1, default=-1).over(s).alias("lgd"))
    out, plan = _three(build, table, jax_sessions, aqe=aqe)
    assert plan.tree_string().count("TpuWindowExec") == 1
    pdf = out.to_pandas()
    for _, grp in pdf.groupby("k", dropna=False):
        assert sorted(grp["rn"]) == list(range(1, len(grp) + 1))


def test_rank_dense_rank_values(jax_sessions):
    t = pa.table({"k": [1, 1, 1, 1, 2, 2, 2],
                  "v": [10, 10, 20, 30, 5, 5, 5]})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("v").asc())
        return df.with_column("r", w.rank().over(s)).with_column(
            "dr", w.dense_rank().over(s))
    out, _ = _three(build, t, jax_sessions, parts=1)
    rows = sorted(out.to_pylist(), key=lambda r: (r["k"], r["v"]))
    assert [r["r"] for r in rows[:4]] == [1, 1, 3, 4]
    assert [r["dr"] for r in rows[:4]] == [1, 1, 2, 3]
    assert [r["r"] for r in rows[4:]] == [1, 1, 1]


@pytest.mark.parametrize("aqe", [True, False])
def test_frames_running_bounded_and_whole(table, jax_sessions, aqe):
    """Running ROWS and RANGE (peers) sums, bounded ROWS sum/count/avg and
    min/max, whole-partition sum/min/max/count/avg, stacked as three
    specs."""
    def build(f, w, d, df):
        col = f.col
        s = _w(f, w)
        byv = w.Window.partition_by("k").order_by(col("v").asc())
        whole = w.Window.partition_by("k")
        return df.select(
            col("k"), col("v"), col("x"), col("i"),
            f.sum(col("v")).over(s.rows_between(None, 0)).alias("rs"),
            f.sum(col("x")).over(byv).alias("rr"),
            f.sum(col("v")).over(s.rows_between(-2, 1)).alias("bs"),
            f.count_star().over(s.rows_between(-2, 1)).alias("bn"),
            f.avg(col("x")).over(s.rows_between(-2, 1)).alias("bav"),
            f.min(col("x")).over(s.rows_between(-3, 2)).alias("bmn"),
            f.max(col("v")).over(s.rows_between(-2, 1)).alias("bmx"),
            f.min(col("x")).over(s).alias("rmn"),
            f.max(col("x")).over(s).alias("rmx"),
            f.sum(col("v")).over(whole).alias("ws"),
            f.min(col("x")).over(whole).alias("wmn"),
            f.max(col("x")).over(whole).alias("wmx"),
            f.count_star().over(whole).alias("wn"),
            f.avg(col("v")).over(whole).alias("wav"))
    _, plan = _three(build, table, jax_sessions, aqe=aqe)
    assert plan.tree_string().count("TpuWindowExec") == 3


def test_running_range_with_peers(jax_sessions):
    t = pa.table({"k": [1, 1, 1, 1], "v": [10, 10, 20, 30],
                  "x": [1.0, 2.0, 3.0, 4.0]})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("v").asc())
        return df.with_column("s", f.sum(f.col("x")).over(s))
    out, _ = _three(build, t, jax_sessions, parts=1)
    got = sorted(zip(out.column("x").to_pylist(), out.column("s").to_pylist()))
    assert [s for _, s in got] == [3.0, 3.0, 6.0, 10.0]


def test_with_column_overwrites_existing_with_window(jax_sessions):
    t = pa.table({"k": [1, 1, 2], "x": [10, 20, 30]})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("x").asc())
        return df.with_column("x", w.row_number().over(s))
    out, _ = _three(build, t, jax_sessions, parts=1)
    assert sorted(out.column("x").to_pylist()) == [1, 1, 2]


@pytest.mark.parametrize("aqe", [True, False])
def test_bounded_range_frames(jax_sessions, aqe):
    """Value offsets along one numeric order key, every aggregate kind, ASC
    and DESC, nulls among the keys and values."""
    rng = np.random.default_rng(1)
    t = data_gen(rng, 150, {"k": ("int32", 0, 4), "o": ("int64", 0, 40),
                            "v": "float64"}, null_prob=0.1)

    def build(f, w, d, df):
        col = f.col
        s = w.Window.partition_by("k").order_by(col("o").asc()) \
            .range_between(-5, 5)
        sd = w.Window.partition_by("k").order_by(col("o").desc()) \
            .range_between(-5, 2)
        return df.select(
            col("k"), col("o"), col("v"),
            f.sum(col("v")).over(s).alias("s"),
            f.count_star().over(s).alias("c"),
            f.min(col("v")).over(s).alias("mn"),
            f.max(col("v")).over(s).alias("mx"),
            f.sum(col("v")).over(sd).alias("sd"),
            f.max(col("v")).over(sd).alias("mxd"))
    _three(build, t, jax_sessions, aqe=aqe, rel_tol=1e-9)


def test_bounded_range_plans_and_two_order_keys(jax_sessions):
    """Bounded RANGE runs on the device; with two order keys it is invalid
    (Spark raises): tagged off the device, and the host engine raises."""
    rng = np.random.default_rng(2)
    t = data_gen(rng, 60, {"k": ("int32", 0, 3), "o": ("int64", 0, 20),
                           "v": "float64"}, null_prob=0.0)
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(t)
    w = W.Window.partition_by("k").order_by(F.col("o").asc())
    text = df.with_column("s", F.sum(F.col("v")).over(
        w.range_between(-3, 3))).explain("device")
    assert "bounded RANGE" not in text
    w2 = W.Window.partition_by("k").order_by(F.col("o").asc(),
                                             F.col("v").asc())
    q2 = df.with_column("s", F.sum(F.col("v")).over(w2.range_between(-3, 3)))
    assert "bounded RANGE frames need exactly one order key" \
        in q2.explain("device")
    with pytest.raises(NotImplementedError):
        q2.collect(device=False)


def test_bounded_range_manual_decimal_nan_and_long_keys(jax_sessions):
    """Hand-computed RANGE windows: small ints; DECIMAL keys in value units;
    NaN keys one peer group at the top; int64 keys past 2^53 distinct."""
    def by_o(lo, hi, what):
        def build(f, w, d, df):
            s = w.Window.order_by(f.col("o").asc()).range_between(lo, hi)
            agg = f.count_star() if what == "count" else f.sum(f.col("v"))
            return df.with_column("s", agg.over(s))
        return build

    t = pa.table({"o": [1, 2, 4, 7, 8], "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    out, _ = _three(by_o(-1, 1, "sum"), t, jax_sessions, parts=1)
    assert out.column("s").to_pylist() == [3.0, 3.0, 3.0, 9.0, 9.0]

    td = pa.table({"o": pa.array([Decimal("1.00"), Decimal("2.00"),
                                  Decimal("8.00")], pa.decimal128(10, 2)),
                   "v": [1.0, 2.0, 4.0]})
    out, plan = _three(by_o(-1, 1, "sum"), td, jax_sessions, parts=1)
    assert out.column("s").to_pylist() == [3.0, 3.0, 4.0]
    assert "TpuWindowExec" in plan.tree_string()

    tn = pa.table({"o": [1.0, 2.0, float("nan"), float("nan")],
                   "v": [1.0, 2.0, 4.0, 8.0]})
    out, _ = _three(by_o(0, 0, "count"), tn, jax_sessions, parts=1)
    got = dict(zip(out.column("v").to_pylist(), out.column("s").to_pylist()))
    assert got[4.0] == 2 and got[8.0] == 2

    base = 1 << 53
    tl = pa.table({"o": [base, base + 1, base + 3], "v": [1.0, 2.0, 4.0]})
    out, _ = _three(by_o(0, 1, "sum"), tl, jax_sessions, parts=1)
    assert out.column("s").to_pylist() == [3.0, 2.0, 4.0]


def test_string_partition_and_order_keys(jax_sessions):
    """String keys on the device: "ab" and "ab\\x00" are apart as
    partitions and as peers."""
    rng = np.random.default_rng(3)
    t = data_gen(rng, 300, {"k": "string", "v": ("int64", 0, 50),
                            "x": "float64"}, null_prob=0.1)
    t = t.append_column("i", pa.array(np.arange(300, dtype=np.int64)))

    def build(f, w, d, df):
        col = f.col
        s = w.Window.partition_by("k").order_by(col("v").asc(),
                                                 col("x").asc(),
                                                 col("i").asc())
        return df.with_column("rn", w.row_number().over(s)).with_column(
            "s", f.sum(col("v")).over(w.Window.partition_by("k")))
    _, plan = _three(build, t, jax_sessions)
    assert "TpuWindowExec" in plan.tree_string()

    ts = pa.table({"k": [1, 1, 1, 1, 1, 2, 2],
                   "s": ["ab", "ab", "ab\x00", "b", None, "z", "z"]})

    def build2(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("s").asc())
        return df.with_column("r", w.rank().over(s)).with_column(
            "dr", w.dense_rank().over(s))
    out, _ = _three(build2, ts, jax_sessions)
    got = sorted(zip(out.column("k").to_pylist(),
                     [s if s is not None else "" for s in
                      out.column("s").to_pylist()],
                     out.column("r").to_pylist(),
                     out.column("dr").to_pylist()))
    assert got[:5] == [(1, "", 1, 1), (1, "ab", 2, 2), (1, "ab", 2, 2),
                       (1, "ab\x00", 4, 3), (1, "b", 5, 4)]


def test_lag_offsets_and_ntile_counts(jax_sessions):
    t = pa.table({"k": [1, 1, 1, 1, 1], "v": [10.0, 20.0, 30.0, 40.0, 50.0]})
    for off in (1, 2):
        def build(f, w, d, df, off=off):
            s = w.Window.partition_by("k").order_by(f.col("v").asc())
            return df.with_column("l", w.lag(f.col("v"), off).over(s))
        out, _ = _three(build, t, jax_sessions, parts=1)
        got = sorted(zip(out.column("v").to_pylist(),
                         out.column("l").to_pylist()))
        assert [l for _, l in got][off:] == [10.0, 20.0, 30.0, 40.0][:5 - off]
    for k in (2, 4):
        def build(f, w, d, df, k=k):
            s = w.Window.partition_by("k").order_by(f.col("v").asc())
            return df.with_column("nt", w.ntile(k).over(s))
        out, _ = _three(build, t, jax_sessions, parts=1)
        assert max(out.column("nt").to_pylist()) == k


def test_decimal_windows_follow_the_jax_plan(jax_sessions):
    """DECIMAL(12,2): min, max, count and lag run on the device; a sum,
    typed DECIMAL(22,2), is past 18 digits and runs on the host engine,
    as in the JAX package."""
    t = pa.table({"k": [1, 1, 1, 2, 2],
                  "o": [1, 2, 3, 1, 2],
                  "d": pa.array([Decimal("1.50"), None, Decimal("-3.25"),
                                 Decimal("7.00"), Decimal("0.01")],
                                pa.decimal128(12, 2))})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("o").asc())
        return df.select(f.col("k"), f.col("o"), f.col("d"),
                         f.min(f.col("d")).over(s).alias("mn"),
                         f.max(f.col("d")).over(s.rows_between(-1, 1))
                         .alias("mx"),
                         f.count(f.col("d")).over(s).alias("n"),
                         w.lag(f.col("d")).over(s).alias("lg"))
    out, plan = _three(build, t, jax_sessions, parts=1)
    assert "TpuWindowExec" in plan.tree_string()
    assert out.column("mn").to_pylist()[:3] == [Decimal("1.50")] * 2 \
        + [Decimal("-3.25")]

    def build_sum(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("o").asc())
        return df.with_column("s", f.sum(f.col("d")).over(s))
    out, plan = _three(build_sum, t, jax_sessions, parts=1,
                       host_on_device=True)
    assert "CpuWindowExec" in plan.tree_string()
    assert out.column("s").type == pa.decimal128(22, 2)


# -- the JAX package's faults, pinned by bits --------------------------------
def _bits(v) -> int:
    return int(np.array([v], dtype=np.float64).view(np.int64)[0])


def _run(build, table, jax_session):
    """(port device, port host, JAX device, JAX host) results as rows."""
    sess = TorchSession(_CONF, device="cpu")
    q = build(F, W, dt, sess.create_dataframe(table))
    jq = build(JF, JW, jdt, jax_session.create_dataframe(table))
    return [r.to_pylist() for r in (q.collect(), q.collect(device=False),
                                    jq.collect(device=True),
                                    jq.collect(device=False))]


def test_minmax_of_infinities_beside_a_null(jax_sessions):
    """max over {null, -inf, -inf} and min over {inf, null}: Spark's -inf
    and inf on both port paths and the JAX host engine; the JAX device
    path fills the null with the finite extremes and gives -/+1.8e308."""
    t = pa.table({"k": [1, 1, 1, 2, 2], "o": [1, 2, 3, 1, 2],
                  "x": [None, -math.inf, -math.inf, math.inf, None]})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("o").asc())
        whole = w.Window.partition_by("k")
        return df.select(f.col("k"), f.col("o"),
                         f.max(f.col("x")).over(s).alias("run_max"),
                         f.min(f.col("x")).over(s).alias("run_min"),
                         f.max(f.col("x")).over(whole).alias("max"),
                         f.min(f.col("x")).over(whole).alias("min"))
    port, host, jdev, jhost = _run(build, t, jax_sessions[True])

    def by_key(rows):
        return {(r["k"], r["o"]): r for r in rows}
    want = {(1, 1): (None, None, -math.inf, -math.inf),
            (1, 2): (-math.inf, -math.inf, -math.inf, -math.inf),
            (1, 3): (-math.inf, -math.inf, -math.inf, -math.inf),
            (2, 1): (math.inf, math.inf, math.inf, math.inf),
            (2, 2): (math.inf, math.inf, math.inf, math.inf)}
    for rows in (port, host, jhost):
        got = by_key(rows)
        for key, vals in want.items():
            r = got[key]
            for name, v in zip(("run_max", "run_min", "max", "min"), vals):
                assert (r[name] is None) == (v is None), (key, name)
                if v is not None:
                    assert _bits(r[name]) == _bits(v), (key, name, r[name])
    jd = by_key(jdev)
    assert _bits(jd[(1, 2)]["run_max"]) == _bits(-np.finfo(np.float64).max)
    assert _bits(jd[(1, 1)]["max"]) == _bits(-np.finfo(np.float64).max)
    assert _bits(jd[(2, 2)]["run_min"]) == _bits(np.finfo(np.float64).max)
    assert _bits(jd[(2, 1)]["min"]) == _bits(np.finfo(np.float64).max)


def test_float_sums_keep_to_their_partition(jax_sessions):
    """Partition 1 holds 1e20, partition 2 three ones: Spark's running sum
    1, 2, 3 and ROWS -1..0 sum 1, 2, 2 on both port paths by bits; both
    JAX engines give 0.0 for all six (differences of prefix sums over the
    whole batch)."""
    t = pa.table({"k": [1, 2, 2, 2], "o": [1, 1, 2, 3],
                  "x": [1e20, 1.0, 1.0, 1.0]})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("o").asc())
        return df.select(f.col("k"), f.col("o"),
                         f.sum(f.col("x")).over(s.rows_between(None, 0))
                         .alias("run"),
                         f.sum(f.col("x")).over(s.rows_between(-1, 0))
                         .alias("b"),
                         f.sum(f.col("x")).over(w.Window.partition_by("k"))
                         .alias("tot"))
    port, host, jdev, jhost = _run(build, t, jax_sessions[True])
    for rows in (port, host):
        k2 = sorted((r["o"], r["run"], r["b"], r["tot"]) for r in rows
                    if r["k"] == 2)
        assert [_bits(r[1]) for r in k2] == [_bits(v) for v in (1.0, 2.0,
                                                                3.0)]
        assert [_bits(r[2]) for r in k2] == [_bits(v) for v in (1.0, 2.0,
                                                                2.0)]
        assert [_bits(r[3]) for r in k2] == [_bits(3.0)] * 3
    for rows in (jdev, jhost):
        k2 = [r for r in rows if r["k"] == 2]
        assert all(_bits(r["run"]) == _bits(0.0) and
                   _bits(r["b"]) == _bits(0.0) for r in k2)


def test_decimal_average_is_of_the_values(jax_sessions):
    """avg over DECIMAL(10,2) {1.50, 2.25, null}: 1.5, 1.875, 1.875 on both
    port paths; both JAX engines average the scaled integers (150.0,
    187.5)."""
    t = pa.table({"k": [1, 1, 1], "o": [1, 2, 3],
                  "d": pa.array([Decimal("1.50"), Decimal("2.25"), None],
                                pa.decimal128(10, 2))})

    def build(f, w, d, df):
        s = w.Window.partition_by("k").order_by(f.col("o").asc())
        return df.select(f.col("o"), f.avg(f.col("d")).over(s).alias("av"))
    port, host, jdev, jhost = _run(build, t, jax_sessions[True])
    for rows, want in ((port, [1.5, 1.875, 1.875]), (host, [1.5, 1.875,
                                                            1.875]),
                       (jdev, [150.0, 187.5, 187.5]),
                       (jhost, [150.0, 187.5, 187.5])):
        got = [r["av"] for r in sorted(rows, key=lambda r: r["o"])]
        assert [_bits(v) for v in got] == [_bits(v) for v in want]


def test_float_window_sums_are_the_same_every_run():
    """Running, whole and bounded float sums: the same bits run after run
    (a fixed order of adds; no atomics)."""
    rng = np.random.default_rng(4)
    t = data_gen(rng, 500, {"k": ("int32", 0, 3), "o": "int64",
                            "x": "float64"}, null_prob=0.05)
    sess = TorchSession(_CONF, device="cpu")
    df = sess.create_dataframe(t, num_partitions=2)
    s = W.Window.partition_by("k").order_by(F.col("o").asc())
    q = df.select(F.col("k"), F.col("o"), F.col("x"),
                  F.sum(F.col("x")).over(s.rows_between(None, 0)).alias("r"),
                  F.sum(F.col("x")).over(s.rows_between(-4, 3)).alias("b"),
                  F.sum(F.col("x")).over(W.Window.partition_by("k"))
                  .alias("w"))
    def bits(t):
        return {c: (np.asarray(t.column(c).is_valid()),
                    t.column(c).fill_null(0).to_numpy().view(np.int64))
                for c in ("r", "b", "w")}
    first = q.collect()
    for _ in range(2):
        again = q.collect()
        assert again.select(["k", "o"]).equals(first.select(["k", "o"]))
        for c, (valid, b) in bits(again).items():
            assert np.array_equal(valid, bits(first)[c][0])
            assert np.array_equal(b, bits(first)[c][1]), c
