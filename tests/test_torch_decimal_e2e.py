"""Decimals end to end: the cases of ``tests/test_decimal128_e2e.py`` through
the port's device path (``device="cpu"``), its host engine and the JAX
package, which must give equal rows (decimals exactly, doubles at rel
1e-9); both tiers (scaled int64 up to 18 digits, two limbs beyond),
``Multiply``'s int64 fast path and its crossing into limbs; TPC-H Q1 and
Q6 over DECIMAL(12,2) with AQE on and off, plans (``tree_string()`` after
the run) and AQE events equal to the JAX package's; the host plan with
``spark.rapids.sql.decimal128.enabled=false``; the partition ids of
two-limb keys bit-equal to JAX; a Parquet file with decimal columns.

Two faults of the JAX package are pinned here, and the port does not copy
them: a DECIMAL sum whose partial state overflowed in one partition is
null in the port (Spark's rule), where the JAX package drops that
partition's rows and answers with a value no evaluation order gives; and
an integer or float cast to a decimal of at most 18 digits that does not
fit is null in the port, where the JAX package leaves it unchecked and its
download raises. The port also plans a join on a key past 18 digits on the
device, where the JAX package's join tag keeps it on the host (its join
codes take such keys; its tag checks them against the 18-digit
signature): that query compares results, not plans."""
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle import manager as jmanager
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.interop import device_table_from_numpy
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle import manager as tmanager
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal

_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 8,
         "spark.rapids.tpu.shuffle.partitions": 4}


def _dec_table(rng, n=400, with_nulls=True):
    """tests/test_decimal128_e2e.py's table: a key, DECIMAL(12,2) price and
    discount, DECIMAL(28,4) wide, each 6 % null."""
    price = [None if with_nulls and rng.random() < 0.06
             else Decimal(int(rng.integers(-10**11, 10**11))).scaleb(-2)
             for _ in range(n)]
    disc = [None if with_nulls and rng.random() < 0.06
            else Decimal(int(rng.integers(0, 101))).scaleb(-2)
            for _ in range(n)]
    wide = [None if with_nulls and rng.random() < 0.06
            else Decimal(int(rng.integers(-10**17, 10**17)) * 10**7)
            .scaleb(-4) for _ in range(n)]
    return pa.table({
        "k": rng.integers(0, 7, n),
        "price": pa.array(price, type=pa.decimal128(12, 2)),
        "disc": pa.array(disc, type=pa.decimal128(12, 2)),
        "wide": pa.array(wide, type=pa.decimal128(28, 4)),
    })


@pytest.fixture(scope="module")
def table():
    return _dec_table(np.random.default_rng(77))


def _three(build, tables, parts=2, conf=None, ignore_order=True):
    """``build(F, dataframes)`` through the port's device path, its host
    engine and the JAX package's device path -> the port's device result,
    after checking all three equal."""
    conf = dict(_CONF, **(conf or {}))
    sess = TorchSession(dict(conf, **{"spark.rapids.sql.test.enabled": True}),
                        device="cpu")
    q = build(F, {k: sess.create_dataframe(v, num_partitions=parts)
                  for k, v in tables.items()})
    port, host = q.collect(), q.collect(device=False)
    jsess = TpuSession(conf)
    jq = build(JF, {k: jsess.create_dataframe(v, num_partitions=parts)
                    for k, v in tables.items()})
    jax = jq.collect(device=True)
    assert port.schema == jax.schema
    assert_tables_equal(port, host, ignore_order)
    assert_tables_equal(port, jax, ignore_order)
    return port


def test_d128_arithmetic_chain(table):
    def build(f, t):
        col, lit = f.col, f.lit
        return t["t"].select(
            (col("price") * (lit(Decimal("1.00")) - col("disc"))).alias("dp"),
            (col("wide") + col("wide")).alias("w2"),
            (col("wide") - col("price")).alias("wm"),
            (-col("wide")).alias("neg"))
    out = _three(build, {"t": table})
    assert out.schema.field("dp").type == pa.decimal128(26, 4)
    # equal types add without widening (the JAX package's numeric_promote)
    assert out.schema.field("w2").type == pa.decimal128(28, 4)
    assert out.schema.field("wm").type == pa.decimal128(29, 4)


def test_d128_q1_style_aggregate(table):
    def build(f, t):
        col, lit = f.col, f.lit
        return (t["t"].with_column(
                    "dp", col("price") * (lit(Decimal("1.00")) - col("disc")))
                .group_by("k").agg(f.sum(col("dp")).alias("rev"),
                                   f.sum(col("price")).alias("base"),
                                   f.count(col("price")).alias("n")))
    out = _three(build, {"t": table})
    exp = {}
    for k, p, d in zip(table["k"].to_pylist(), table["price"].to_pylist(),
                       table["disc"].to_pylist()):
        if p is not None and d is not None:
            exp[k] = exp.get(k, Decimal(0)) + p * (Decimal("1.00") - d)
    got = dict(zip(out.column("k").to_pylist(),
                   out.column("rev").to_pylist()))
    assert got == exp


def test_d128_compare_filter_sort(table):
    def build(f, t):
        col, lit = f.col, f.lit
        return t["t"].filter(col("wide") > lit(Decimal("0.0000"))) \
            .select(col("wide"), col("k")).sort(col("wide").desc())
    out = _three(build, {"t": table}, ignore_order=False)
    vals = out.column("wide").to_pylist()
    assert vals == sorted(vals, reverse=True) and min(vals) > 0

    def build2(f, t):
        return t["t"].filter(f.col("wide") == f.col("wide")) \
            .select(f.col("k"))
    assert _three(build2, {"t": table}).num_rows \
        == table.num_rows - table["wide"].null_count


def test_d128_group_by_decimal_key():
    t = _dec_table(np.random.default_rng(77), n=300)

    def build(f, tt):
        return tt["t"].group_by("wide").agg(f.count(f.col("k")).alias("n"))
    out = _three(build, {"t": t})
    assert sum(out.column("n").to_pylist()) == t.num_rows


def test_d128_casts(table):
    def build(f, t):
        d = dt if f is F else jdt
        col = f.col
        return t["t"].select(
            col("wide").cast(d.DecimalType(38, 6)).alias("up"),
            col("wide").cast(d.DecimalType(20, 1)).alias("down"),
            col("wide").cast(d.DecimalType(10, 2)).alias("narrow"),
            col("price").cast(d.DecimalType(30, 6)).alias("widen"),
            col("wide").cast(d.DOUBLE).alias("dbl"),
            col("k").cast(d.DecimalType(25, 3)).alias("from_int"),
            col("price").cast(d.DecimalType(11, 1)).alias("d64_down"),
            col("wide").cast(d.DecimalType(18, 2)).alias("to_d64"))
    out = _three(build, {"t": table})
    for got, w in zip(out.column("down").to_pylist(),
                      table["wide"].to_pylist()):
        if w is None:
            continue
        expect = w.quantize(Decimal("0.1"), rounding="ROUND_HALF_UP")
        if abs(int(expect.scaleb(1))) >= 10 ** 20:
            expect = None
        assert got == expect
    assert out.column("narrow").null_count > table["wide"].null_count


def test_d128_overflow_nulls():
    big = Decimal(10**33).scaleb(-2)
    t = pa.table({"a": pa.array([big, -big, Decimal("5.00")],
                                type=pa.decimal128(38, 2))})

    def build(f, tt):
        return tt["t"].select((f.col("a") * f.col("a")).alias("sq"))
    out = _three(build, {"t": t}, parts=1, ignore_order=False)
    assert out.column("sq").to_pylist() == [None, None, Decimal("25.0000")]


def test_d128_join_key():
    rng = np.random.default_rng(77)
    n = 200
    vals = [Decimal(int(rng.integers(0, 40)) * 10**19).scaleb(-2)
            for _ in range(n)]
    left = pa.table({"a": pa.array(vals, type=pa.decimal128(25, 2)),
                     "x": rng.integers(0, 100, n)})
    right = pa.table({"b": pa.array([Decimal(int(v) * 10**19).scaleb(-2)
                                     for v in range(40)],
                                    type=pa.decimal128(25, 2)),
                      "y": np.arange(40)})

    def build(f, t):
        return t["l"].join(t["r"], condition=(f.col("a") == f.col("b")),
                           how="inner").select(f.col("x"), f.col("y"))
    shuffled = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                "spark.rapids.tpu.aqe.enabled": False}
    # the last: the build over the batch budget takes the grace join, which
    # buckets the limb keys by their partition ids
    for conf in ({}, shuffled,
                 dict(shuffled, **{"spark.rapids.sql.batchSizeBytes": 512})):
        out = _three(build, {"l": left, "r": right}, conf=conf)
        assert out.num_rows == n
    sess = TorchSession(dict(_CONF, **{
        "spark.rapids.tpu.aqe.enabled": False}), device="cpu")
    q = build(F, {"l": sess.create_dataframe(left, num_partitions=2),
                  "r": sess.create_dataframe(right)})
    assert "TpuBroadcastHashJoinExec" in sess._physical(q.logical, True) \
        .tree_string()


def test_d128_sum_overflow_to_null():
    big = Decimal(5 * 10**37)
    t = pa.table({"k": pa.array([1, 1, 1, 2], type=pa.int64()),
                  "v": pa.array([big, big, big, Decimal(7)],
                                type=pa.decimal128(38, 0))})

    def build(f, tt):
        return tt["t"].group_by("k").agg(f.sum(f.col("v")).alias("s"))
    out = _three(build, {"t": t}, parts=1)
    got = dict(zip(out.column("k").to_pylist(), out.column("s").to_pylist()))
    assert got == {1: None, 2: Decimal(7)}


# ---------------------------------------------------------------------------
# the partial-overflow fault of the JAX package, which the port does not copy
# ---------------------------------------------------------------------------
_FAULT_ROWS = [5 * 10**37, 5 * 10**37, 5 * 10**37, -9 * 10**37]


def _fault_table():
    return pa.table({"k": pa.array([1, 1, 1, 1], type=pa.int64()),
                     "v": pa.array([Decimal(v) for v in _FAULT_ROWS],
                                   type=pa.decimal128(38, 0))})


def _sums(engine, parts, keyed, aqe):
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe})
    if engine == "jax":
        df = TpuSession(conf).create_dataframe(_fault_table(),
                                               num_partitions=parts)
        f = JF
    else:
        df = TorchSession(conf, device="cpu").create_dataframe(
            _fault_table(), num_partitions=parts)
        f = F
    q = (df.group_by("k") if keyed else df).agg(
        f.sum(f.col("v")).alias("s"))
    if engine == "jax":
        return q.collect(device=True).column("s").to_pylist()
    return q.collect(device=engine == "port").column("s").to_pylist()


@pytest.mark.parametrize("aqe", [False, True])
@pytest.mark.parametrize("keyed", [False, True])
def test_overflowed_partial_sum_makes_the_group_null(keyed, aqe):
    """[5e37, 5e37 | 5e37, -9e37] as DECIMAL(38,0): partition 0's partial,
    1e38, overflows. The JAX package drops it and gives -4e37; the port's
    device path and host engine give null. In one partition all give
    6e37."""
    assert _sums("jax", 2, keyed, aqe) == [Decimal(-4 * 10**37)]
    assert _sums("port", 2, keyed, aqe) == [None]
    assert _sums("host", 2, keyed, aqe) == [None]
    for engine in ("jax", "port", "host"):
        assert _sums(engine, 1, keyed, aqe) == [Decimal(6 * 10**37)]


# ---------------------------------------------------------------------------
# both tiers: scaled int64 up to 18 digits
# ---------------------------------------------------------------------------
def _d64_table(rng, n=300):
    def dec(lo, hi, scale, p):
        return pa.array([None if rng.random() < 0.05
                         else Decimal(int(rng.integers(lo, hi))).scaleb(-scale)
                         for _ in range(n)], type=pa.decimal128(p, scale))
    return pa.table({"k": rng.integers(0, 5, n),
                     "a": dec(-10**7, 10**7, 2, 8),
                     "b": dec(-10**8, 10**8, 2, 9),
                     "c": dec(-10**9, 10**9, 2, 10),
                     "d": dec(-10**17, 10**17, 3, 18)})


def test_decimal64_tier_and_the_multiply_fast_path():
    t = _d64_table(np.random.default_rng(5))

    def build(f, tt):
        col, lit = f.col, f.lit
        return tt["t"].select(
            col("k"),
            (col("a") * col("b")).alias("fast"),      # 8 + 9 digits: int64
            (col("b") * col("c")).alias("crossing"),  # 9 + 10: two limbs
            (col("a") + col("c")).alias("add"),
            (col("d") - col("a")).alias("sub"),
            (col("d") + col("c")).alias("add_to_wide"),
            (col("a") < col("c")).alias("lt"),
            (col("d") >= lit(Decimal("12.5"))).alias("ge"),
            (-col("c")).alias("neg"))
    out = _three(build, {"t": t}, ignore_order=False, parts=1)
    assert out.schema.field("fast").type == pa.decimal128(18, 4)
    assert out.schema.field("crossing").type == pa.decimal128(20, 4)
    assert out.schema.field("add_to_wide").type == pa.decimal128(19, 3)

    def agg(f, tt):
        col = f.col
        return tt["t"].group_by("k").agg(
            f.sum(col("a")).alias("s8"), f.sum(col("c")).alias("s10"),
            f.min(col("d")).alias("mn"), f.max(col("c")).alias("mx"),
            f.avg(col("b")).alias("avg"), f.count(col("d")).alias("n"))
    out = _three(agg, {"t": t})
    assert out.schema.field("s8").type == pa.decimal128(18, 2)
    assert out.schema.field("s10").type == pa.decimal128(20, 2)


# ---------------------------------------------------------------------------
# TPC-H Q1 and Q6 over DECIMAL(12,2): rows, plans and AQE events
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dlineitem():
    li = tpch.decimal_lineitem(tpch.gen_lineitem(0, seed=11, rows=3000))
    assert li.equals(jtpch.decimal_lineitem(
        jtpch.gen_lineitem(0, seed=11, rows=3000)))
    return li


@pytest.mark.parametrize("query", ["q1_decimal", "q6_decimal"])
@pytest.mark.parametrize("aqe", [True, False])
def test_decimal_tpch_rows_plans_and_events_equal_jax(dlineitem, query, aqe):
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe})
    sess = TorchSession(dict(conf, **{"spark.rapids.sql.test.enabled": True}),
                        device="cpu")
    q = getattr(tpch, query)({"lineitem": sess.create_dataframe(
        dlineitem, num_partitions=2)})
    plan = sess._physical(q.logical, True)
    port = plan.collect().to_arrow()
    jsess = TpuSession(conf)
    jq = getattr(jtpch, query)({"lineitem": jsess.create_dataframe(
        dlineitem, num_partitions=2)})
    jplan = jsess._physical(jq.logical, True)
    jax = jplan.collect().to_arrow()
    assert port.schema == jax.schema
    assert_tables_equal(port, jax, ignore_order=False)
    assert_tables_equal(port, q.collect(device=False), ignore_order=False)
    assert plan.tree_string() == jplan.tree_string()
    if aqe:
        assert plan.events == jplan.events


@pytest.mark.parametrize("aqe", [True, False])
def test_decimal128_disabled_gives_the_jax_host_plan(dlineitem, aqe):
    conf = dict(_CONF, **{"spark.rapids.tpu.aqe.enabled": aqe,
                          "spark.rapids.sql.decimal128.enabled": False})
    sess = TorchSession(conf, device="cpu")
    q = tpch.q1_decimal({"lineitem": sess.create_dataframe(
        dlineitem, num_partitions=2)})
    plan = sess._physical(q.logical, True)
    port = plan.collect().to_arrow()
    jsess = TpuSession(conf)
    jq = jtpch.q1_decimal({"lineitem": jsess.create_dataframe(
        dlineitem, num_partitions=2)})
    jplan = jsess._physical(jq.logical, True)
    assert_tables_equal(port, jplan.collect().to_arrow(), ignore_order=False)
    assert "CpuHashAggregateExec" in plan.tree_string()
    if not aqe:
        assert plan.tree_string() == jplan.tree_string()
        return
    # the host stages of 4 partitions: both engines coalesce them (the
    # port since the multi-GPU step), so the plans and events are equal
    assert plan.tree_string() == jplan.tree_string()
    assert plan.events == jplan.events
    assert any(e.startswith("coalesced stage") for e in plan.events)


# ---------------------------------------------------------------------------
# partition ids of two-limb keys, and a Parquet file with decimal columns
# ---------------------------------------------------------------------------
def _limb_key_tables(seed: int, cap: int = 512):
    """(port table, JAX table) with a DECIMAL(25,2) key of limbs beside an
    int64 column: repeated values, negatives, 0 and +-(10^25 - 1), nulls."""
    from spark_rapids_tpu.columnar.device import DeviceColumn as JCol
    from spark_rapids_tpu.columnar.device import DeviceTable as JTab
    from spark_rapids_tpu.expr.decimal128 import limbs_from_py_ints
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    vals = np.array([int(v) * 10 ** 19 + int(w) for v, w in zip(
        rng.integers(-10**5, 10**5, cap), rng.integers(0, 10**6, cap))],
        dtype=object)
    vals[:4] = [0, 10**25 - 1, -(10**25 - 1), -1]
    limbs = limbs_from_py_ints(vals, cap)
    valid = rng.random(cap) > 0.2
    other = rng.integers(-5, 5, cap)
    mask = rng.random(cap) < 0.9
    port = device_table_from_numpy(
        ["k", "o"], [{"data": limbs, "validity": valid,
                      "dtype": "decimal(25,2)", "all_valid": False},
                     {"data": other, "validity": np.ones(cap, bool),
                      "dtype": "bigint", "all_valid": True}],
        mask, int(mask.sum()), "cpu")
    jt = JTab((JCol(jnp.asarray(limbs), jnp.asarray(valid),
                    jdt.DecimalType(25, 2), None),
               JCol(jnp.asarray(other), jnp.ones(cap, bool), jdt.LONG,
                    None)),
              jnp.asarray(mask), jnp.int32(int(mask.sum())), ("k", "o"))
    return port, jt


@pytest.mark.parametrize("parts", [2, 7, 64])
@pytest.mark.parametrize("seed", [42, 9001])
def test_partition_ids_of_limb_keys_bit_equal_jax(seed, parts):
    port, jt = _limb_key_tables(seed + parts)
    for keys in (["k"], ["k", "o"]):
        got = tmanager.device_partition_ids(port, keys, parts, seed=seed)
        want = np.asarray(jmanager.device_partition_ids(jt, keys, parts,
                                                        seed=seed))
        np.testing.assert_array_equal(got.numpy(), want)


def test_parquet_decimal_columns_read_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 500
    t = pa.table({
        "p": pa.array([None if i % 17 == 0 else
                       Decimal(int(rng.integers(-10**11, 10**11))).scaleb(-2)
                       for i in range(n)], type=pa.decimal128(12, 2)),
        "w": pa.array([None if i % 13 == 0 else
                       Decimal(int(rng.integers(-10**18, 10**18)) * 10**6
                               + i).scaleb(-2) for i in range(n)],
                      type=pa.decimal128(25, 2)),
        "i": np.arange(n)})
    path = str(tmp_path / "dec.parquet")
    pq.write_table(t, path, row_group_size=128)
    sess = TorchSession(dict(_CONF), device="cpu")
    q = sess.read_parquet(path).filter(F.col("i") >= F.lit(0))
    port = q.collect()
    jax = TpuSession(dict(_CONF)).read_parquet(path) \
        .filter(JF.col("i") >= JF.lit(0)).collect(device=True)
    assert_tables_equal(port, jax, ignore_order=False)
    assert_tables_equal(port, t, ignore_order=False)
    assert_tables_equal(q.collect(device=False), t, ignore_order=False)


def test_decimal64_cast_past_its_precision_is_null_where_jax_raises():
    """An integer or float cast to a decimal of at most 18 digits that its
    value does not fit, or from NaN, is null on both of the port's engines
    (Spark's non-ANSI cast). The JAX package checks only the wide tier:
    here it keeps the unchecked scaled value, and its download raises."""
    t = pa.table({"i": np.array([5, 10**9, -10**12], np.int64),
                  "f": np.array([1.5, 1e12, float("nan")])})
    sess = TorchSession(dict(_CONF), device="cpu")
    df = sess.create_dataframe(t)
    jdf = TpuSession(dict(_CONF)).create_dataframe(t)
    for c, first in (("i", Decimal("5.00")), ("f", Decimal("1.50"))):
        q = df.select(F.col(c).cast(dt.DecimalType(10, 2)).alias("d"))
        for device in (True, False):
            assert q.collect(device=device).column("d").to_pylist() \
                == [first, None, None]
        with pytest.raises(pa.ArrowInvalid):
            jdf.select(JF.col(c).cast(jdt.DecimalType(10, 2)).alias("d")) \
                .collect(device=True)


@pytest.mark.parametrize("direct", [True, False])
def test_limb_planes_spill_and_restore_as_jax(tmp_path, direct):
    """A two-limb column through the spill catalog's host arrays and disk
    files: the same arrays as the JAX package's, restored plane for plane
    (a 2-D plane without lengths stays a limb plane)."""
    from spark_rapids_tpu.memory import stores as jstores
    from spark_rapids_tpu_torch.memory import stores as tstores
    port, jt = _limb_key_tables(5)
    arrays, meta = tstores._table_to_host_arrays(port)
    jarrays, _ = jstores._table_to_host_arrays(jt)
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], np.asarray(jarrays[k]))
    stored = tstores.StoredTable(0, None, 0, port.nbytes())
    stored.host_arrays, stored.meta = arrays, meta
    disk = tstores.DiskStore(str(tmp_path), direct=direct)
    disk.put(stored)
    back = tstores._host_arrays_to_table(disk.load(stored), meta)
    for c, b in zip(port.columns, back.columns):
        assert b.lengths is None and b.dtype == c.dtype
        assert torch.equal(b.data, c.data)
        assert torch.equal(b.validity, c.validity)
    assert port.nbytes() == jt.nbytes()
