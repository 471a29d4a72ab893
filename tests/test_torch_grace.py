"""The grace join and the out-of-core sort of the port against the JAX
package's, on the CPU: the cases of the JAX package's
``tests/test_out_of_core.py`` (a sort and joins over a spill catalog far
smaller than their data, a windowed expand) and every join type over
integer, string and two-key keys, each output equal to the JAX package's
row for row; the grace buckets equal to JAX's ``_grace_split`` row for
row (TPC-H through the grace join: tests/test_torch_grace_tpch.py). And
the reference fault the port does not copy: the JAX grace join buckets
-0.0 apart from 0.0, and NaN payloads apart from each other, and loses
their matches."""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.device import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.columnar.host import HostTable as JHostTable
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec.sort import TpuSortExec as JSortExec
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.memory import catalog as jcatalog
from spark_rapids_tpu.plan.schema import Field as JField
from spark_rapids_tpu.plan.schema import Schema as JSchema
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostColumn, HostTable
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.plan.schema import Field, Schema
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal
from test_torch_join_types import _nodes, _sides

_CPU = torch.device("cpu")
_TYPES = {"long": (dt.LONG, jdt.LONG), "int": (dt.INT, jdt.INT),
          "double": (dt.DOUBLE, jdt.DOUBLE),
          "string": (dt.STRING, jdt.STRING)}
_HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]


@pytest.fixture(autouse=True)
def _jax_bucket_policy():
    """The JAX joins below run outside any JAX session, on the JAX
    package's import-time bucket ladder; a JAX session an earlier test file
    made in this process (``configure_buckets``, its
    ``batchRowsMinBucket``) would change their buckets and so the JAX row
    order these tests compare in order. Each test runs on the import-time
    ladder and puts the ladder back afterwards."""
    from spark_rapids_tpu.columnar import device as jdev
    saved = jdev._POLICY
    jdev._POLICY = jdev.BucketPolicy()
    yield
    jdev._POLICY = saved


@pytest.fixture
def small_catalogs():
    """Device pools far below the data in both packages: forced spills
    (the limits of the JAX package's ``test_out_of_core.py``)."""
    tcat = tcatalog.BufferCatalog(device_limit=60_000, host_limit=40_000)
    jcat = jcatalog.BufferCatalog(device_limit=60_000, host_limit=40_000)
    tcatalog.set_catalog(tcat)
    jcatalog.set_catalog(jcat)
    yield tcat, jcat
    tcatalog.set_catalog(None)
    jcatalog.set_catalog(None)


class _Source:
    def __init__(self, batches, schema):
        self.batches = batches
        self.schema = schema
        self.num_partitions = 1
        self.children = ()

    def execute_columnar(self, pidx):
        yield from self.batches


def _side(cols: dict, splits: int):
    """One join side as (port source, JAX source): ``cols`` maps a name to
    (kind, values, validity or None); row ``i`` goes to batch ``i %
    splits``."""
    n = len(next(iter(cols.values()))[1])
    pb, jb = [], []
    for i in range(splits):
        sel = np.arange(i, n, splits)
        pc, jc = [], []
        for kind, values, valid in cols.values():
            v = values[sel]
            va = None if valid is None else valid[sel]
            pc.append(HostColumn(_TYPES[kind][0], v, va))
            jc.append(JHostColumn(_TYPES[kind][1], v, va))
        pb.append(DeviceTable.from_host(HostTable(list(cols), pc), 8, _CPU))
        jb.append(JDeviceTable.from_host(JHostTable(list(cols), jc),
                                         min_bucket=8))
    return (_Source(pb, Schema([Field(k, _TYPES[c[0]][0], True)
                                for k, c in cols.items()])),
            _Source(jb, JSchema([JField(k, _TYPES[c[0]][1], True)
                                 for k, c in cols.items()])))


def _arrow(batches) -> pa.Table:
    return pa.concat_tables([b.to_host().to_arrow() for b in batches])


def _jarrow(batches) -> pa.Table:
    return pa.concat_tables([JHostTable.to_arrow(b.to_host())
                             for b in batches])


class _GraceSpy:
    """Counts the port's grace joins and their bucket counts."""

    def __init__(self, monkeypatch):
        self.n_sub = []
        real = tjoins.TpuShuffledHashJoinExec._grace_build_parts
        spy = self

        def record(node, build, n_sub):
            spy.n_sub.append(n_sub)
            return real(node, build, n_sub)
        monkeypatch.setattr(tjoins.TpuShuffledHashJoinExec,
                            "_grace_build_parts", record)


def _join_both(how, left, right, lkeys, rkeys, batch_bytes, merge=True):
    """The same join through the port's and the JAX package's shuffled
    hash join -> (port rows, JAX rows)."""
    (pl, jl), (pr, jr) = left, right
    port = tjoins.TpuShuffledHashJoinExec(
        pl, pr, lkeys, rkeys, how, None, merge, _CPU, "hash", 8,
        batch_bytes)
    jnode = jjoins.TpuShuffledHashJoinExec(
        jl, jr, lkeys, rkeys, how, None, merge_keys=merge, min_bucket=8,
        batch_bytes=batch_bytes)
    return _arrow(port.execute_columnar(0)), \
        _jarrow(jnode.execute_columnar(0))


# ---------------------------------------------------------------------------
# The JAX package's out-of-core cases
# ---------------------------------------------------------------------------
def test_out_of_core_sort_spills(small_catalogs):
    tcat, _ = small_catalogs
    rng = np.random.default_rng(0)
    a = rng.integers(-500, 500, 6000).astype(np.int64)
    b = rng.uniform(-5, 5, 6000)
    port, jax = _side({"a": ("long", a, None), "b": ("double", b, None)}, 10)
    orders = [F.col("a").expr, F.col("b").expr]
    from spark_rapids_tpu.expr.functions import SortOrder as JSortOrder
    from spark_rapids_tpu_torch.expr.functions import SortOrder
    s = TpuSortExec(port, [SortOrder(o, True) for o in orders], 8, 20_000)
    js = JSortExec(jax, [JSortOrder(JF.col("a").expr, True),
                         JSortOrder(JF.col("b").expr, True)],
                   min_bucket=8, batch_bytes=20_000)
    got = _arrow(s.execute_columnar(0))
    assert_tables_equal(got, _jarrow(js.execute_columnar(0)),
                        ignore_order=False)
    exp = pd.DataFrame({"a": a, "b": b}).sort_values(["a", "b"],
                                                     kind="stable")
    np.testing.assert_array_equal(got.column("a").to_numpy(), exp["a"])
    np.testing.assert_array_equal(got.column("b").to_numpy(), exp["b"])
    assert sum(tcat.stats()["spill_count"].values()) > 0
    tcat.assert_no_leaks()


def _kv(rng, n, hi, name):
    return {"k": ("long", rng.integers(0, hi, n).astype(np.int64), None),
            name: ("double", rng.uniform(0, 1, n), None)}


@pytest.mark.parametrize("how", _HOWS)
def test_out_of_core_grace_join_every_type(small_catalogs, monkeypatch,
                                           how):
    """``test_out_of_core_grace_join`` (inner) and
    ``test_out_of_core_left_join_grace`` (left), and the other four join
    types, over a catalog that spills the buckets."""
    tcat, _ = small_catalogs
    spy = _GraceSpy(monkeypatch)
    rng = np.random.default_rng(1)
    left = _kv(rng, 3000, 400, "lv")     # keys past 200: unmatched rows
    right = _kv(rng, 2000, 250, "rv")
    got, want = _join_both(how, _side(left, 3), _side(right, 2), ["k"],
                           ["k"], 8_000)
    assert len(spy.n_sub) == 1 and spy.n_sub[0] > 2
    assert_tables_equal(got, want, ignore_order=False)
    exp = pd.merge(pd.DataFrame({"k": left["k"][1], "lv": left["lv"][1]}),
                   pd.DataFrame({"k": right["k"][1], "rv": right["rv"][1]}),
                   on="k", how={"full": "outer"}.get(how, how)) \
        if how not in ("left_semi", "left_anti") else None
    if exp is not None:
        assert got.num_rows == len(exp)
        assert np.isclose(np.nansum(got.column("lv").to_numpy(
            zero_copy_only=False).astype(float)), exp["lv"].sum())
    assert sum(tcat.stats()["spill_count"].values()) > 0
    tcat.assert_no_leaks()


def test_windowed_expand_bounds_output(small_catalogs):
    """Every pair matches (240k rows): the output comes in probe windows
    within the budget, as in the JAX package."""
    lk, rk = np.zeros(600, np.int64), np.zeros(400, np.int64)
    left = {"k": ("long", lk, None), "lv": ("double", np.arange(600.0),
                                            None)}
    right = {"k": ("long", rk, None), "rv": ("double", np.arange(400.0),
                                             None)}
    (pl, _), (pr, _) = _side(left, 1), _side(right, 1)
    j = tjoins.TpuShuffledHashJoinExec(pl, pr, ["k"], ["k"], "inner", None,
                                       True, _CPU, "hash", 8, 500_000)
    max_out = j._max_out_rows()
    assert max_out < 600 * 400
    sizes = [(int(x.num_rows), x.capacity) for x in j.execute_columnar(0)]
    assert sum(n for n, _ in sizes) == 600 * 400 and len(sizes) > 1
    assert all(c <= max(2 * max_out, 8) for _, c in sizes)


@pytest.mark.parametrize("keys", ["string", "long+string"])
@pytest.mark.parametrize("how", ["inner", "full", "left_anti"])
def test_grace_join_on_string_and_two_keys(small_catalogs, monkeypatch,
                                           keys, how):
    spy = _GraceSpy(monkeypatch)
    rng = np.random.default_rng(3)
    words = np.array(["", "a", "ab", "BUILDING", "longer string value",
                      "zz", "ünïcode", "x" * 40]
                     + [f"key {i:03d} " * (1 + i % 3) for i in range(100)],
                     dtype=object)

    on = ["s"] if keys == "string" else ["k", "s"]

    def cols(n, name):
        return {"s": ("string", rng.choice(words, n), rng.random(n) > 0.1),
                "k" if "k" in on else f"{name}k":
                    ("long", rng.integers(0, 3, n).astype(np.int64),
                     rng.random(n) > 0.1),
                name: ("double", rng.uniform(0, 1, n), None)}
    got, want = _join_both(how, _side(cols(400, "lv"), 3),
                           _side(cols(300, "rv"), 2), on, on, 20_000)
    assert spy.n_sub and got.num_rows > 0
    assert_tables_equal(got, want, ignore_order=False)


# ---------------------------------------------------------------------------
# The buckets
# ---------------------------------------------------------------------------
def _key_values(t: pa.Table, key: str):
    """A float key column as (float64 values, null mask)."""
    c = t.column(key)
    return (c.to_numpy(zero_copy_only=False).astype(np.float64),
            c.is_null().to_numpy(zero_copy_only=False))


def _special(t: pa.Table, key: str) -> np.ndarray:
    """The rows whose key is -0.0 or NaN: the rows the port buckets apart
    from JAX."""
    v, null = _key_values(t, key)
    return ~null & (np.isnan(v) | ((v == 0) & np.signbit(v)))


@pytest.mark.parametrize("n_sub", [2, 7, 64])
@pytest.mark.parametrize("keys", ["int64", "string", "int64+string",
                                  "double", "double+int32"])
def test_grace_buckets_equal_jax_row_for_row(keys, n_sub):
    """Each bucket holds the rows (active, any key null or not) of its
    partition id in their order, at the JAX bucket's capacity. A float key
    pair differs from JAX only on -0.0 and NaN rows: -0.0 goes with 0.0,
    and every NaN to one bucket."""
    from test_torch_join_types import _KEYS
    kind, cols = _KEYS[keys]
    build, jbuild, probe, jprobe = _sides(n_sub, kind, 40)
    node, jnode = _nodes(probe, build, jprobe, jbuild, "inner", cols)
    for table, jtable, side in ((build, jbuild, node.right_keys),
                                (probe, jprobe, node.left_keys)):
        parts, counts = node._grace_split(table, side, n_sub)
        jparts = jnode._grace_split(jtable, side, n_sub)
        assert len(parts) == len(jparts) == n_sub
        assert sum(counts) == int(table.num_rows)
        for p, jp, n in zip(parts, jparts, counts):
            assert int(p.num_rows) == n
            if kind != "double":  # else -0.0 and NaN rows move the counts
                assert p.capacity == jp.capacity
            got = p.to_host().to_arrow()
            want = JHostTable.to_arrow(jp.to_host())
            if kind == "double":
                got = got.filter(pa.array(~_special(got, side[0])))
                want = want.filter(pa.array(~_special(want, side[0])))
            assert_tables_equal(got, want, ignore_order=False)
        if len(cols) == 1 and kind == "double":
            # a side's NaN keys share one bucket, its zeros of either sign
            # another
            for pick in (np.isnan, lambda v: v == 0):
                held = set()
                for s, p in enumerate(parts):
                    t = p.to_host().to_arrow()
                    v, null = _key_values(t, side[0])
                    if (pick(v) & ~null).any():
                        held.add(s)
                assert len(held) == 1


# ---------------------------------------------------------------------------
# The -0.0 / NaN fault of the JAX grace join
# ---------------------------------------------------------------------------
def _nan(bits: int) -> float:
    return float(np.array([bits], dtype=np.uint64).view(np.float64)[0])


_PROBE_KEYS = np.array([-0.0, 0.0, 5.0, _nan(0x7FF8000000000001),
                        _nan(0xFFF8000000000000), _nan(0x7FF0000000000F00)])


def test_port_keeps_the_matches_the_jax_grace_join_drops(monkeypatch):
    """Probe keys -0.0, 0.0, 5.0 and three NaN payloads against a
    2000-row build holding 0.0, 5.0 and the canonical NaN once each: the
    join holds -0.0 == 0.0 and NaN == NaN, so 6 rows. The JAX package
    gives 6 unsplit and drops matches under its grace join (its buckets
    hash the raw bits); the port gives 6 both ways, as its host engine."""
    build = np.arange(2000, dtype=np.float64)
    build[1999] = np.nan
    left = {"pk": ("double", _PROBE_KEYS, None),
            "lv": ("long", np.arange(6, dtype=np.int64), None)}
    right = {"bk": ("double", build, None),
             "rv": ("long", np.arange(2000, dtype=np.int64), None)}
    runs = {}
    for budget in (10 ** 9, 4000):
        runs[budget] = _join_both("inner", _side(left, 1), _side(right, 1),
                                  ["pk"], ["bk"], budget, merge=False)
    assert runs[10 ** 9][1].num_rows == 6          # JAX, unsplit
    assert runs[4000][1].num_rows < 6              # JAX, grace: the fault
    assert runs[10 ** 9][0].num_rows == runs[4000][0].num_rows == 6
    assert_tables_equal(runs[4000][0], runs[10 ** 9][0])
    assert sorted(runs[4000][0].column("lv").to_pylist()) == list(range(6))
    # through the session: the device grace join against the host engine
    spy = _GraceSpy(monkeypatch)
    sess = TorchSession({"spark.rapids.sql.batchSizeBytes": 4000,
                         "spark.rapids.tpu.batchRowsMinBucket": 8,
                         "spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                         "spark.rapids.tpu.aqe.enabled": False,
                         "spark.rapids.sql.test.enabled": True},
                        device="cpu")
    lt = sess.create_dataframe(pa.table({"pk": _PROBE_KEYS,
                                         "lv": np.arange(6)}))
    rt = sess.create_dataframe(pa.table({"bk": build,
                                         "rv": np.arange(2000)}))
    q = lt.join(rt, condition=F.col("pk") == F.col("bk"))
    got = q.collect()
    assert spy.n_sub and got.num_rows == 6
    assert_tables_equal(got, q.collect(device=False))


def test_host_engine_exchange_keeps_negative_zero_and_nan_together():
    """The host engine's hash exchange: a shuffled host join over 4
    partitions holds -0.0 == 0.0 and every NaN payload equal, as the
    unsplit join does. The JAX host engine hashes the raw bits and loses
    some of those matches."""
    probe = pa.table({"pk": np.tile(_PROBE_KEYS, 50),
                      "lv": np.arange(300)})
    build = pa.table({"bk": np.array([0.0, 5.0, np.nan, 7.0]),
                      "rv": np.arange(4)})
    conf = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.aqe.enabled": False}
    rows = []
    for sess, fns in ((TorchSession(conf, device="cpu"), F),
                      (TpuSession(conf), JF)):
        q = sess.create_dataframe(probe, num_partitions=4).join(
            sess.create_dataframe(build, num_partitions=4),
            condition=fns.col("pk") == fns.col("bk"))
        rows.append(q.collect(device=False).num_rows)
    assert rows[0] == 300
    assert rows[1] < 300


def test_integer_key_joined_to_a_float_key_shares_its_bucket():
    """An int64 key against a double key: the pair hashes as float64 on
    both sides, so 3 meets 3.0 (the JAX package hashes each side's own
    bits)."""
    left = {"k": ("long", np.array([0, 3, 7, 1999], np.int64), None)}
    right = {"k2": ("double", np.arange(2000, dtype=np.float64), None)}
    got, _ = _join_both("inner", _side(left, 1), _side(right, 1), ["k"],
                        ["k2"], 4000, merge=False)
    assert sorted(got.column("k").to_pylist()) == [0, 3, 7, 1999]


@pytest.mark.parametrize("name,columns", [
    ("lineitem", ["l_orderkey", "l_extendedprice", "l_discount",
                  "l_shipdate"]),
    ("orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]),
    ("customer", ["c_custkey", "c_mktsegment"]),
    ("customer", ["c_mktsegment", "c_phone"])])
def test_generators_build_only_the_columns_asked_for(name, columns):
    """A generator asked for some columns gives them as the whole table
    holds them (the big Q3 run on the card generates only Q3's), and the
    whole table is still the JAX package's byte for byte."""
    gen = getattr(tpch, f"gen_{name}")
    full = gen(0.01)
    assert full.equals(getattr(jtpch, f"gen_{name}")(0.01))
    assert gen(0.01, columns=columns).equals(full.select(columns))
