"""TPC-H Q3 (two equi-joins, a keyed aggregate, top 10) through the PyTorch
port (on the CPU), the port's host engine and the JAX package, under the
three plan shapes Q3 takes: the planner's broadcast joins, shuffled joins
with AQE off (the count/expand path), and AQE's side-swap demotion to
broadcast (the unique-build PK path). Rows must be equal in order, revenue
at rel 1e-9; the port's device plan equals the JAX package's node for node
and its AQE events equal the JAX ones. Then limits, top-n with ties and
nulls, and string comparisons against literals on the device."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.plan.aqe import AdaptiveExec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal

_ROWS = 12000   # lineitem; orders and customer follow TPC-H's 4:1 and 10:1
#: between the small stages (customer 1,512 B, customer x orders 7,872 B)
#: and the big ones (orders 34,152 B, lineitem 182,700 B) at this size: AQE
#: demotes both joins by swapping their sides, as it does at SF1
_SWAP_BYTES = 20000

_SHAPES = {
    "broadcast": {},
    "shuffled": {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                 "spark.rapids.tpu.aqe.enabled": False},
    "side_swap": {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                  "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold":
                      _SWAP_BYTES},
    "side_swap_sort": {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                       "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold":
                           _SWAP_BYTES,
                       "spark.rapids.tpu.join.strategy": "sort"},
}


@pytest.fixture(scope="module")
def tables():
    return {"customer": tpch.gen_customer(0, rows=_ROWS // 40),
            "orders": tpch.gen_orders(0, rows=_ROWS // 4),
            "lineitem": tpch.gen_lineitem(0, rows=_ROWS)}


def test_generators_equal_the_jax_package_byte_for_byte(tables):
    for name, gen in (("customer", jtpch.gen_customer),
                      ("orders", jtpch.gen_orders),
                      ("lineitem", jtpch.gen_lineitem)):
        assert tables[name].equals(gen(0, rows=tables[name].num_rows))
    for seed in (1, 2):
        assert tpch.gen_orders(0.0002, seed=seed).equals(
            jtpch.gen_orders(0.0002, seed=seed))
        assert tpch.gen_customer(0.0002, seed=seed).equals(
            jtpch.gen_customer(0.0002, seed=seed))


def _run(tables, conf, parts):
    """-> (port device result, its plan, host engine result, JAX result,
    JAX plan): each plan is the one that ran (an AQE plan after its run)."""
    sess = TorchSession(conf, device="cpu")
    q = tpch.q3({k: sess.create_dataframe(v, num_partitions=parts)
                 for k, v in tables.items()})
    plan = sess._physical(q.logical, True)
    port = plan.collect().to_arrow()
    host = q.collect(device=False)
    jsess = TpuSession(conf)
    jq = jtpch.q3({k: jsess.create_dataframe(v, num_partitions=parts)
                   for k, v in tables.items()})
    jplan = jsess._physical(jq.logical, True)
    jout = jplan.collect().to_arrow()
    return port, plan, host, jout, jplan


@pytest.mark.parametrize("shape,parts,min_bucket", [
    ("broadcast", 1, 8), ("broadcast", 3, 1024),
    ("shuffled", 1, 1024), ("shuffled", 3, 8),
    ("side_swap", 2, 8), ("side_swap", 3, 1024),
    ("side_swap_sort", 3, 8)])
def test_q3_matches_jax_package_and_host_engine(tables, shape, parts,
                                                min_bucket):
    conf = {"spark.rapids.tpu.batchRowsMinBucket": min_bucket,
            "spark.rapids.sql.test.enabled": True, **_SHAPES[shape]}
    port, plan, host, jout, jplan = _run(tables, conf, parts)
    assert port.column_names == ["l_orderkey", "o_orderdate",
                                 "o_shippriority", "revenue"]
    assert port.num_rows == 10
    for other in (host, jout):
        assert port.schema == other.schema
        assert_tables_equal(port, other, ignore_order=False)
    revenue = port.column("revenue").to_pylist()
    assert revenue == sorted(revenue, reverse=True)
    # the device plan that ran is the JAX package's, node for node
    assert plan.tree_string() == jplan.tree_string()
    text = plan.tree_string()
    if shape == "shuffled":
        assert text.count("TpuShuffledHashJoinExec") == 2
        assert "AdaptiveExec" not in text
        return
    assert text.count("TpuBroadcastHashJoinExec") == 2
    # one partition plans no exchange, so nothing for AQE to do
    assert isinstance(plan, AdaptiveExec) == (parts > 1)
    if parts == 1:
        return
    assert text.count("TpuTakeOrderedExec") == 2
    assert plan.events == jplan.events
    swaps = [e for e in plan.events if "via side swap" in e]
    if shape == "broadcast":
        assert swaps == [] and len(plan.events) == 2
    else:
        assert swaps == ["demoted inner join to broadcast via side swap "
                         "(build side 1512B)",
                         "demoted inner join to broadcast via side swap "
                         "(build side 7872B)"]
        assert "TpuWholeStage[Project+Project+HashAggregate]" in text
        assert "TpuStageReaderExec [local n=1 rows=6525 bytes=182700]" \
            in text


@pytest.mark.parametrize("shape", ["broadcast", "shuffled", "side_swap"])
def test_q3_with_no_building_customer_is_empty(tables, shape):
    """An empty build side (no customer passes the filter): every engine
    gives no rows, of Q3's schema."""
    cust = tables["customer"]
    cust = cust.set_column(cust.schema.get_field_index("c_mktsegment"),
                           "c_mktsegment",
                           pa.array(["AUTOMOBILE"] * cust.num_rows))
    conf = {"spark.rapids.sql.test.enabled": True, **_SHAPES[shape]}
    port, _, host, jout, _ = _run({**tables, "customer": cust}, conf, 3)
    assert port.num_rows == host.num_rows == jout.num_rows == 0
    assert port.schema == host.schema == jout.schema


def test_out_of_slice_joins_are_tagged_and_run_on_the_host_engine(tables):
    """A left join and a join with a residual condition, out of the slice
    when Q3 came, now run on the device (nothing tags them, and
    ``test.enabled`` lets them run) equal to the host engine and the JAX
    package. A join on binary keys is still out of the slice: it is tagged
    with the ROADMAP step that ports it and runs on the host engine;
    nothing falls back silently."""
    sess = TorchSession(device="cpu")
    jsess = TpuSession({})
    strict = TorchSession({"spark.rapids.sql.test.enabled": True},
                          device="cpu")
    outs = []
    for s, fns, gen in ((strict, F, tpch), (jsess, JF, jtpch)):
        cust = s.create_dataframe(tables["customer"], num_partitions=2)
        orders = s.create_dataframe(tables["orders"], num_partitions=2)
        col = fns.col
        left = cust.join(orders, condition=col("c_custkey")
                         == col("o_custkey"), how="left")
        cond = cust.join(orders, condition=(col("c_custkey")
                                            == col("o_custkey"))
                         & (col("c_acctbal") > col("o_totalprice")))
        outs.append([q.group_by("c_mktsegment")
                     .agg(fns.count(col("o_orderkey")).alias("n"),
                          fns.sum(col("c_acctbal")).alias("b"))
                     .sort("c_mktsegment") for q in (left, cond)])
    for q, jq in zip(*outs):
        joins = [ln for ln in q.explain("device").splitlines()
                 if "JoinExec" in ln]
        assert joins and all("will run on the device" in ln for ln in joins)
        got = q.collect()
        assert_tables_equal(got, q.collect(device=False), ignore_order=False)
        assert_tables_equal(got, jq.collect(device=True), ignore_order=False)
    names = pa.array([n.encode() for n in
                      tables["customer"].column("c_name").to_pylist()],
                     type=pa.binary())
    cust = sess.create_dataframe(pa.table({
        "kb": names, "c_acctbal": tables["customer"].column("c_acctbal")}),
        num_partitions=2)
    other = sess.create_dataframe(pa.table({
        "kb2": names.take(np.arange(0, len(names), 3)),
        "w": np.arange(len(range(0, len(names), 3)), dtype=np.int64)}))
    q = cust.join(other, condition=F.col("kb") == F.col("kb2"))
    assert "ROADMAP Queue 1: breadth" in q.explain("device")
    got = q.collect()
    assert got.num_rows == other.collect().num_rows
    assert_tables_equal(got, q.collect(device=False))
    with pytest.raises(AssertionError, match="fell off the device"):
        strict._physical(q.logical, True).collect()


def test_aqe_leaves_a_stage_of_many_partitions_as_it_is(tables):
    """An exchange the device may not run (its conf key off) materializes
    on the host tier in 8 partitions. Since the multi-GPU step AQE
    coalesces such a stage as the JAX package does (it used to leave it as
    it was): with coalescing on its 8 partitions merge into one read, with
    both rewrites off the stage stays as it is; the query equals the host
    engine either way, and no event says a rewrite is not ported."""
    off = {"spark.rapids.sql.exec.ShuffleExchangeExec": False}
    rewrites_off = {"spark.rapids.tpu.aqe.coalescePartitions.enabled": False,
                    "spark.rapids.tpu.aqe.skewJoin.enabled": False}
    for conf, coalesced in ((off, True),
                            ({**off, "spark.rapids.tpu.aqe.skewJoin.enabled":
                              False}, True),
                            ({**off, **rewrites_off}, False)):
        sess = TorchSession(conf, device="cpu")
        q = tpch.q1({"lineitem": sess.create_dataframe(
            tables["lineitem"], num_partitions=2)})
        plan = sess._physical(q.logical, True)
        got = plan.collect().to_arrow()
        assert_tables_equal(got, q.collect(device=False), ignore_order=False)
        assert plan.events[0].startswith("materialized stage n=8 rows=")
        assert "ShuffleStageExec [host n=8" in plan.tree_string()
        assert ("coalesced stage 8 -> 1 partitions" in plan.events) \
            == coalesced
        assert not any("not ported" in e for e in plan.events)


@pytest.mark.parametrize("key,value,step", [
    ("spark.rapids.tpu.aqe.advisoryPartitionSizeBytes", 1 << 20, "multi-GPU"),
    ("spark.rapids.tpu.aqe.coalescePartitions.minPartitionNum", 4,
     "multi-GPU"),
    ("spark.rapids.tpu.aqe.skewJoin.skewedPartitionFactor", 2, "multi-GPU"),
    ("spark.rapids.tpu.aqe.skewJoin.skewedPartitionThresholdBytes", 1,
     "multi-GPU")])
def test_unread_aqe_confs_raise_unless_default(key, value, step):
    """These AQE confs raised off their default until the ``step`` that
    reads them (ROADMAP Queue 1, multi-GPU): now every value is
    taken, as given or as a string, and the skew and coalescing rewrites
    read them (tests/test_torch_aqe_skew.py)."""
    default = TorchSession(device="cpu").conf.get(key)
    assert TorchSession({key: default}, device="cpu").conf.get(key) \
        == default
    assert TorchSession({key: str(value)}, device="cpu").conf.get(key) \
        == value
    assert TorchSession({key: value}, device="cpu").conf.get(key) == value
    assert step == "multi-GPU"


def test_cross_join_raises_naming_roadmap(tables):
    """The cross join raised (ROADMAP Queue 1: nested-loop and cross
    joins) until that step; it now runs on the device's nested-loop join,
    equal to the host engine's."""
    sess = TorchSession(device="cpu")
    df = sess.create_dataframe(tables["customer"].slice(0, 40))
    q = df.join(df.select(F.col("c_name").alias("n2")), how="cross")
    got = q.collect()
    assert got.num_rows == 40 * 40
    assert_tables_equal(got, q.collect(device=False))


# ---------------------------------------------------------------------------
# Limits and top-n
# ---------------------------------------------------------------------------
def _tie_table(n: int = 700) -> pa.Table:
    """Sort keys with heavy ties and nulls: a nullable int of 5 values, a
    double with NaN and -0.0, a string; ``id`` tells tied rows apart."""
    rng = np.random.default_rng(5)
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n), mask=rng.random(n) < 0.15),
        "d": pa.array(rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -1.0]),
                                 n), mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(np.array(["", "a", "ab", "b"]), n).tolist()),
        "id": pa.array(np.arange(n, dtype=np.int64))})


def _limit_queries(fns):
    col, SO = fns.col, fns.SortOrder
    return {
        "top_asc": lambda df: df.sort("k", "d").limit(25),
        "top_desc_nulls": lambda df: df.sort(
            SO(col("k").expr, False, True), SO(col("d").expr, True, False),
            col("s").desc()).limit(40),
        "top_ties_only": lambda df: df.sort("s").limit(300),
        "top_more_than_rows": lambda df: df.filter(col("k") == fns.lit(3))
        .sort(col("d").desc()).limit(10_000),
        "limit": lambda df: df.limit(37),
        "filter_limit": lambda df: df.filter(col("s") == fns.lit("ab"))
        .limit(15),
        "limit_zero": lambda df: df.limit(0),
    }


@pytest.mark.parametrize("name", sorted(_limit_queries(F)))
@pytest.mark.parametrize("parts,min_bucket", [(1, 8), (3, 64)])
def test_limit_and_take_ordered_match_jax_package(name, parts, min_bucket):
    conf = {"spark.rapids.tpu.batchRowsMinBucket": min_bucket,
            "spark.rapids.sql.test.enabled": True}
    table = _tie_table()
    sess = TorchSession(conf, device="cpu")
    q = _limit_queries(F)[name](sess.create_dataframe(table,
                                                      num_partitions=parts))
    got = q.collect()
    jsess = TpuSession(conf)
    jq = _limit_queries(JF)[name](jsess.create_dataframe(
        table, num_partitions=parts))
    for other in (q.collect(device=False), jq.collect(device=True)):
        assert got.schema == other.schema
        assert_tables_equal(got, other, ignore_order=False)
    threes = sum(k == 3 for k in table.column("k").to_pylist())
    assert got.num_rows == {"top_asc": 25, "top_desc_nulls": 40,
                            "top_ties_only": 300, "limit": 37,
                            "top_more_than_rows": threes, "limit_zero": 0,
                            "filter_limit": 15}[name]
    plan = sess._physical(q.logical, True)
    plan.collect()
    assert ("TpuTakeOrderedExec" if name.startswith("top")
            else "TpuLocalLimitExec") in plan.tree_string()


# ---------------------------------------------------------------------------
# String comparisons against literals on the device
# ---------------------------------------------------------------------------
_STRINGS = ["", "a", "ab", "abc", "abd", "b", "BUILDING", "BUILDINGS",
            "BUILD", "longer than sixteen bytes", "ünï", None]


@pytest.mark.parametrize("op", ["eq", "lt", "le", "gt", "ge", "isin"])
@pytest.mark.parametrize("literal", ["", "ab", "BUILDING",
                                     "longer than sixteen bytes!"])
def test_device_string_compare_with_literal_matches_jax_package(op, literal):
    rng = np.random.default_rng(len(literal))
    n = 500
    table = pa.table({"s": pa.array([_STRINGS[i] for i in
                                     rng.integers(0, len(_STRINGS), n)]),
                      "id": pa.array(np.arange(n, dtype=np.int64))})

    def query(fns, df):
        s, lit = fns.col("s"), fns.lit(literal)
        cond = {"eq": s == lit, "lt": s < lit, "le": s <= lit,
                "gt": s > lit, "ge": s >= lit,
                "isin": s.isin(literal, "a", "b")}[op]
        return df.filter(cond).select("id", "s")

    conf = {"spark.rapids.tpu.batchRowsMinBucket": 64,
            "spark.rapids.sql.test.enabled": True}
    sess = TorchSession(conf, device="cpu")
    q = query(F, sess.create_dataframe(table, num_partitions=2))
    got = q.collect()
    want = [r for r in table.to_pylist() if r["s"] is not None and {
        "eq": r["s"] == literal, "lt": r["s"] < literal,
        "le": r["s"] <= literal, "gt": r["s"] > literal,
        "ge": r["s"] >= literal,
        "isin": r["s"] in (literal, "a", "b")}[op]]
    # Python orders str by code point, UTF-8 bytes keep that order
    assert got.to_pylist() == [{"id": r["id"], "s": r["s"]} for r in want]
    assert_tables_equal(got, q.collect(device=False), ignore_order=False)
    jq = query(JF, TpuSession(conf).create_dataframe(table,
                                                     num_partitions=2))
    assert_tables_equal(got, jq.collect(device=True), ignore_order=False)
