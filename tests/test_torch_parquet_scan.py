"""The Parquet scan of the PyTorch port (on the CPU) against the JAX package
and the port's host engine: each reader strategy of ``ParquetSource``;
TPC-H Q6, Q1 and Q3 from Parquet files with filter pushdown on (the host
reader, row groups pruned by statistics) and off (``TpuParquetScanExec``,
the device decode), results and plans (``tree_string()`` after the run)
equal to the JAX package's; and AQE's runtime IN-filter, pushed into the
probe side's Parquet scan when a join demotes to broadcast, with events
equal to the JAX package's."""
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.io.parquet import ParquetSource as JParquetSource
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.io.parquet import ParquetSource
from spark_rapids_tpu_torch.io.pushdown import to_arrow_filter
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal

_ORDERED = {"q1", "q3"}


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    """customer, orders and lineitem (12,000 rows, as test_torch_q3.py),
    each in three Parquet files of row groups of 1,000 rows."""
    root = tmp_path_factory.mktemp("tpch_parquet")
    tables = {"customer": tpch.gen_customer(0, rows=300),
              "orders": tpch.gen_orders(0, rows=3000),
              "lineitem": tpch.gen_lineitem(0, rows=12000)}
    for name, t in tables.items():
        d = root / name
        d.mkdir()
        per = -(-t.num_rows // 3)
        for i in range(3):
            pq.write_table(t.slice(i * per, per), str(d / f"part{i}.parquet"),
                           row_group_size=1000)
    return root, tables


def test_reader_strategies_equal_the_jax_source(tpch_dir):
    root, tables = tpch_dir
    cols = ["l_orderkey", "l_shipmode", "l_shipdate"]
    for kind in ("PERFILE", "COALESCING", "MULTITHREADED"):
        conf = {"spark.rapids.sql.format.parquet.reader.type": kind,
                "spark.rapids.sql.reader.batchSizeRows": 3000}
        from spark_rapids_tpu.conf import RapidsConf as JConf
        src = ParquetSource(str(root / "lineitem"), RapidsConf(conf),
                            num_partitions=2)
        jsrc = JParquetSource(str(root / "lineitem"), JConf(conf),
                              num_partitions=2)
        assert src.partitions() == jsrc.partitions() == 2
        assert src.name() == jsrc.name()
        assert src.estimated_size_bytes() == jsrc.estimated_size_bytes()
        assert src.schema().names == jsrc.schema().names
        assert all(f.nullable for f in src.schema())
        got = []
        for p in range(2):
            batches = list(src.read_partition(p, cols))
            jbatches = list(jsrc.read_partition(p, cols))
            assert [b.num_rows for b in batches] == \
                [b.num_rows for b in jbatches], kind
            got += batches
        out = pa.concat_tables([b.to_arrow() for b in got])
        assert_tables_equal(out, tables["lineitem"].select(cols),
                            ignore_order=False)


def test_push_filter_prunes_row_groups_and_ands():
    from spark_rapids_tpu_torch.expr import functions as F
    cond = (F.col("a") > F.lit(5)) & (F.col("s").cast(
        __import__("spark_rapids_tpu_torch.columnar.dtypes",
                   fromlist=["INT"]).INT) == F.lit(3))
    expr = to_arrow_filter(cond.expr)
    assert str(expr) == "(a > 5)"  # the untranslatable conjunct dropped
    assert to_arrow_filter((~(F.col("a") > F.lit(5))
                            | F.col("b").is_null()).expr) is not None
    assert to_arrow_filter(((F.col("a") > F.lit(1)) | (F.col("s").cast(
        __import__("spark_rapids_tpu_torch.columnar.dtypes",
                   fromlist=["INT"]).INT) == F.lit(3))).expr) is None


def _run(root, name, conf):
    """-> (port device result, its plan after the run, host engine result,
    JAX result, JAX plan after the run)."""
    sess = TorchSession(conf, device="cpu")
    t = {k: sess.read_parquet(str(root / k)) for k in
         ("customer", "orders", "lineitem")}
    q = tpch.QUERIES[name](t)
    plan = sess._physical(q.logical, True)
    port = plan.collect().to_arrow()
    host = q.collect(device=False)
    jsess = TpuSession(conf)
    jt = {k: jsess.read_parquet(str(root / k)) for k in
          ("customer", "orders", "lineitem")}
    jplan = jsess._physical(jtpch.QUERIES[name](jt).logical, True)
    jout = jplan.collect().to_arrow()
    return port, plan, host, jout, jplan


@pytest.mark.parametrize("aqe", [True, False])
@pytest.mark.parametrize("pushdown", [True, False])
@pytest.mark.parametrize("name", ["q6", "q1", "q3"])
def test_tpch_from_parquet_equals_jax_and_host(tpch_dir, name, pushdown,
                                               aqe):
    root, tables = tpch_dir
    conf = {"spark.rapids.tpu.scan.filterPushdown.enabled": pushdown,
            "spark.rapids.tpu.aqe.enabled": aqe}
    port, plan, host, jout, jplan = _run(root, name, conf)
    ordered = name in _ORDERED
    assert_tables_equal(port, jout, ignore_order=not ordered)
    assert_tables_equal(port, host, ignore_order=not ordered)
    mem = TorchSession(conf, device="cpu")
    want = tpch.QUERIES[name]({k: mem.create_dataframe(v) for k, v in
                               tables.items()}).collect(device=False)
    assert_tables_equal(port, want, ignore_order=not ordered)
    text = plan.tree_string()
    assert text == jplan.tree_string()
    # Q6's discount and quantity bounds translate to an Arrow filter, so
    # pushdown keeps its scan on the host reader; Q1's and Q3's date casts
    # do not, and their lineitem scans decode on the device either way
    assert ("TpuParquetScanExec" in text) == (name != "q6" or not pushdown)
    if aqe:
        assert plan.events == jplan.events


#: demotes Q3's customer x orders join directly (its orders build side is
#: small) and the join with lineitem by side swap
_RUNTIME_FILTER_CONF = {"spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                        "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold":
                            60000}


@pytest.mark.parametrize("pushdown", [True, False])
def test_aqe_runtime_in_filter_events_equal_jax(tpch_dir, pushdown):
    root, _ = tpch_dir
    conf = dict(_RUNTIME_FILTER_CONF,
                **{"spark.rapids.tpu.scan.filterPushdown.enabled": pushdown})
    port, plan, host, jout, jplan = _run(root, "q3", conf)
    assert_tables_equal(port, jout, ignore_order=False)
    assert_tables_equal(port, host, ignore_order=False)
    assert plan.events == jplan.events
    pushed = [e for e in plan.events if e.startswith("pushed runtime")]
    assert len(pushed) == 1, plan.events
    assert plan.tree_string() == jplan.tree_string()


def test_runtime_filter_max_keys_and_switch_are_read(tpch_dir):
    root, _ = tpch_dir
    for extra in ({"spark.rapids.tpu.aqe.runtimeFilter.maxKeys": 10},
                  {"spark.rapids.tpu.aqe.runtimeFilter.enabled": False}):
        port, plan, host, jout, jplan = _run(
            root, "q3", dict(_RUNTIME_FILTER_CONF, **extra))
        assert_tables_equal(port, jout, ignore_order=False)
        assert plan.events == jplan.events
        assert not any(e.startswith("pushed runtime") for e in plan.events)
        assert any(e.startswith("demoted inner join to broadcast (build")
                   for e in plan.events)


def test_in_memory_probe_takes_no_runtime_filter(tpch_dir):
    """The in-memory source prunes nothing by statistics: it takes no
    runtime filter, in either package."""
    _, tables = tpch_dir
    sess = TorchSession(_RUNTIME_FILTER_CONF, device="cpu")
    q = tpch.q3({k: sess.create_dataframe(v, num_partitions=2)
                 for k, v in tables.items()})
    plan = sess._physical(q.logical, True)
    plan.collect()
    jsess = TpuSession(_RUNTIME_FILTER_CONF)
    jplan = jsess._physical(jtpch.q3({
        k: jsess.create_dataframe(v, num_partitions=2)
        for k, v in tables.items()}).logical,
        True)
    jplan.collect()
    assert plan.events == jplan.events
    assert not any(e.startswith("pushed runtime") for e in plan.events)


def test_planner_copies_the_source_per_plan(tpch_dir):
    """Pushdown attaches the filter to a copy: the DataFrame's own source
    gathers no filter across queries."""
    root, _ = tpch_dir
    sess = TorchSession(device="cpu")
    df = sess.read_parquet(str(root / "lineitem"))
    for _ in range(2):
        tpch.q6({"lineitem": df}).collect()
    assert df.logical.source.filter_expr is None
    assert os.path.isdir(str(root / "lineitem"))
