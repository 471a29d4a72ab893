"""TPC-H Q6 through the PyTorch port (on the CPU), the JAX package and the
port's host engine: the same data gives the same answer (rel 1e-9, which
covers the order of the float64 sums)."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import tpch

from harness import assert_tables_equal, data_gen


def _sessions(min_bucket: int):
    conf = {"spark.rapids.tpu.batchRowsMinBucket": min_bucket}
    return TorchSession(conf, device="cpu"), TpuSession(conf)


def _three_ways(query, jquery, table: pa.Table, parts: int, min_bucket: int):
    """-> (port on the device path, port host engine, JAX package)."""
    sess, jsess = _sessions(min_bucket)
    q = query(sess.create_dataframe(table, num_partitions=parts))
    jq = jquery(jsess.create_dataframe(table, num_partitions=parts))
    return q.collect(), q.collect(device=False), jq.collect(device=True)


def _q6(df):
    return tpch.q6({"lineitem": df})


def _jq6(df):
    return jtpch.q6({"lineitem": df})


@pytest.mark.parametrize("rows", [1, 1000, 70000])
@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("min_bucket", [8, 1024])
def test_q6_matches_jax_package_and_host_engine(rows, parts, min_bucket):
    li = tpch.gen_lineitem(0, seed=0, rows=rows)
    port, host, jax_out = _three_ways(_q6, _jq6, li, parts, min_bucket)
    assert port.column_names == ["revenue"] and port.num_rows == 1
    assert_tables_equal(port, host)
    assert_tables_equal(port, jax_out)
    if rows >= 1000:
        assert port.column("revenue")[0].as_py() > 0


@pytest.mark.parametrize("parts", [1, 3])
def test_q6_with_no_qualifying_rows_is_null(parts):
    li = tpch.gen_lineitem(0, seed=1, rows=500)
    li = li.set_column(li.schema.get_field_index("l_discount"), "l_discount",
                       pa.array(np.zeros(li.num_rows)))
    port, host, jax_out = _three_ways(_q6, _jq6, li, parts, 8)
    assert port.column("revenue").to_pylist() == [None]
    assert_tables_equal(port, host)
    assert_tables_equal(port, jax_out)


_SPEC = {"a": "int32", "b": "float64", "c": "int64", "d": "bool",
         "e": "date", "f": "float32"}


def _nullable_query(F, INT, df):
    """filter + project + sum/count/min/max/avg over nullable columns
    (NaN, +-inf and -0.0 among the floats); ``F`` and ``INT`` are the
    engine's functions module and int type."""
    return (df.filter((F.col("a") > F.lit(0)) | F.col("d"))
            .select((F.col("b") * F.lit(2.0)).alias("b2"),
                    (F.col("a") + F.col("c")).alias("ac"),
                    F.col("e").cast(INT).alias("ei"), F.col("f"), F.col("d"))
            .agg(F.sum(F.col("b2")).alias("s_b2"),
                 F.sum(F.col("ac")).alias("s_ac"),
                 F.count(F.col("b2")).alias("n_b2"),
                 F.count_star().alias("n"),
                 F.min(F.col("f")).alias("min_f"),
                 F.max(F.col("f")).alias("max_f"),
                 F.min(F.col("ei")).alias("min_ei"),
                 F.max(F.col("d")).alias("max_d"),
                 F.avg(F.col("ac")).alias("avg_ac")))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("parts", [1, 3])
def test_nullable_filter_project_aggregate_matches_jax_package(seed, parts):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    table = data_gen(np.random.default_rng(seed), 700, _SPEC)
    port, host, jax_out = _three_ways(
        lambda df: _nullable_query(F, dt.INT, df),
        lambda df: _nullable_query(JF, jdt.INT, df), table, parts, 8)
    assert port.num_rows == 1
    assert_tables_equal(port, host)
    assert_tables_equal(port, jax_out)
