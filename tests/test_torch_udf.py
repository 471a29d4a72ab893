"""The ``pallas_axpy`` UDF and the plain version of its kernel in the port,
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
host twin. The kernel itself is tested in tests/test_torch_kernels.py."""
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.udf.examples import _pallas_axpy_device
from spark_rapids_tpu.udf.examples import pallas_axpy as jax_pallas_axpy
from spark_rapids_tpu.expr.functions import col as jcol
from spark_rapids_tpu.expr.functions import sum as jsum

from spark_rapids_tpu_torch.expr.functions import col, lit
from spark_rapids_tpu_torch.expr.functions import sum as fsum
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf.examples import pallas_axpy
from spark_rapids_tpu_torch.udf.kernels import axpy_reference

from harness import assert_tables_equal


def _assert_axpy_close(got, a, x, y, want):
    """``got`` (two roundings) vs ``want`` (XLA may fuse a*x+y into one FMA,
    one rounding): the two differ by at most the rounding of the product,
    so the bound scales with the operands' magnitude (1e-6 of it, ~8 ulp
    of float32), not with the possibly cancelled result."""
    bound = 1e-6 * (np.abs(a * x) + np.abs(y))
    assert np.all(np.abs(got - want) <= bound)


def _abc(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [1, 64, 1000, 65536])
def test_axpy_reference_matches_pallas_kernel(n):
    a, x, y = _abc(n, n)
    got = axpy_reference(*map(torch.from_numpy, (a, x, y))).numpy()
    _assert_axpy_close(got, a, x, y, np.asarray(_pallas_axpy_device(a, x, y)))
    # two separately rounded float32 ops, like the numpy host twin
    np.testing.assert_array_equal(got, a * x + y)


def _frame():
    # tests/test_udf_examples.py::test_pallas_axpy's data
    rng = np.random.default_rng(2)
    return pd.DataFrame({
        "a": rng.normal(size=64).astype(np.float32),
        "x": rng.normal(size=64).astype(np.float32),
        "y": rng.normal(size=64).astype(np.float32),
    })


def test_pallas_axpy_select_matches_jax_package():
    pdf = _frame()
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 8},
                        device="cpu")
    q = sess.create_dataframe(pdf, num_partitions=2).select(
        pallas_axpy(col("a"), col("x"), col("y")).alias("r"))
    dev = q.collect()
    host = q.collect(device=False)
    # the device path's plain version and the host twin round alike
    assert dev.equals(host)
    jsess = TpuSession({"spark.rapids.tpu.shuffle.mode": "host"})
    jq = jsess.create_dataframe(pdf, num_partitions=2).select(
        jax_pallas_axpy(jcol("a"), jcol("x"), jcol("y")).alias("r"))
    got = np.asarray(dev.column("r").to_pylist(), dtype=np.float32)
    jgot = np.asarray(jq.collect(device=True).column("r").to_pylist(),
                      dtype=np.float32)
    a, x, y = (pdf[c].to_numpy() for c in "axy")
    _assert_axpy_close(got, a, x, y, jgot)
    np.testing.assert_array_equal(got, a * x + y)


@pytest.mark.parametrize("parts", [1, 3])
def test_pallas_axpy_sum_matches_jax_package(parts):
    from spark_rapids_tpu_torch.tools import tpch
    li = tpch.gen_lineitem(0, seed=5, rows=3000)
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 8},
                        device="cpu")
    q = sess.create_dataframe(li, num_partitions=parts) \
        .filter(col("l_quantity") < lit(24.0)) \
        .agg(fsum(pallas_axpy(col("l_discount"), col("l_extendedprice"),
                              col("l_tax"))).alias("s"))
    assert "TpuWholeStage[Filter+Project+HashAggregate]" \
        in q.explain()
    dev = q.collect()
    assert_tables_equal(dev, q.collect(device=False), rel_tol=1e-9)
    jsess = TpuSession({"spark.rapids.tpu.batchRowsMinBucket": 8})
    jq = jsess.create_dataframe(li, num_partitions=parts) \
        .filter(jcol("l_quantity") < 24.0) \
        .agg(jsum(jax_pallas_axpy(jcol("l_discount"),
                                  jcol("l_extendedprice"),
                                  jcol("l_tax"))).alias("s"))
    # XLA may contract a*x+y into one FMA on the JAX side
    assert_tables_equal(dev, jq.collect(device=True), rel_tol=1e-6)
