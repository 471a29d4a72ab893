"""Math, rounding, shifts and ``bitwise_not`` of the port
(``expr/math.py``, ``expr/arithmetic.py``) against the JAX package, through
the port's device path on the CPU, its host engine and the JAX package's
device path and host engine.

Tolerances: integers, rounding and shifts exactly against both host
engines, and against the JAX device path at rel 1e-12 for round's doubles
(XLA divides by 10^s as a product with its reciprocal). The
elementwise functions of a double: the two host engines exactly (both
numpy); a device path against a host engine at rel 1e-12, because torch's
CPU kernels (SLEEF, and even its ``sqrt``, 695 of 10^5 values a ulp apart
on this CPU), XLA's and numpy's differ in the last bits. Rounding a
decimal follows Spark exactly on the port, where the JAX package leaves
the value as it was (pinned)."""
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.expr import math as JM
from spark_rapids_tpu.session import TpuSession

from harness import assert_tables_equal
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.expr import math as M
from spark_rapids_tpu_torch.session import TorchSession

_CONF = {"spark.rapids.sql.test.enabled": True}
_UNARY = ["Sqrt", "Exp", "Expm1", "Log", "Log1p", "Log10", "Log2", "Sin",
          "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh",
          "Cbrt", "ToDegrees", "ToRadians", "Rint", "Signum"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread: the tests run in several worker
    processes at once, and a thread pool each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(v):
    """A value compared exactly: a float by its sign and value, every NaN
    alike."""
    if isinstance(v, float):
        return ("nan",) if v != v else (np.copysign(1.0, v), v)
    return v


def _assert_exact(got: pa.Table, want: pa.Table, what: str) -> None:
    assert got.column_names == want.column_names
    for name in got.column_names:
        assert [_key(v) for v in got.column(name).to_pylist()] == \
            [_key(v) for v in want.column(name).to_pylist()], (what, name)


def _table() -> pa.Table:
    rng = np.random.default_rng(7)
    n = 200
    f = rng.normal(scale=30, size=n)
    f[:12] = [0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -2.5, 0.5, -0.5,
              1e300, -1e-300, 1.0]
    return pa.table({
        "f": pa.array(f, mask=rng.random(n) < 0.05),
        "u": pa.array(rng.uniform(-1, 1, n)),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "l": pa.array(np.concatenate([[-1, -2**63, 2**63 - 1, -8],
                                      rng.integers(-2**63, 2**63 - 1, n - 4,
                                                   dtype=np.int64)])),
        "k": pa.array(rng.integers(-70, 70, n).astype(np.int32)),
    })


def _exact(X):
    c = X.col
    return [X.ceil(c("f")).alias("ceil"), X.floor(c("f")).alias("floor"),
            X.round(c("f"), 2).alias("r2"), X.round(c("f")).alias("r0"),
            X.round(c("i"), -2).alias("ri"),
            X.shiftleft(c("l"), c("k")).alias("shl"),
            X.shiftright(c("l"), c("k")).alias("shr"),
            X.shiftrightunsigned(c("l"), c("k")).alias("shru"),
            X.shiftleft(c("i"), c("k")).alias("ishl"),
            X.shiftrightunsigned(c("i"), c("k")).alias("ishru"),
            X.bitwise_not(c("l")).alias("notl"),
            X.bitwise_not(c("i")).alias("noti")]


def _floats(X, mod):
    c = X.col
    out = [X.Column(getattr(mod, name)(c(arg).expr)).alias(name)
           for name in _UNARY for arg in ("f", "u")[:1]]
    return out + [X.Column(getattr(mod, name)(c("u").expr)).alias(f"{name}u")
                  for name in ("Asin", "Acos")] \
        + [X.pow(c("u"), c("f")).alias("pow"),
           X.Column(mod.Atan2(c("f").expr, c("u").expr)).alias("atan2")]


@pytest.fixture(scope="module")
def runs():
    table = _table()
    sess = TorchSession(_CONF, device="cpu")
    jsess = TpuSession(_CONF)
    out = {}
    for kind, build, jbuild in (
            ("exact", lambda: _exact(F), lambda: _exact(JF)),
            ("floats", lambda: _floats(F, M), lambda: _floats(JF, JM))):
        q = sess.create_dataframe(table, num_partitions=2).select(*build())
        jq = jsess.create_dataframe(table, num_partitions=2).select(*jbuild())
        out[kind] = (q, q.collect(), q.collect(device=False),
                     jq.collect(device=True), jq.collect(device=False))
    return out


def test_rounding_shifts_and_not_exact_four_ways(runs):
    q, dev, host, jdev, jhost = runs["exact"]
    for what, other in (("host", host), ("jax host", jhost)):
        _assert_exact(dev, other, what)
    # XLA turns round's division by 10^s into a product with its
    # reciprocal (31.83 comes out as 31.830000000000002): rel 1e-12
    assert_tables_equal(dev, jdev, ignore_order=False, rel_tol=1e-12)
    assert "!" not in "".join(ln for ln in q.explain("device").splitlines()
                              if "CpuScanExec" not in ln)
    # shiftrightunsigned of a negative long: the sign bit shifts in as 0
    row = dev.slice(0, 1).to_pylist()[0]
    k = _table().column("k")[0].as_py() & 63
    assert row["shru"] == (((-1) % 2**64) >> k) - (2**64 if k == 0 else 0)


def test_unary_and_binary_math(runs):
    q, dev, host, jdev, jhost = runs["floats"]
    _assert_exact(host, jhost, "jax host")      # both numpy: exactly
    assert_tables_equal(dev, host, ignore_order=False, rel_tol=1e-12)
    assert_tables_equal(jdev, host, ignore_order=False, rel_tol=1e-12)
    text = q.explain("device")
    assert all("CpuScanExec" in ln for ln in text.splitlines()
               if ln.lstrip().startswith("!")), text


def test_decimal_rounding_is_exact_where_jax_is_not():
    vals = ["123.45", "-2.55", "0.05", "-0.04", "9.99", "-123.45"]
    table = pa.table({"x": pa.array([decimal.Decimal(v) for v in vals],
                                    type=pa.decimal128(9, 2))})

    def build(X):
        return [X.round(X.col("x"), 1).alias("r1"),
                X.round(X.col("x")).alias("r0"),
                X.ceil(X.col("x")).alias("c"),
                X.floor(X.col("x")).alias("f")]
    q = TorchSession(_CONF, device="cpu").create_dataframe(table).select(
        *build(F))
    out = q.collect()
    assert out.equals(q.collect(device=False))
    d = [decimal.Decimal(v) for v in vals]
    assert out.column("r1").to_pylist() == [
        v.quantize(decimal.Decimal("0.1"), decimal.ROUND_HALF_UP) for v in d]
    assert out.column("r0").to_pylist() == [
        v.quantize(decimal.Decimal("1"), decimal.ROUND_HALF_UP) for v in d]
    assert out.column("c").to_pylist() == [
        v.to_integral_value(decimal.ROUND_CEILING) for v in d]
    assert out.column("f").to_pylist() == [
        v.to_integral_value(decimal.ROUND_FLOOR) for v in d]
    jout = TpuSession(_CONF).create_dataframe(table).select(
        *build(JF)).collect()
    assert jout.column("r1").to_pylist() == d      # unchanged in JAX
