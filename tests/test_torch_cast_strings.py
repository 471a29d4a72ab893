"""String casts of the port (``expr/cast_kernels.py``, ``expr/cast.py``)
against the JAX package.

- The plain versions of ``str_parse`` and ``str_format`` against the JAX
  functions they port, on the same byte matrices: bit for bit (both run
  the same formula on the CPU; the port's plain double parse emulates the
  fused multiply-adds and the flushed subnormals of XLA:CPU).
- Whole casts through ``TorchSession(device="cpu")`` (the device path on
  the CPU, the plain versions), the port's host engine, and the JAX
  package's device path and host engine: the two device paths and the two
  host engines equal exactly; device against host at rel 1e-12 and abs
  1e-9, because the device's double formula is not correctly rounded and
  flushes subnormals where the host's ``float(s)`` does neither.
- The plan's device/host split and reasons equal the JAX package's.
- The departures from the JAX package, each pinned.
"""
import decimal
import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import cast_kernels as JK
from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

import torch
from harness import assert_tables_equal
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import cast_kernels as K
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession
from test_torch_cast_kernels import EDGE, random_numeric_strings

jax.config.update("jax_enable_x64", True)

_CONF = {"spark.rapids.sql.test.enabled": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread: the tests run in several worker
    processes at once, and a thread pool each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(strs, w: int, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (len(strs), w)).astype(np.uint8)
    lens = np.zeros(len(strs), np.int32)
    for i, s in enumerate(strs):
        b = s.encode()[:w]
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return data, lens


_JAX_PARSE = {"long": JK.string_to_long_device,
              "double": JK.string_to_double_device,
              "bool": JK.string_to_bool_device,
              "date": JK.string_to_date_device}


@pytest.mark.parametrize("kind", sorted(_JAX_PARSE))
def test_plain_parse_equals_jax_bit_for_bit(kind):
    """Exact (doubles compared as their bits)."""
    strs = EDGE + random_numeric_strings(1500, 3)
    data, lens = _matrix(strs, 32, 1)
    jv, jok = jax.jit(_JAX_PARSE[kind])(jnp.asarray(data), jnp.asarray(lens))
    pv, pok = K.str_parse_reference(torch.from_numpy(data),
                                    torch.from_numpy(lens), kind)
    jv, jok, pv, pok = (np.asarray(jv), np.asarray(jok), pv.numpy(),
                        pok.numpy())
    np.testing.assert_array_equal(pok, jok)
    if kind == "double":
        jv, pv = jv.view(np.int64), pv.view(np.int64)
    np.testing.assert_array_equal(pv, jv)
    assert pok.sum() > 100 or kind == "bool"


_FORMATS = [("long", 0), ("date", 0), ("bool", 0), ("decimal", 0),
            ("decimal", 2), ("decimal", 7), ("decimal", 18)]


@pytest.mark.parametrize("kind,scale", _FORMATS)
def test_plain_format_equals_jax_bit_for_bit(kind, scale):
    """Exact: the byte matrices plane by plane and the lengths."""
    rng = np.random.default_rng(scale)
    if kind == "long":
        v = np.concatenate([[0, -1, 7, -2**63, 2**63 - 1],
                            rng.integers(-2**63, 2**63 - 1, 500,
                                         dtype=np.int64)])
        jout = JK.int_to_string_device(jnp.asarray(v))
    elif kind == "date":
        v = np.concatenate([[0, -719162, -719163, 2932896, 2932897, -10**6],
                            rng.integers(-10**6, 3 * 10**6, 500)]
                           ).astype(np.int32)
        jout = JK.date_to_string_device(jnp.asarray(v))
    elif kind == "bool":
        v = rng.random(50) < .5
        jout = JK.bool_to_string_device(jnp.asarray(v))
    else:
        v = np.concatenate([[0, -5, 5, 10**17, -10**17 + 1],
                            rng.integers(-10**17, 10**17, 500)])
        jout = JK.decimal_to_string_device(jnp.asarray(v), scale)
    pout = K.str_format_reference(torch.from_numpy(v), kind, scale)
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_double_parse_against_correct_rounding():
    """The device formula (the JAX package's, kept for parity) against
    Python's correctly rounded ``float(s)`` on 10^5 random decimal strings
    of up to 25 digits with a point and an exponent in [-30, 30]: the
    count of strings that differ and the most ulps apart, pinned."""
    rng = np.random.default_rng(2024)
    n = 100_000
    digits = rng.integers(0, 10, (n, 25))
    nd = rng.integers(1, 26, n)
    point = rng.integers(0, 26, n)
    expo = rng.integers(-30, 31, n)
    strs = []
    for i in range(n):
        s = "".join(map(str, digits[i, :nd[i]]))
        p = min(point[i], nd[i])
        strs.append(f"{s[:p]}.{s[p:]}e{expo[i]}" if p else f"{s}e{expo[i]}")
    data, lens = _matrix(strs, 32, 0)
    got, ok = K.str_parse_reference(torch.from_numpy(data),
                                    torch.from_numpy(lens), "double")
    assert bool(ok.all())
    want = np.array([float(s) for s in strs])
    ulps = np.abs(got.numpy().view(np.int64) - want.view(np.int64))
    assert (int((ulps > 0).sum()), int(ulps.max())) == (27_968, 4)


def _strings_table() -> pa.Table:
    strs = EDGE + random_numeric_strings(160, 9)
    n = len(strs)
    rng = np.random.default_rng(5)
    mask = rng.random(n) < 0.08
    mask[:len(EDGE)] = False
    return pa.table({
        "s": pa.array(strs, mask=mask),
        "i": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                      mask=rng.random(n) < 0.1),
        "n": pa.array(rng.integers(-300, 300, n).astype(np.int32)),
        "d": pa.array(rng.integers(-719_162, 2_932_897, n).astype(np.int32)
                      ).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "x": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(-10**8, 10**8, n)],
                      type=pa.decimal128(9, 2)),
    })


def _casts(M, T):
    c = M.col
    return [
        c("s").cast(T.LONG).alias("s_long"),
        c("s").cast(T.INT).alias("s_int"),
        c("s").cast(T.BYTE).alias("s_byte"),
        c("s").cast(T.DOUBLE).alias("s_double"),
        c("s").cast(T.FLOAT).alias("s_float"),
        c("s").cast(T.BOOLEAN).alias("s_bool"),
        c("s").cast(T.DATE).alias("s_date"),
        c("i").cast(T.STRING).alias("i_str"),
        c("n").cast(T.STRING).cast(T.INT).alias("n_trip"),
        c("d").cast(T.STRING).alias("d_str"),
        c("d").cast(T.STRING).cast(T.DATE).alias("d_trip"),
        c("b").cast(T.STRING).alias("b_str"),
        c("x").cast(T.STRING).alias("x_str"),
        c("x").cast(T.STRING).cast(T.DOUBLE).alias("x_trip"),
    ]


@pytest.fixture(scope="module")
def four_ways():
    table = _strings_table()
    q = TorchSession(_CONF, device="cpu").create_dataframe(
        table, num_partitions=2).select(*_casts(F, dt))
    jq = TpuSession(_CONF).create_dataframe(table, num_partitions=2) \
        .select(*_casts(JF, jdt))
    return {"port_device": q.collect(), "port_host": q.collect(device=False),
            "jax_device": jq.collect(device=True),
            "jax_host": jq.collect(device=False), "q": q, "jq": jq,
            "table": table}


def test_casts_equal_jax_engine_for_engine(four_ways):
    """Device paths exactly, host engines exactly."""
    for a, b in (("port_device", "jax_device"), ("port_host", "jax_host")):
        for name in four_ways[a].column_names:
            got = four_ways[a].column(name).to_pylist()
            want = four_ways[b].column(name).to_pylist()
            assert [_key(v) for v in got] == [_key(v) for v in want], \
                (a, name)


def _key(v):
    """A value compared exactly: a float by its sign and value, every NaN
    alike."""
    if isinstance(v, float):
        return ("nan",) if v != v else (math.copysign(1.0, v), v)
    return v


def test_casts_device_against_host(four_ways):
    """rel 1e-12, abs 1e-9: the device double formula is not correctly
    rounded and flushes subnormals."""
    assert_tables_equal(four_ways["port_device"], four_ways["port_host"],
                        ignore_order=False, rel_tol=1e-12)
    out = four_ways["port_device"]
    assert out.column("n_trip").to_pylist() == \
        four_ways["table"].column("n").to_pylist()
    assert out.column("d_trip").to_pylist() == \
        four_ways["table"].column("d").to_pylist()
    k = EDGE.index("  +12.9 ")
    assert out.column("s_long")[k].as_py() == 12
    assert out.column("s_double")[EDGE.index("1e400")].as_py() == math.inf
    assert out.column("s_double")[EDGE.index("-inf")].as_py() == -math.inf
    assert out.column("s_date")[EDGE.index("2024-02-30")].as_py() is None
    assert out.column("s_date")[EDGE.index("0000-01-01")].as_py() is None
    assert out.column("s_long")[
        EDGE.index("-9223372036854775808")].as_py() == -2**63


def test_string_casts_run_on_the_device_as_in_jax(four_ways):
    """The casts the JAX package's ``tag_cast`` allows run on the device:
    the plan has no host node above the scan."""
    text = four_ways["q"].explain("device")
    host = [ln for ln in text.splitlines()
            if ln.lstrip().startswith("!") and "CpuScanExec" not in ln]
    assert not host, text


@pytest.mark.parametrize("build,reason", [
    (lambda M, T: M.col("f").cast(T.STRING),
     "float->string (shortest-roundtrip formatting) runs on host"),
    (lambda M, T: M.col("t").cast(T.STRING), "timestamp->string runs on host"),
    (lambda M, T: M.col("s").cast(T.TIMESTAMP),
     "parse runs on host"),
    (lambda M, T: M.col("s").cast(T.DecimalType(9, 2)),
     "parse runs on host"),
])
def test_host_only_directions_fall_back_with_jax_reasons(build, reason):
    import datetime
    table = pa.table({"f": [1.5, None], "s": ["2021-01-01 10:30:00", "1.25"],
                      "t": [datetime.datetime(2021, 1, 1, 10, 30), None]})
    q = TorchSession({}, device="cpu").create_dataframe(table).select(
        build(F, dt).alias("o"))
    jq = TpuSession({}).create_dataframe(table).select(
        build(JF, jdt).alias("o"))
    assert reason in q.explain("device")
    assert reason in jq.explain("tpu")
    assert q.collect().equals(jq.collect())


def test_zero_rows():
    table = _strings_table().slice(0, 0)
    q = TorchSession(_CONF, device="cpu").create_dataframe(table).select(
        *_casts(F, dt))
    out = q.collect()
    assert out.num_rows == 0 and out.equals(q.collect(device=False))


def test_reference_faults_the_port_does_not_copy():
    """A string parsed to a decimal past 18 digits keeps its value (the
    JAX package nulls it past 10^18); an underscored number is null (the
    JAX package's host engine takes it)."""
    table = pa.table({"s": ["12345678901234567890.5", "1_0", "7.25"]})
    to = dt.DecimalType(25, 1)
    out = TorchSession({}, device="cpu").create_dataframe(table).select(
        F.col("s").cast(to).alias("o")).collect()
    assert out.column("o").to_pylist() == [
        decimal.Decimal("12345678901234567890.5"), None,
        decimal.Decimal("7.3")]
    jout = TpuSession({}).create_dataframe(table).select(
        JF.col("s").cast(jdt.DecimalType(25, 1)).alias("o")).collect()
    assert jout.column("o").to_pylist()[:2] == [None, decimal.Decimal("10")]
