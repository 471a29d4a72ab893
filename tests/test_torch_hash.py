"""``hash``, ``xxhash64``, ``spark_partition_id`` and
``monotonically_increasing_id`` of the port (``expr/hashing.py``) against
the JAX package: the port's device path on the CPU (``row_hash``'s plain
version), its host engine, and the JAX package's device path and host
engine must give the same integers exactly, on every column type the
device hashes, with nulls inside the fold, -0.0 and NaN payloads, strings
of every length across the algorithms' 4-, 8- and 32-byte phases, and a
0-row batch. A decimal past 18 digits hashes Spark's way on the port (its
unscaled value's bytes); the JAX package raises there, which is pinned."""
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_CONF = {"spark.rapids.sql.test.enabled": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread: the tests run in several worker
    processes at once, and a thread pool each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(n: int = 240, seed: int = 11) -> pa.Table:
    rng = np.random.default_rng(seed)
    chars = list("abcxyz 019é日")
    strs = ["".join(rng.choice(chars, k)) for k in
            list(range(0, 70)) + list(rng.integers(0, 100, n - 70))]
    f = rng.normal(size=n)
    pick = rng.integers(0, 6, n)
    f[pick == 0] = 0.0
    f[pick == 1] = -0.0
    f.view(np.uint64)[pick == 2] = 0xFFF8000000000001
    f.view(np.uint64)[pick == 3] = 0x7FF8000000000000
    f32 = rng.normal(size=n).astype(np.float32)
    f32[pick == 1] = -0.0
    f32.view(np.uint32)[pick == 2] = 0xFFC00001

    def nulls(p=0.1):
        return rng.random(n) < p

    return pa.table({
        "b": pa.array(rng.random(n) < .5, mask=nulls()),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16),
                        mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                        mask=nulls()),
        "i64": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                        mask=nulls()),
        "f64": pa.array(f, mask=nulls()),
        "f32": pa.array(f32),
        "s": pa.array(strs, mask=nulls()),
        "d": pa.array(rng.integers(-10**5, 10**5, n).astype(np.int32),
                      mask=nulls()).cast(pa.date32()),
        "x": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                       rng.integers(-10**12, 10**12, n)],
                      type=pa.decimal128(14, 2)),
    })


_NAMES = ["b", "i8", "i16", "i32", "i64", "f64", "f32", "s", "d", "x"]


def _hashes(M):
    c = M.col
    return ([M.hash(c(n)).alias(f"h_{n}") for n in _NAMES]
            + [M.xxhash64(c(n)).alias(f"x_{n}") for n in _NAMES]
            + [M.hash(*[c(n) for n in _NAMES]).alias("h_all"),
               M.xxhash64(*[c(n) for n in _NAMES]).alias("x_all"),
               M.hash(c("s"), c("i32"), c("f64")).alias("h_mixed"),
               M.xxhash64(c("f32"), c("s")).alias("x_mixed")])


@pytest.fixture(scope="module")
def results():
    table = _table()
    q = TorchSession(_CONF, device="cpu").create_dataframe(
        table, num_partitions=2).select(*_hashes(F))
    jq = TpuSession(_CONF).create_dataframe(table, num_partitions=2) \
        .select(*_hashes(JF))
    return {"port_device": q.collect(), "port_host": q.collect(device=False),
            "jax_device": jq.collect(device=True),
            "jax_host": jq.collect(device=False), "q": q}


@pytest.mark.parametrize("engine", ["port_device", "port_host",
                                    "jax_device"])
def test_hashes_equal_jax_host_exactly(results, engine):
    want = results["jax_host"]
    for name in want.column_names:
        assert results[engine].column(name).equals(want.column(name)), \
            (engine, name)


def test_hashes_run_on_the_device_and_are_never_null(results):
    text = results["q"].explain("device")
    host = [ln for ln in text.splitlines()
            if ln.lstrip().startswith("!") and "CpuScanExec" not in ln]
    assert not host, text
    assert results["port_device"].column("h_all").null_count == 0


def test_null_leaves_the_running_hash_and_known_values():
    """hash of a null is the seed, 42; hash(1) is Spark's -559580957."""
    table = pa.table({"a": pa.array([1, None], type=pa.int32()),
                      "s": pa.array(["", None])})
    q = TorchSession(_CONF, device="cpu").create_dataframe(table).select(
        F.hash(F.col("a")).alias("h"), F.xxhash64(F.col("a")).alias("x"),
        F.hash(F.col("a"), F.col("s")).alias("h2"))
    out = q.collect()
    assert out.column("h").to_pylist() == [-559580957, 42]
    assert out.column("x").to_pylist()[1] == 42
    assert out.equals(q.collect(device=False))


def test_zero_rows_and_ids():
    table = _table(80, 3)
    sess = TorchSession(_CONF, device="cpu")
    jsess = TpuSession(_CONF)
    empty = sess.create_dataframe(table.slice(0, 0)).select(*_hashes(F))
    assert empty.collect().num_rows == 0
    q = sess.create_dataframe(table, num_partitions=4).select(
        F.spark_partition_id().alias("p"),
        F.monotonically_increasing_id().alias("m"))
    jq = jsess.create_dataframe(table, num_partitions=4).select(
        JF.spark_partition_id().alias("p"),
        JF.monotonically_increasing_id().alias("m"))
    out = q.collect()
    assert out.equals(q.collect(device=False))
    assert out.equals(jq.collect(device=False))
    assert sorted(set(out.column("p").to_pylist())) == [0, 1, 2, 3]
    assert [m >> 33 for m in out.column("m").to_pylist()] == \
        out.column("p").to_pylist()


def test_wide_decimal_hashes_spark_bytes_where_jax_raises():
    """DECIMAL(25,2): the plan keeps the hash on the host engine, as the
    JAX package's does; the port hashes Java's BigInteger.toByteArray of
    the unscaled value, the JAX package casts it to int64 and raises."""
    vals = [decimal.Decimal("123456789012345678901.25"),
            decimal.Decimal("-1.00"), decimal.Decimal("0.00")]
    table = pa.table({"w": pa.array(vals, type=pa.decimal128(25, 2))})
    q = TorchSession({}, device="cpu").create_dataframe(table).select(
        F.hash(F.col("w")).alias("h"), F.xxhash64(F.col("w")).alias("x"))
    out = q.collect()
    assert out.equals(q.collect(device=False))
    assert "!" in q.explain("device")
    from spark_rapids_tpu_torch.expr.hashing import (_big_int_bytes,
                                                     _np_matrix,
                                                     _np_mm_strings)
    unscaled = [12345678901234567890125, -100, 0]
    assert [_big_int_bytes(v) for v in (-128, 127, 128, 0)] == [
        b"\x80", b"\x7f", b"\x00\x80", b"\x00"]
    mat, lens = _np_matrix([_big_int_bytes(v) for v in unscaled])
    want = _np_mm_strings(mat, lens, np.full(3, 42, np.uint32))
    assert out.column("h").to_pylist() == want.view(np.int32).tolist()
    jq = TpuSession({}).create_dataframe(table).select(
        JF.hash(JF.col("w")).alias("h"))
    with pytest.raises(Exception):
        jq.collect(device=False)
