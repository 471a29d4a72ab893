"""The date and time functions this slice ports (``expr/datetimes.py``):
hour, minute and second, date arithmetic, ``months_between``, ``trunc``,
``unix_timestamp``, and the host-only ``date_format`` and
``from_unixtime``, through the port's device path on the CPU, its host
engine and the JAX package's device path and host engine, on the same
table (dates across four centuries, leap days and month ends, timestamps
before and after the epoch, nulls). Everything is integer arithmetic but
``months_between``, whose double formula is the same on all four: all of
it must equal both host engines exactly; against the JAX device path
``months_between`` is held at rel 1e-12, because XLA turns its divisions
by constants into products with their reciprocals."""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from harness import assert_tables_equal
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


def _table() -> pa.Table:
    rng = np.random.default_rng(21)
    n = 240
    days = rng.integers(-60_000, 60_000, n).astype(np.int32)
    days[:8] = [0, -1, 11_016, 11_017, 18_321, 18_322, -25_508, 10_956]
    ts = rng.integers(-2 * 10**15, 2 * 10**15, n)
    ts[:4] = [0, -1, 86_399_999_999, -86_400_000_001]
    return pa.table({
        "d": pa.array(days, mask=rng.random(n) < 0.06).cast(pa.date32()),
        "e": pa.array(rng.integers(-60_000, 60_000, n).astype(np.int32)
                      ).cast(pa.date32()),
        "ts": pa.array(ts, type=pa.timestamp("us"),
                       mask=rng.random(n) < 0.06),
        "m": pa.array(rng.integers(-40, 40, n).astype(np.int32),
                      mask=rng.random(n) < 0.06),
    })


def _device_fns(X):
    c, lit = X.col, X.lit
    return [X.hour(c("ts")).alias("h"), X.minute(c("ts")).alias("mi"),
            X.second(c("ts")).alias("s"),
            X.date_add(c("d"), c("m")).alias("add"),
            X.date_sub(c("d"), lit(10)).alias("sub"),
            X.datediff(c("d"), c("e")).alias("diff"),
            X.datediff(c("ts"), c("d")).alias("diff_ts"),
            X.add_months(c("d"), c("m")).alias("am"),
            X.last_day(c("d")).alias("ld"),
            X.months_between(c("d"), c("e")).alias("mb"),
            X.months_between(c("ts"), c("d"), False).alias("mb_ts"),
            X.trunc(c("d"), "year").alias("ty"),
            X.trunc(c("d"), "MM").alias("tm"),
            X.trunc(c("d"), "quarter").alias("tq"),
            X.trunc(c("d"), "week").alias("tw"),
            X.unix_timestamp(c("ts")).alias("ut"),
            X.unix_timestamp(c("d")).alias("ud")]


def _host_fns(X):
    c = X.col
    return [X.date_format(c("d"), "yyyy-MM-dd").alias("fmt"),
            X.from_unixtime(X.unix_timestamp(c("ts"))).alias("fu")]


@pytest.fixture(scope="module")
def runs():
    table = _table()
    sess = TorchSession(_CONF, device="cpu")
    jsess = TpuSession(_CONF)
    out = {}
    for kind, build in (("device", _device_fns), ("host", _host_fns)):
        conf_sess = sess if kind == "device" else TorchSession({},
                                                               device="cpu")
        conf_jsess = jsess if kind == "device" else TpuSession({})
        q = conf_sess.create_dataframe(table, num_partitions=2) \
            .select(*build(F))
        jq = conf_jsess.create_dataframe(table, num_partitions=2) \
            .select(*build(JF))
        out[kind] = (q, jq, q.collect(), q.collect(device=False),
                     jq.collect(device=True), jq.collect(device=False))
    return out


@pytest.mark.parametrize("kind", ["device", "host"])
def test_equal_four_ways(runs, kind):
    q, jq, dev, host, jdev, jhost = runs[kind]
    assert dev.equals(host) and dev.equals(jhost)
    assert_tables_equal(dev, jdev, ignore_order=False, rel_tol=1e-12)


def test_calendar_cross_checks(runs):
    rows = runs["device"][2].to_pylist()
    table = _table().to_pylist()
    for r, t in zip(rows, table):
        if t["ts"] is not None:
            assert (r["h"], r["mi"], r["s"]) == (t["ts"].hour,
                                                 t["ts"].minute,
                                                 t["ts"].second)
        if t["d"] is None:
            continue
        assert (r["ld"] + datetime.timedelta(days=1)).day == 1
        assert r["diff"] == (t["d"] - t["e"]).days
        assert r["tm"] == t["d"].replace(day=1)
        assert r["ty"] == t["d"].replace(month=1, day=1)
        assert r["tw"].weekday() == 0 and 0 <= (t["d"] - r["tw"]).days < 7


def test_plans_and_reasons(runs):
    """The device functions run on the device; the formatting ones on the
    host engine, with the JAX package's reason."""
    q, jq = runs["device"][:2]
    text = q.explain("device")
    assert all("CpuScanExec" in ln for ln in text.splitlines()
               if ln.lstrip().startswith("!")), text
    hq, hjq = runs["host"][:2]
    assert "host-only: formatting" in hq.explain("device")
    assert "DateFormatClass" in hjq.explain("tpu")
