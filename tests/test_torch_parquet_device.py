"""The Parquet device decode of the PyTorch port (on the CPU: the kernels'
plain versions) against its host engine and the JAX package: the twelve
tests of tests/test_parquet_device.py, each file read through the port's
device path, its host engine and the JAX package (``assert_tables_equal``,
in row order), and ``decode_row_group`` against the JAX one plane by plane
(values, validity, lengths, row mask) on TPC-H lineitem and orders."""
import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.io.parquet_device import decode_row_group as jdecode
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import tpch as jtpch

from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec.scan import TpuParquetScanExec
from spark_rapids_tpu_torch.expr.functions import col, sum as f_sum
from spark_rapids_tpu_torch.io.parquet_device import decode_row_group
from spark_rapids_tpu_torch.plan.aqe import walk_plan
from spark_rapids_tpu_torch.session import TorchSession

from harness import assert_tables_equal

_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 64}
_CPU = torch.device("cpu")


def _write(tmp_path, n=4000, codec="snappy", use_dictionary=True,
           row_group_size=1500, nulls=True, with_strings=True):
    """tests/test_parquet_device.py::_write."""
    rng = np.random.default_rng(7)
    data = {
        "i64": pa.array(rng.integers(-10**12, 10**12, n), type=pa.int64()),
        "i32": pa.array(rng.integers(-2**30, 2**30, n).astype(np.int32)),
        "f64": pa.array(rng.normal(size=n)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "lowcard": pa.array(rng.integers(0, 40, n), type=pa.int64()),
        "date": pa.array(rng.integers(0, 20000, n).astype(np.int32)).cast(
            pa.date32()),
        "ts": pa.array(rng.integers(0, 2**48, n), type=pa.int64()).cast(
            pa.timestamp("us")),
    }
    if with_strings:
        data["s"] = pa.array([f"str{i % 11}" for i in range(n)])
    t = pa.table(data)
    if nulls:
        cols = {}
        for name in t.column_names:
            mask = rng.random(n) < 0.12
            arr = t.column(name).combine_chunks()
            cols[name] = pa.array(arr.to_pylist(), type=arr.type, mask=mask)
        t = pa.table(cols)
    p = str(tmp_path / "data.parquet")
    pq.write_table(t, p, row_group_size=row_group_size, compression=codec,
                   use_dictionary=use_dictionary)
    return p, t


@pytest.fixture
def sess():
    return TorchSession(_CONF, device="cpu")


@pytest.fixture
def jsess():
    return TpuSession({"spark.rapids.tpu.shuffle.mode": "host",
                       "spark.rapids.tpu.batchRowsMinBucket": 64})


def _three_ways(df, jdf, ignore_order=False, rel_tol=1e-9):
    """Port device, port host engine and JAX device: all equal; -> the
    port's device result."""
    dev = df.collect(device=True)
    assert_tables_equal(dev, df.collect(device=False), ignore_order,
                        rel_tol)
    assert_tables_equal(dev, jdf.collect(device=True), ignore_order,
                        rel_tol)
    return dev


def _find_scan(plan):
    return next((n for n in walk_plan(plan)
                 if isinstance(n, TpuParquetScanExec)), None)


@pytest.mark.parametrize("codec,use_dict", [("snappy", True),
                                            ("none", False),
                                            ("zstd", True),
                                            ("gzip", False)])
def test_device_scan_differential(sess, jsess, tmp_path, codec, use_dict):
    p, t = _write(tmp_path, codec=codec, use_dictionary=use_dict)
    dev = _three_ways(sess.read_parquet(p), jsess.read_parquet(p))
    assert_tables_equal(dev, t, ignore_order=False)
    assert _find_scan(sess._physical(sess.read_parquet(p).logical, True))


def test_device_scan_in_plan_and_kill_switch(sess, jsess, tmp_path):
    p, _ = _write(tmp_path)
    plan = sess._physical(sess.read_parquet(p).logical, True)
    assert "TpuParquetScanExec" in plan.tree_string(), plan.tree_string()
    key = "spark.rapids.tpu.parquet.deviceDecode.enabled"
    off = TorchSession({key: False}, device="cpu")
    joff = TpuSession({"spark.rapids.tpu.shuffle.mode": "host", key: False})
    plan2 = off._physical(off.read_parquet(p).logical, True)
    assert "TpuParquetScanExec" not in plan2.tree_string()
    assert plan2.tree_string() == joff._physical(
        joff.read_parquet(p).logical, True).tree_string()
    _three_ways(off.read_parquet(p), joff.read_parquet(p))


def test_pushed_filter_keeps_host_reader(sess, jsess, tmp_path):
    """Row-group statistics pruning lives in the host reader; a pushed
    filter therefore keeps the scan there (and stays correct)."""
    p, _ = _write(tmp_path, with_strings=False, nulls=False)
    q = sess.read_parquet(p).filter(col("i64") > 0)
    from spark_rapids_tpu.expr.functions import col as jcol
    jq = jsess.read_parquet(p).filter(jcol("i64") > 0)
    text = sess._physical(q.logical, True).tree_string()
    assert "TpuParquetScanExec" not in text, text
    assert text == jsess._physical(jq.logical, True).tree_string()
    _three_ways(q, jq, ignore_order=True)


def test_device_scan_feeds_aggregate(sess, jsess, tmp_path):
    p, t = _write(tmp_path)
    from spark_rapids_tpu.expr.functions import col as jcol
    from spark_rapids_tpu.expr.functions import sum as jsum
    q = sess.read_parquet(p).group_by("lowcard").agg(
        f_sum(col("f64")).alias("sf"))
    jq = jsess.read_parquet(p).group_by("lowcard").agg(
        jsum(jcol("f64")).alias("sf"))
    out = _three_ways(q, jq, ignore_order=True)
    lowcard = t.column("lowcard").to_numpy(zero_copy_only=False)
    assert out.num_rows == len({None if v != v else v for v in lowcard})


def test_string_columns_decode_on_device(sess, tmp_path):
    """BYTE_ARRAY columns decode on the device too: every column of the
    scan counts in ``deviceDecodedColumns``, none rides the fallback."""
    p, t = _write(tmp_path)
    plan = sess._physical(sess.read_parquet(p).logical, True)
    scan = _find_scan(plan)
    assert scan is not None
    batches = list(scan.execute_columnar(0))
    assert batches
    assert scan.metrics["deviceDecodedColumns"] == 9 * len(batches)
    got = pa.concat_tables([b.to_host().to_arrow() for b in batches])
    assert got.column("s").to_pylist() == \
        t.column("s").to_pylist()[:got.num_rows]


def test_column_pruning_through_device_scan(sess, jsess, tmp_path):
    p, _ = _write(tmp_path)
    dev = _three_ways(sess.read_parquet(p).select("i64", "f64"),
                      jsess.read_parquet(p).select("i64", "f64"))
    assert dev.column_names == ["i64", "f64"]


def test_mixed_width_dictionary_pages(sess, jsess, tmp_path):
    """A growing dictionary makes successive pages bit-pack at different
    widths; the run table records the width per run."""
    rng = np.random.default_rng(11)
    n = 200_000
    vals = np.minimum(rng.integers(0, 200, n).cumsum() % 120,
                      np.arange(n) // 500)
    t = pa.table({"v": pa.array(vals, type=pa.int64())})
    p = str(tmp_path / "growdict.parquet")
    pq.write_table(t, p, row_group_size=n, data_page_size=8 * 1024,
                   compression="snappy")
    plan = sess._physical(sess.read_parquet(p).logical, True)
    assert "TpuParquetScanExec" in plan.tree_string()
    dev = _three_ways(sess.read_parquet(p), jsess.read_parquet(p))
    assert dev.column("v").to_pylist() == t.column("v").to_pylist()


def test_unsupported_codec_falls_back_to_host(sess, jsess, tmp_path):
    """Hadoop-framed LZ4 is unreadable by pa.decompress: those columns
    decode on the host, per column, and ``deviceDecodedColumns`` says
    so."""
    t = pa.table({"a": pa.array(np.arange(5000, dtype=np.int64)),
                  "b": pa.array(np.random.default_rng(1).normal(size=5000))})
    p = str(tmp_path / "lz4.parquet")
    pq.write_table(t, p, compression="lz4")
    dev = _three_ways(sess.read_parquet(p), jsess.read_parquet(p))
    assert_tables_equal(dev, t, ignore_order=False)
    scan = _find_scan(sess._physical(sess.read_parquet(p).logical, True))
    out = [b.to_host().to_arrow() for b in scan.execute_columnar(0)]
    assert scan.metrics["deviceDecodedColumns"] == 0
    assert_tables_equal(pa.concat_tables(out), t, ignore_order=False)


def test_empty_and_single_row_groups(sess, jsess, tmp_path):
    t = pa.table({"a": pa.array([], type=pa.int64()),
                  "b": pa.array([], type=pa.float64())})
    p = str(tmp_path / "empty.parquet")
    pq.write_table(t, p)
    assert sess.read_parquet(p).collect(device=True).num_rows == 0
    assert jsess.read_parquet(p).collect(device=True).num_rows == 0
    t2 = pa.table({"a": pa.array([42], type=pa.int64())})
    p2 = str(tmp_path / "one.parquet")
    pq.write_table(t2, p2)
    out = _three_ways(sess.read_parquet(p2), jsess.read_parquet(p2))
    assert out.column("a").to_pylist() == [42]


def _decode_both(raw, names, min_bucket, rg=0, conf=None, jconf=None):
    pf = pq.ParquetFile(io.BytesIO(raw))
    got = decode_row_group(raw, pf.metadata, rg, pf.schema_arrow, names,
                           min_bucket, _CPU, conf=conf)
    want = jdecode(raw, pf.metadata, rg, pf.schema_arrow, names, min_bucket,
                   conf=jconf)
    return pf, got, want


def _assert_planes_equal(got, want):
    """Port and JAX DeviceTables plane by plane: row mask, row count, and
    each column's values, validity and lengths."""
    np.testing.assert_array_equal(got.row_mask.numpy(),
                                  np.asarray(want.row_mask))
    assert int(got.num_rows) == int(want.num_rows)
    assert got.names == tuple(want.names)
    for name, c, jc in zip(got.names, got.columns, want.columns):
        np.testing.assert_array_equal(c.data.numpy(), np.asarray(jc.data),
                                      err_msg=name)
        np.testing.assert_array_equal(c.validity.numpy(),
                                      np.asarray(jc.validity), err_msg=name)
        assert (c.lengths is None) == (jc.lengths is None), name
        if c.lengths is not None:
            np.testing.assert_array_equal(c.lengths.numpy(),
                                          np.asarray(jc.lengths),
                                          err_msg=name)


@pytest.mark.parametrize("label,kw", [
    ("plain-v1", dict(use_dictionary=False)),
    ("mixed-v1", dict(use_dictionary=True,
                      dictionary_pagesize_limit=4096, data_page_size=2048)),
    ("dict-v2", dict(data_page_version="2.0")),
    ("plain-v2", dict(use_dictionary=False, data_page_version="2.0")),
    ("mixed-v2", dict(use_dictionary=True, dictionary_pagesize_limit=4096,
                      data_page_size=2048, data_page_version="2.0")),
])
def test_string_and_v2_page_matrix(label, kw):
    """Strings and numbers across PLAIN, dictionary-overflow-mixed chunks
    and data pages v1/v2: all decode on the device, plane for plane equal
    to the JAX package's and to the host read."""
    rng = np.random.default_rng(5)
    n = 4000
    raw_s = ["s" + str(rng.integers(0, 10**9)) * rng.integers(1, 4)
             for _ in range(n)]
    mask = rng.random(n) < 0.1
    t = pa.table({
        "s": pa.array(raw_s, type=pa.string(), mask=mask),
        "i": pa.array(rng.integers(-2**40, 2**40, n), type=pa.int64()),
        "f": pa.array(rng.normal(size=n)),
    })
    buf = io.BytesIO()
    pq.write_table(t, buf, row_group_size=n, compression="snappy", **kw)
    pf, (got, ndev), (want, jndev) = _decode_both(buf.getvalue(),
                                                  ["s", "i", "f"], 64)
    assert ndev == jndev == 3, f"{label}: {ndev}/3 columns on the device"
    _assert_planes_equal(got, want)
    host = pf.read_row_group(0)
    out = got.to_host().to_arrow()
    for c in ("s", "i", "f"):
        assert out.column(c).to_pylist() == host.column(c).to_pylist(), \
            f"{label}: column {c} diverged"


def test_tpch_lineitem_orders_full_device_decode():
    """Every column of TPC-H lineitem and orders at SF 0.01 (strings too)
    decodes on the device: the port's ``decode_row_group`` equals the JAX
    one plane by plane, and the host read."""
    tables = jtpch.gen_all(0.01)
    for tname in ("lineitem", "orders"):
        t = tables[tname]
        buf = io.BytesIO()
        pq.write_table(t, buf, row_group_size=t.num_rows,
                       compression="snappy")
        names = list(t.column_names)
        pf, (got, ndev), (want, jndev) = _decode_both(buf.getvalue(), names,
                                                      64)
        assert ndev == jndev == len(names), \
            f"{tname}: {ndev}/{len(names)} columns on the device"
        _assert_planes_equal(got, want)
        out = got.to_host().to_arrow()
        host = pf.read_row_group(0)
        for c in names:
            assert out.column(c).to_pylist() == host.column(c).to_pylist(), \
                f"{tname}.{c} diverged"


def test_per_type_device_decode_gates():
    """Per-type kill switches (reference: the per-type read enables,
    RapidsConf.scala:877-917): strings and booleans can be sent back to
    the host column decode independently."""
    from spark_rapids_tpu.conf import RapidsConf as JConf
    t = pa.table({"s": pa.array(["a", "bb", "ccc"] * 10),
                  "b": pa.array([True, False, True] * 10),
                  "i": pa.array(np.arange(30, dtype=np.int64))})
    buf = io.BytesIO()
    pq.write_table(t, buf, compression="none")
    raw = buf.getvalue()
    _, (got, nd), (want, jnd) = _decode_both(raw, ["s", "b", "i"], 8,
                                             conf=RapidsConf(),
                                             jconf=JConf())
    assert nd == jnd == 3
    _assert_planes_equal(got, want)
    off = {"spark.rapids.tpu.parquet.deviceDecode.strings.enabled": False,
           "spark.rapids.tpu.parquet.deviceDecode.booleans.enabled": False}
    _, (got2, nd2), (want2, jnd2) = _decode_both(
        raw, ["s", "b", "i"], 8, conf=RapidsConf(off), jconf=JConf(off))
    assert nd2 == jnd2 == 1  # only the int column stayed on the device
    _assert_planes_equal(got2, want2)
    assert got2.to_host().to_arrow().column("s").to_pylist() == \
        t.column("s").to_pylist()


def test_small_ints_and_millisecond_timestamps_decode_right(tmp_path):
    """Two faults of the JAX package's device decode that the port does not
    copy: a PLAIN page of an int8/int16 column (stored as INT32) is read as
    INT64 (``_decode_column_device`` picks the physical type from the
    value's width), and a timestamp in milliseconds keeps its raw values as
    microseconds. The port reads the page by its physical type and sends a
    timestamp in another unit than microseconds to the host decode; both
    equal pyarrow's read, through ``decode_row_group`` and the scan."""
    n = 100
    t = pa.table({
        "i8": pa.array(np.arange(-50, 50, dtype=np.int8)),
        "i16": pa.array(np.arange(-500, 500, 10, dtype=np.int16)),
        "tsms": pa.array(np.arange(n, dtype=np.int64) * 1000 + 7,
                         pa.timestamp("ms"))})
    buf = io.BytesIO()
    pq.write_table(t, buf, use_dictionary=False)
    raw = buf.getvalue()
    names = t.column_names
    pf, (got, ndev), (want, jndev) = _decode_both(raw, names, 64)
    assert (ndev, jndev) == (2, 3)   # the port sends tsms to the host
    host = pf.read_row_group(0)
    out = got.to_host().to_arrow()
    jout = want.to_host().to_arrow()
    for c in ("i8", "i16"):
        assert out.column(c).to_pylist() == host.column(c).to_pylist()
        assert jout.column(c).to_pylist() != host.column(c).to_pylist()
    assert out.column("tsms").cast(pa.timestamp("ms")).to_pylist() == \
        host.column("tsms").to_pylist()
    assert jout.column("tsms").cast(pa.int64()).to_pylist() == \
        host.column("tsms").cast(pa.int64()).to_pylist()  # ms read as us
    path = tmp_path / "small.parquet"
    path.write_bytes(raw)
    sess = TorchSession(_CONF, device="cpu")
    df = sess.read_parquet(str(path))
    scanned = df.collect()
    assert_tables_equal(scanned, df.collect(device=False),
                        ignore_order=False)
    assert scanned.column("i8").to_pylist() == t.column("i8").to_pylist()


@pytest.mark.parametrize("use_dictionary", [False, True])
def test_kernel_library_that_fails_to_load_raises(tmp_path, monkeypatch,
                                                  use_dictionary):
    """On the card, a kernel library that cannot load (dlopen's OSError)
    raises out of ``decode_row_group``; it must not send the columns to
    the host decode. PLAIN string pages reach the library's host walk
    inside the parse, so that case is the one a broad catch would hide."""
    from spark_rapids_tpu_torch import native

    def refuse():
        raise OSError("kernel library refused to load")
    monkeypatch.setattr(native, "load_kernels", refuse)
    p, _ = _write(tmp_path, n=300, use_dictionary=use_dictionary)
    raw = open(p, "rb").read()
    pf = pq.ParquetFile(io.BytesIO(raw))
    with pytest.raises(OSError, match="refused to load"):
        decode_row_group(raw, pf.metadata, 0, pf.schema_arrow, ["s"], 64,
                         torch.device("cuda"))


def test_refused_codec_is_an_unsupported_chunk():
    """``_decompress`` turns what ``pyarrow.decompress`` refuses into
    UnsupportedChunk, the host decode's signal; OSError is not caught."""
    from spark_rapids_tpu_torch.io import parquet_device as pdev
    assert OSError not in pdev._HOST_DECODE_ERRORS
    for codec in ("LZ4", "LZO", "BZ2"):
        with pytest.raises(pdev.UnsupportedChunk, match=codec):
            pdev._decompress(b"not a frame", codec, 64)


def test_staged_blob_holds_the_kernels_tail(monkeypatch):
    """A string chunk's page bytes reach the gather 16-byte aligned with
    16 bytes past the bytes it uses, as its aligned 16-byte reads need (its
    wrapper refuses anything less), and those bytes are the chunk's."""
    from spark_rapids_tpu_torch.io import parquet_device as pdev
    seen = []
    gather = pdev.pq_gather_byte_array

    def record(*args):
        seen.append(args)
        return gather(*args)

    monkeypatch.setattr(pdev, "pq_gather_byte_array", record)
    rng = np.random.default_rng(11)
    n = 3000
    t = pa.table({"s": pa.array(["v" * int(k) for k in
                                 rng.integers(0, 40, n)],
                                mask=rng.random(n) < 0.1)})
    for kw in ({}, {"use_dictionary": False}):
        buf = io.BytesIO()
        pq.write_table(t, buf, **kw)
        seen.clear()
        _pf, (got, ndev), (want, _) = _decode_both(buf.getvalue(), ["s"], 64)
        assert ndev == 1 and len(seen) == 1
        blob, n_blob = seen[0][5], seen[0][6]
        assert blob.data_ptr() % 16 == 0
        assert blob.numel() >= n_blob + 16
        assert int(seen[0][4].sum()) <= n_blob   # the values' bytes
        _assert_planes_equal(got, want)


def test_host_split_times_each_stage_and_the_run_tables(tmp_path):
    """``host_split()`` gathers the host seconds of each decode stage and
    each chunk's run-table shape; outside the block nothing is gathered."""
    from spark_rapids_tpu_torch.io import parquet_device as pdev
    p, _ = _write(tmp_path, n=3000, row_group_size=1000)
    raw = open(p, "rb").read()
    pf = pq.ParquetFile(io.BytesIO(raw))
    names = pf.schema_arrow.names
    with pdev.host_split() as split:
        for rg in range(pf.metadata.num_row_groups):
            decode_row_group(raw, pf.metadata, rg, pf.schema_arrow, names,
                             64, _CPU)
        with pytest.raises(RuntimeError):
            with pdev.host_split():
                pass
    assert pdev._split is None
    assert split["row_groups"] == 3
    for stage in ("pages", "run_tables", "count_defined", "staging",
                  "upload", "kernels", "total"):
        assert split[stage] > 0, stage
    assert sum(split[s] for s in pdev.SPLIT_STAGES) <= split["total"]
    assert set(split["runs"]) == set(names)
    for name, shapes in split["runs"].items():
        streams = [s for s, _, _ in shapes]
        assert streams.count("defs") == 3, name
        for _, r, values in shapes:
            assert 1 <= r <= values
        assert all(v == 1000 for s, _, v in shapes if s == "defs")
    before = dict(split)
    decode_row_group(raw, pf.metadata, 0, pf.schema_arrow, names, 64, _CPU)
    assert split == before
