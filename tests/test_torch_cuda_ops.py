"""The keyed aggregate's, the sort's and the joins' torch ops on the card
against the same functions on the CPU, without the JAX package, so the file
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ops.py

The CPU side is held against the JAX package by tests/test_torch_groupby.py,
tests/test_torch_joins.py and tests/test_torch_join_types.py; here every
test needs the card and skips without one. Grouping planes, sort
permutations, hashes, key words, join codes, counts and join outputs must be
equal exactly; float64 group sums at rel 1e-12, since the card adds each
group's values in another order than the CPU (but in the same order in every
run). String functions and LIKE (its ``nfa_match`` kernel included) must
give the CPU's values exactly."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar.device import pack_string_key_words
from spark_rapids_tpu_torch.columnar.interop import device_table_from_numpy
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.exec import aggregate as agg
from spark_rapids_tpu_torch.exec import sort as srt
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.manager import fmix_device
from spark_rapids_tpu_torch.tools import tpch
from spark_rapids_tpu_torch.udf.kernels import nfa_match

_WORDS = ["", "a", "ab", "ab\x00", "Spark", "ünïcode", "longer string value",
          "日本語", "zz"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (run on the card)")
    return torch.device("cuda")


def _planes(seed: int, n: int, cap: int, width: int = 32):
    """Column planes with nulls, NaN, -0.0, +-inf, extreme ints and strings
    of mixed lengths in a ``width``-byte matrix; rows past ``n`` hold stale
    values."""
    rng = np.random.default_rng(seed)
    raw = [_WORDS[i].encode() for i in rng.integers(0, len(_WORDS), cap)]
    mat = np.zeros((cap, width), np.uint8)
    lengths = np.zeros(cap, np.int32)
    for i, b in enumerate(raw):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    cols = {
        "s": ("string", mat, lengths),
        "d": ("double", rng.choice(np.array(
            [0.0, -0.0, np.nan, 1.5, -2.25, np.inf, -np.inf]), cap), None),
        "i": ("bigint", rng.choice(np.array(
            [-2**63, -1, 0, 5, 2**63 - 1]), cap), None),
        "b": ("boolean", rng.random(cap) < 0.5, None),
        "v": ("double", rng.normal(size=cap) * 1e3, None),
    }
    row_mask = np.zeros(cap, dtype=bool)
    row_mask[:n] = rng.random(n) < 0.9
    validity = {name: rng.random(cap) >= 0.2 for name in cols}
    return cols, validity, row_mask


def _table(planes, device):
    cols, validity, row_mask = planes
    spec = []
    for name, (d, data, lengths) in cols.items():
        c = {"data": data, "validity": validity[name], "dtype": d,
             "all_valid": False}
        if lengths is not None:
            c["lengths"] = lengths
        spec.append(c)
    return device_table_from_numpy(list(cols), spec, row_mask,
                                   row_mask.sum(), device)


@pytest.mark.cuda
def test_fmix_and_string_words_on_card_equal_cpu(cuda_device):
    vals = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, 1 << 20, dtype=np.uint64).astype(np.int64))
    np.testing.assert_array_equal(
        fmix_device(vals.to(cuda_device)).cpu().numpy(),
        fmix_device(vals).numpy())
    planes = _planes(1, 5000, 8192)
    for dev_word, cpu_word in zip(
            pack_string_key_words(*(torch.from_numpy(a).to(cuda_device)
                                    for a in planes[0]["s"][1:])),
            pack_string_key_words(*(torch.from_numpy(a)
                                    for a in planes[0]["s"][1:]))):
        np.testing.assert_array_equal(dev_word.cpu().numpy(),
                                      cpu_word.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [["s"], ["d"], ["s", "d", "i", "b"]])
@pytest.mark.parametrize("n,cap", [(300, 512), (70000, 1 << 17)])
def test_hash_group_ids_on_card_equal_cpu(cuda_device, keys, n, cap):
    planes = _planes(n, n, cap)
    got = agg._hash_group_ids(_table(planes, cuda_device), keys)
    want = agg._hash_group_ids(_table(planes, "cpu"), keys)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("op,col,out", [
    ("sum", "v", dt.DOUBLE), ("count", "v", dt.LONG), ("sum", "i", dt.LONG),
    ("min", "d", dt.DOUBLE), ("max", "d", dt.DOUBLE), ("min", "i", dt.LONG),
    ("max", "b", dt.BOOLEAN)])
def test_grouped_reductions_on_card_equal_cpu(cuda_device, op, col, out):
    planes = _planes(7, 100_000, 1 << 17)
    gids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 6, 1 << 17).astype(np.int32))
    results = []
    for device in (cuda_device, "cpu"):
        t = _table(planes, device)
        c = t.column(col)
        contrib = torch.logical_and(c.validity, t.row_mask)
        results.append(agg._reduce_segment(op, c.data, contrib,
                                           gids.to(device), 1 << 17, out))
    (gv, gh), (wv, wh) = results
    np.testing.assert_array_equal(gh.cpu().numpy(), wh.numpy())
    if op == "sum" and out == dt.DOUBLE:
        np.testing.assert_allclose(gv.cpu().numpy(), wv.numpy(), rtol=1e-12)
    else:
        np.testing.assert_array_equal(gv.cpu().numpy(), wv.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("orders", [
    [F.col("s").asc()], [F.SortOrder(F.col("s").expr, False, True)],
    [F.col("d").desc(), F.col("i").asc()],
    [F.col("b").asc(), F.SortOrder(F.col("d").expr, True, False),
     F.col("s").desc()]], ids=["s", "s_desc", "d_desc_i", "b_d_s"])
def test_sort_permutation_on_card_equals_cpu(cuda_device, orders):
    planes = _planes(11, 70000, 1 << 17)
    got = srt.lexsort(srt._order_keys(_table(planes, cuda_device), orders))
    want = srt.lexsort(srt._order_keys(_table(planes, "cpu"), orders))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("parts,min_bucket", [(1, 8), (3, 1024)])
def test_q1_on_card_equals_host_engine(cuda_device, parts, min_bucket):
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": min_bucket,
                         "spark.rapids.sql.test.enabled": True})
    q = tpch.q1({"lineitem": sess.create_dataframe(
        tpch.gen_lineitem(0, seed=0, rows=70000), num_partitions=parts)})
    got, want = q.collect(), q.collect(device=False)
    assert got.schema == want.schema and got.num_rows == want.num_rows == 6
    for name in got.column_names:
        a, b = got.column(name).to_pylist(), want.column(name).to_pylist()
        if isinstance(a[0], float):
            np.testing.assert_allclose(a, b, rtol=1e-9)
        else:
            assert a == b


def _key_table(seed: int, n: int, cap: int, distinct: int, device):
    """A one-key table (int64 keys of ``distinct`` values with the top bit
    set, nulls, masked-off rows) on ``device``."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-2**63, 2**63 - 1, distinct)
    cols = [{"data": rng.choice(pool, cap), "validity": rng.random(cap) > 0.1,
             "dtype": "bigint", "all_valid": False}]
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = rng.random(n) < 0.9
    return device_table_from_numpy(["k"], cols, mask, mask.sum(), device)


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [50, 1 << 20])
def test_join_steps_on_card_equal_cpu(cuda_device, distinct):
    """The hash prep's slot table and uniqueness, the probe walk, the sorted
    prep and the counts: exactly the CPU's."""
    from spark_rapids_tpu_torch.exec import joins as J
    outs = []
    for device in ("cpu", cuda_device):
        build = _key_table(1, 60_000, 1 << 16, distinct, device)
        probe = _key_table(2, 200_000, 1 << 18, distinct, device)
        bk, pk = build.column("k"), probe.column("k")
        slot_row, bv, unique = J.build_prep_hash(bk, build.row_mask)
        found, bi = J.pk_hash_probe(pk, probe.row_mask, slot_row, bv)
        b_order, sv, nvalid, sunique = J.build_prep_sorted(bk,
                                                           build.row_mask)
        starts, counts = J.probe_count(pk, probe.row_mask, sv, nvalid)
        outs.append([t.cpu() for t in (slot_row, unique, found, bi, b_order,
                                       sv, nvalid, sunique, starts, counts)])
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aqe", [True, False])
def test_q3_on_card_equals_host_engine(cuda_device, aqe):
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 1024,
                         "spark.rapids.sql.test.enabled": True,
                         "spark.rapids.tpu.autoBroadcastJoinThreshold": -1,
                         "spark.rapids.tpu.aqe.enabled": aqe,
                         "spark.rapids.tpu.aqe.autoBroadcastJoinThreshold":
                             20000})
    tables = {"customer": tpch.gen_customer(0, rows=300),
              "orders": tpch.gen_orders(0, rows=3000),
              "lineitem": tpch.gen_lineitem(0, rows=12000)}
    q = tpch.q3({k: sess.create_dataframe(v, num_partitions=3)
                 for k, v in tables.items()})
    got, want = q.collect(), q.collect(device=False)
    assert got.schema == want.schema and got.num_rows == want.num_rows == 10
    for name in got.column_names:
        a, b = got.column(name).to_pylist(), want.column(name).to_pylist()
        if isinstance(a[0], float):
            np.testing.assert_allclose(a, b, rtol=1e-9)
        else:
            assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [["s"], ["d"], ["s", "d", "i", "b"]])
def test_join_codes_and_counts_on_card_equal_cpu(cuda_device, keys):
    """The general join codes (string words of two matrix widths, floats
    with NaN and -0.0, several keys), the stable counts and the build-row
    tracking: exactly the CPU's."""
    from spark_rapids_tpu_torch.exec import joins as J
    outs = []
    for device in ("cpu", cuda_device):
        build = _table(_planes(21, 30_000, 1 << 15), device)
        probe = _table(_planes(22, 100_000, 1 << 17, width=24), device)
        bgid, pgid = J.join_codes(
            [build.column(k) for k in keys], build.row_mask,
            [probe.column(k) for k in keys], probe.row_mask)
        outs.append([t.cpu() for t in (bgid, pgid,
                                       *J.count_matches(bgid, pgid),
                                       J.build_matched(bgid, pgid))])
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


def _join_sides(seed: int) -> dict:
    """Two sides keyed by a string (nulls, empty, multi-byte) and a double
    (NaN, -0.0, nulls), with many rows to a key."""
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "b", "Spark", "ünïcode", "日本語",
                      "longer string value", "zz"], dtype=object)
    floats = np.array([0.0, -0.0, np.nan, 1.5, -2.25])

    def side(n, names):
        k, k2, v, w = names
        return pa.table({
            k: pa.array(rng.choice(words, n), mask=rng.random(n) < 0.05),
            k2: pa.array(rng.choice(floats, n), mask=rng.random(n) < 0.05),
            v: rng.integers(-50, 50, n), w: rng.normal(size=n) * 40})
    return {"l": side(900, ("k", "k2", "a", "x")),
            "r": side(400, ("rk", "rk2", "b", "y"))}


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_joins_with_conditions_in_windows_on_card_equal_cpu(cuda_device,
                                                            how,
                                                            monkeypatch):
    """Every join type on a string and a float key with a residual
    condition, over a batch budget small enough that the output comes in
    windows (``slice_rows`` and ``_windowed_expand``): the card's rows equal
    the same plan's on the CPU in order, and the host engine's."""
    from harness import assert_tables_equal
    from spark_rapids_tpu_torch.exec import joins as J
    windows = []
    real = J.TpuShuffledHashJoinExec._windowed_expand

    def spy(self, *args):
        windows.append(self.how)
        yield from real(self, *args)
    monkeypatch.setattr(J.TpuShuffledHashJoinExec, "_windowed_expand", spy)
    results = []
    for device in ("cpu", cuda_device):
        before = len(windows)
        sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                             "spark.rapids.tpu.batchRowsMinBucket": 64,
                             "spark.rapids.sql.batchSizeBytes": 96 * 1024},
                            device=device)
        t = {k: sess.create_dataframe(v, num_partitions=2)
             for k, v in _join_sides(5).items()}
        q = t["l"].join(t["r"], how=how, condition=(
            F.col("k") == F.col("rk")) & (F.col("k2") == F.col("rk2"))
            & (F.col("a") > F.col("b")))
        results.append(q.collect())
        assert len(windows) > before, "no windowed expand"
    assert_tables_equal(results[1], results[0])
    assert_tables_equal(results[1], q.collect(device=False),
                        ignore_order=True)


@pytest.mark.cuda
def test_float_group_sums_on_card_are_the_same_every_run(cuda_device):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(900.0, 105_000.0, 1 << 18))
    gid = torch.from_numpy(rng.integers(0, 10_000, 1 << 18)
                           .astype(np.int32))
    runs = [agg._seg_sum(x.to(cuda_device), gid.to(cuda_device), 10_000)
            for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    np.testing.assert_allclose(runs[0].cpu().numpy(),
                               agg._seg_sum(x, gid, 10_000).numpy(),
                               rtol=1e-12)


@pytest.mark.cuda
def test_q15_on_card_equals_host_engine(cuda_device):
    """Q15 keeps the suppliers whose revenue EQUALS the maximum revenue,
    computed again by its scalar subquery: both sums must agree to the last
    bit."""
    sess = TorchSession({"spark.rapids.sql.test.enabled": True})
    q = tpch.q15({"lineitem": sess.create_dataframe(
        tpch.gen_lineitem(0.05, seed=0), num_partitions=2),
        "supplier": sess.create_dataframe(tpch.gen_supplier(0.05, seed=4))})
    got, want = q.collect(), q.collect(device=False)
    assert got.num_rows == want.num_rows == 1
    assert got.column("s_suppkey").to_pylist() \
        == want.column("s_suppkey").to_pylist()


_LIKE_ROWS = ["special requests", "special\nrequests", "x special\r\n"
              "requests y", "specialrequests", "requests special", "",
              "Customer Complaints", "Customer\nComplaints",
              "ünïcode special 日本 requests", "special request"]


def _like_frame(sess, table: str, column: str):
    """A TPC-H table's comments at SF 0.01 plus rows with line terminators
    and multi-byte characters, in two partitions."""
    t = (tpch.gen_orders(0.01, seed=1) if table == "orders"
         else tpch.gen_supplier(0.01, seed=4)).select([column])
    extra = pa.table({column: _LIKE_ROWS * 20})
    return sess.create_dataframe(pa.concat_tables([t, extra]),
                                 num_partitions=2)


@pytest.mark.cuda
@pytest.mark.parametrize("table,column,pattern", [
    ("orders", "o_comment", "%special%requests%"),
    ("supplier", "s_comment", "%Customer%Complaints%")])
def test_like_filters_on_card_equal_cpu(cuda_device, table, column,
                                        pattern):
    out = {}
    for device in (cuda_device, "cpu"):
        sess = TorchSession({"spark.rapids.sql.test.enabled": True},
                            device=device)
        df = _like_frame(sess, table, column)
        nfa_match.launches = 0
        out[str(device)] = (df.filter(~F.col(column).like(pattern))
                            .collect(), df.filter(F.col(column).like(pattern))
                            .collect())
        if device != "cpu":
            assert nfa_match.launches == 4  # one per batch, two queries
        host = (df.filter(~F.col(column).like(pattern)).collect(device=False),
                df.filter(F.col(column).like(pattern)).collect(device=False))
    assert out["cuda"][0].equals(out["cpu"][0])
    assert out["cuda"][1].equals(out["cpu"][1])
    assert out["cpu"][0].equals(host[0]) and out["cpu"][1].equals(host[1])
    assert out["cuda"][1].num_rows > 20


@pytest.mark.cuda
@pytest.mark.parametrize("pos,ln", [(1, 2), (0, 3), (-3, 2), (-30, 28),
                                    (5, 100), (40, 2), (2, -1)])
def test_substring_on_card_equals_cpu(cuda_device, pos, ln):
    words = ["13-555-0100", "", "ünïcode", "日本語のテキスト", "a",
             "x" * 60 + "é"]
    table = pa.table({"s": words * 50})
    got = {}
    for device in (cuda_device, "cpu"):
        sess = TorchSession({"spark.rapids.sql.test.enabled": True},
                            device=device)
        df = sess.create_dataframe(table, num_partitions=2)
        got[str(device)] = df.select(F.substring(F.col("s"), pos, ln)
                                     .alias("r")).collect()
    assert got["cuda"].equals(got["cpu"])
    assert got["cpu"].column("r").to_pylist() == [
        _spark_substring(w, pos, ln) for w in words * 50]


def _spark_substring(s: str, pos: int, ln: int) -> str:
    """Spark's substring: 1-based, 0 as 1, negative from the end; a start
    before the beginning shortens the result."""
    if ln <= 0:
        return ""
    start = pos - 1 if pos > 0 else (0 if pos == 0 else len(s) + pos)
    if start < 0:
        ln, start = max(ln + start, 0), 0
    return s[start:start + ln]


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 7, 64])
def test_partition_ids_on_card_equal_cpu(cuda_device, parts):
    """``device_partition_ids`` on every key type and on all of them
    combined, seeds 42 and 9001: the card's ids equal the CPU's (the CPU's
    are held bit-equal to the JAX package's by
    tests/test_torch_partition_ids.py)."""
    from spark_rapids_tpu_torch.shuffle.manager import device_partition_ids
    planes = _planes(3, 900, 1024)
    cpu, card = _table(planes, "cpu"), _table(planes, cuda_device)
    for keys in (["s"], ["d"], ["i"], ["b"], ["s", "d", "i", "b"]):
        for seed in (42, 9001):
            assert torch.equal(
                device_partition_ids(card, keys, parts, seed).cpu(),
                device_partition_ids(cpu, keys, parts, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_grace_joins_on_card_equal_cpu(cuda_device, how, monkeypatch):
    """Every join type on a string and a float key (NaN, -0.0, nulls) with
    a build over a 16 KiB ``batchSizeBytes``: the grace join runs on both
    devices, with the same bucket counts, and the card's rows equal the
    CPU's in order, and the host engine's."""
    from harness import assert_tables_equal
    from spark_rapids_tpu_torch.exec import joins as J
    n_subs = []
    real = J.TpuShuffledHashJoinExec._grace_build_parts

    def spy(self, build, n_sub):
        n_subs.append(n_sub)
        return real(self, build, n_sub)
    monkeypatch.setattr(J.TpuShuffledHashJoinExec, "_grace_build_parts", spy)
    results, subs = [], []
    for device in ("cpu", cuda_device):
        del n_subs[:]
        sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                             "spark.rapids.tpu.batchRowsMinBucket": 64,
                             "spark.rapids.sql.batchSizeBytes": 16 * 1024,
                             "spark.rapids.tpu.aqe.enabled": False,
                             "spark.rapids.tpu.autoBroadcastJoinThreshold":
                                 -1}, device=device)
        t = {k: sess.create_dataframe(v, num_partitions=2)
             for k, v in _join_sides(9).items()}
        q = t["l"].join(t["r"], how=how, condition=(
            F.col("k") == F.col("rk")) & (F.col("k2") == F.col("rk2")))
        results.append(q.collect())
        subs.append(list(n_subs))
    assert subs[0] and subs[0] == subs[1]
    assert_tables_equal(results[1], results[0], ignore_order=False)
    assert_tables_equal(results[1], q.collect(device=False))


@pytest.mark.cuda
def test_out_of_core_sort_on_card_equals_cpu(cuda_device, monkeypatch):
    """A sort over a 64 KiB budget merges its runs on the card exactly as
    on the CPU."""
    rounds = []
    real = srt.TpuSortExec._merge_runs

    def spy(self, runs):
        rounds.append(len(runs))
        yield from real(self, runs)
    monkeypatch.setattr(srt.TpuSortExec, "_merge_runs", spy)
    li = tpch.gen_lineitem(0, seed=0, rows=20000).select(
        ["l_orderkey", "l_linenumber", "l_extendedprice", "l_shipmode"])
    results = []
    for device in ("cpu", cuda_device):
        sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 64,
                             "spark.rapids.sql.batchSizeBytes": 64 * 1024},
                            device=device)
        results.append(sess.create_dataframe(li, num_partitions=4).sort(
            F.col("l_orderkey").desc(), "l_linenumber").collect())
    assert rounds == [4, 4]
    assert results[0].equals(results[1])


@pytest.mark.cuda
@pytest.mark.parametrize("direct", [True, False])
def test_spill_round_trip_on_card(cuda_device, tmp_path, direct):
    """A card table spilled to the host and to disk comes back to the card
    plane for plane, bit for bit (its doubles hold NaN)."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    from spark_rapids_tpu_torch.memory.stores import StorageTier
    table = _table(_planes(4, 900, 1024), cuda_device)
    size = table.nbytes()
    cat = BufferCatalog(RapidsConf({
        "spark.rapids.tpu.memory.disk.direct": direct}),
        device_limit=size, host_limit=size, disk_dir=str(tmp_path),
        device=cuda_device)
    hs = [cat.register(_table(_planes(4, 900, 1024), cuda_device))
          for _ in range(3)]
    assert [h.tier for h in hs] == [StorageTier.DISK, StorageTier.HOST,
                                    StorageTier.DEVICE]
    for h in hs:
        back = h.get()
        assert back.device == table.device
        for a, b in zip(back.columns, table.columns):
            if a.data.is_floating_point():
                assert torch.equal(a.data.view(torch.int64),
                                   b.data.view(torch.int64))
            else:
                assert torch.equal(a.data, b.data)
            assert torch.equal(a.validity, b.validity)
        assert torch.equal(back.row_mask, table.row_mask)
    for h in hs:
        h.close()
    cat.assert_no_leaks()
