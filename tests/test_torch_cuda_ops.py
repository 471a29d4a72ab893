"""The keyed aggregate's and the sort's torch ops on the card against the
same functions on the CPU, without the JAX package, so the file runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ops.py

The CPU side is held against the JAX package by tests/test_torch_groupby.py;
here every test needs the card and skips without one. Grouping planes,
sort permutations, hashes and key words must be equal exactly; float64
group sums at rel 1e-12, since ``index_add_`` on the card adds in no fixed
order."""
import numpy as np
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

_WORDS = ["", "a", "ab", "ab\x00", "Spark", "ünïcode", "longer string value",
          "日本語", "zz"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (run on the card)")
    return torch.device("cuda")


def _planes(seed: int, n: int, cap: int):
    """Column planes with nulls, NaN, -0.0, +-inf, extreme ints and strings
    of mixed widths; rows past ``n`` hold stale values."""
    rng = np.random.default_rng(seed)
    raw = [_WORDS[i].encode() for i in rng.integers(0, len(_WORDS), cap)]
    mat = np.zeros((cap, 32), np.uint8)
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
