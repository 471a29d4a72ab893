"""The port's device batch layout against the JAX package's: host -> device
-> host round trips, the stable partition order and compaction on the same
masks, and a JAX device batch carried across into the port's Q6 whole-stage
chain (plane by plane)."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import device as jdev
from spark_rapids_tpu.columnar.host import HostTable as JHostTable

from spark_rapids_tpu_torch.columnar import device as tdev
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.columnar.interop import device_table_from_numpy

_KINDS = {
    "int32": lambda r, n: pa.array(r.integers(-2**31, 2**31, n, dtype=np.int64)
                                   .astype(np.int32)),
    "int64": lambda r, n: pa.array(r.integers(-2**62, 2**62, n)),
    "float32": lambda r, n: pa.array(r.normal(0, 100, n).astype(np.float32)),
    "float64": lambda r, n: pa.array(np.where(r.random(n) < 0.1, np.nan,
                                              r.normal(0, 100, n))),
    "bool": lambda r, n: pa.array(r.random(n) < 0.5),
    "date32": lambda r, n: pa.array(r.integers(0, 20000, n).astype(np.int32),
                                    type=pa.int32()).cast(pa.date32()),
}


def _with_nulls(rng, arr: pa.Array, prob: float) -> pa.Array:
    mask = rng.random(len(arr)) < prob
    return pa.array(arr.to_pylist(), type=arr.type, mask=mask)


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("n,min_bucket", [(0, 8), (1, 8), (77, 8),
                                          (1000, 1024)])
def test_round_trip_host_device_host(kind, n, min_bucket):
    rng = np.random.default_rng(7)
    table = pa.table({"v": _with_nulls(rng, _KINDS[kind](rng, n), 0.2),
                      "w": _KINDS[kind](rng, n)})
    ht = HostTable.from_arrow(table)
    dtb = tdev.DeviceTable.from_host(ht, min_bucket, "cpu")
    assert dtb.capacity == jdev.bucket_rows(max(n, 1), min_bucket)
    assert dtb.num_rows.dtype == torch.int32 and int(dtb.num_rows) == n
    assert dtb.column("w").all_valid
    back = dtb.to_host().to_arrow()
    assert back.schema == table.schema
    for name in table.column_names:
        got, want = back.column(name), table.column(name)
        np.testing.assert_array_equal(got.is_valid().to_numpy(),
                                      want.is_valid().to_numpy())
        live = want.is_valid()
        # assert_array_equal counts NaN equal to NaN
        np.testing.assert_array_equal(
            got.filter(live).to_numpy(zero_copy_only=False),
            want.filter(live).to_numpy(zero_copy_only=False))


@pytest.mark.parametrize("n,p", [(1, 0.5), (64, 0.0), (64, 1.0), (1000, 0.3),
                                 (4096, 0.9)])
def test_stable_partition_order_matches_jax(n, p):
    mask = np.random.default_rng(n).random(n) < p
    got = tdev.stable_partition_order(torch.from_numpy(mask))
    want = np.asarray(jdev.stable_partition_order(jnp.asarray(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(~mask, kind="stable"))


@pytest.mark.parametrize("keep_prob", [0.0, 0.4, 1.0])
def test_compaction_matches_jax(keep_prob):
    rng = np.random.default_rng(3)
    n = 300
    table = pa.table({"a": _with_nulls(rng, _KINDS["float64"](rng, n), 0.1),
                      "b": _KINDS["int64"](rng, n)})
    keep = rng.random(n) < keep_prob
    j = jdev.DeviceTable.from_host(JHostTable.from_arrow(table), 8)
    j = j.filter_mask(jnp.asarray(np.pad(keep, (0, j.capacity - n)))) \
        .compact()
    t = tdev.DeviceTable.from_host(HostTable.from_arrow(table), 8, "cpu")
    t = t.filter_mask(torch.from_numpy(np.pad(keep, (0, t.capacity - n)))) \
        .compact()
    assert int(t.num_rows) == int(j.num_rows) == keep.sum()
    np.testing.assert_array_equal(t.row_mask.numpy(), np.asarray(j.row_mask))
    for tc, jc in zip(t.columns, j.columns):
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
        live = tc.validity.numpy()
        np.testing.assert_array_equal(tc.data.numpy()[live],
                                      np.asarray(jc.data)[live])


def _port_q6_stage(rows: int):
    from spark_rapids_tpu_torch.exec.wholestage import TpuWholeStageExec
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 1024},
                        device="cpu")
    df = sess.create_dataframe(tpch.gen_lineitem(0, seed=0, rows=rows))
    plan = sess._physical(tpch.q6({"lineitem": df}).logical, device=True)
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TpuWholeStageExec):
            return node
        stack.extend(node.children)
    raise AssertionError("no whole-stage node in the port's Q6 plan")


def test_jax_batch_through_port_q6_stage():
    from __graft_entry__ import entry
    forward, (example,) = entry()
    want = forward(example)
    batch = device_table_from_numpy(
        example.names,
        [{"data": np.asarray(c.data), "validity": np.asarray(c.validity),
          "dtype": repr(c.dtype), "all_valid": c.all_valid}
         for c in example.columns],
        np.asarray(example.row_mask), np.asarray(example.num_rows), "cpu")
    assert batch.capacity == example.capacity
    stage = _port_q6_stage(rows=4096)
    assert stage.node_name() == "TpuWholeStage[Filter+Project+HashAggregate]"
    got = stage.batch_fn()(batch)
    assert got.names == tuple(want.names)
    assert int(got.num_rows) == int(want.num_rows)
    np.testing.assert_array_equal(got.row_mask.numpy(),
                                  np.asarray(want.row_mask))
    for gc, wc in zip(got.columns, want.columns):
        assert gc.dtype.simple_name == wc.dtype.simple_name
        np.testing.assert_array_equal(gc.validity.numpy(),
                                      np.asarray(wc.validity))
        np.testing.assert_allclose(gc.data.numpy(), np.asarray(wc.data),
                                   rtol=1e-12)


def _strings(rng, n: int, max_len: int):
    """Strings of 0..max_len characters, some multi-byte UTF-8, with nulls."""
    alphabet = list("abcXYZ 0\x00") + ["ü", "ï", "日", "€"]
    vals = ["".join(rng.choice(alphabet, rng.integers(0, max_len + 1)))
            for _ in range(n)]
    return _with_nulls(rng, pa.array(vals, type=pa.string()), 0.2)


@pytest.mark.parametrize("max_len", [1, 7, 8, 9, 16, 40])
@pytest.mark.parametrize("n,min_bucket", [(0, 8), (1, 8), (300, 8),
                                          (1000, 1024)])
def test_string_round_trip_and_planes_match_jax(max_len, n, min_bucket):
    rng = np.random.default_rng(max_len * 1000 + n)
    arr = _strings(rng, n, max_len)
    # "t": every value empty; "u": every value of one length (the
    # upload's fast path), sliced so the Arrow array has an offset
    fixed = pa.array(["ab\x00ü"] * (n + 3), type=pa.string()).slice(3)
    table = pa.table({"s": arr, "t": pa.array([""] * n, type=pa.string()),
                      "u": fixed})
    t = tdev.DeviceTable.from_host(HostTable.from_arrow(table), min_bucket,
                                   "cpu")
    j = jdev.DeviceTable.from_host(JHostTable.from_arrow(table), min_bucket)
    for tc, jc in zip(t.columns, j.columns):
        assert tc.data.dtype == torch.uint8 and tc.data.dim() == 2
        assert tc.lengths.dtype == torch.int32
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
    back = t.to_host().to_arrow()
    assert back.column("s").to_pylist() == arr.to_pylist()
    assert back.column("t").to_pylist() == [""] * n
    assert back.column("u").to_pylist() == ["ab\x00ü"] * n


def test_concat_of_string_batches_of_different_widths_matches_jax():
    rng = np.random.default_rng(9)
    arrs = [_strings(rng, 50, w) for w in (3, 40, 12)]
    parts, jparts = [], []
    for k, arr in enumerate(arrs):
        table = pa.table({"s": arr, "k": pa.array(np.arange(50) + 100 * k)})
        keep = rng.random(64) < 0.7
        t = tdev.DeviceTable.from_host(HostTable.from_arrow(table), 64,
                                       "cpu")
        parts.append(t.filter_mask(torch.from_numpy(keep)))
        j = jdev.DeviceTable.from_host(JHostTable.from_arrow(table), 64)
        jparts.append(j.filter_mask(jnp.asarray(keep)))
    assert len({p.column("s").data.shape[1] for p in parts}) == 3
    got = tdev.concat_device_tables(parts, 64)
    want = jdev.concat_device_tables(jparts, 64)
    assert got.column("s").data.shape == tuple(want.column("s").data.shape)
    assert int(got.num_rows) == int(want.num_rows)
    np.testing.assert_array_equal(got.row_mask.numpy(),
                                  np.asarray(want.row_mask))
    live = got.row_mask.numpy()
    for name in ("s", "k"):
        gc, wc = got.column(name), want.column(name)
        np.testing.assert_array_equal(gc.data.numpy()[live],
                                      np.asarray(wc.data)[live])
        np.testing.assert_array_equal(gc.validity.numpy(),
                                      np.asarray(wc.validity))
    np.testing.assert_array_equal(got.column("s").lengths.numpy()[live],
                                  np.asarray(want.column("s").lengths)[live])
    expect = [v for arr, p in zip(arrs, parts)
              for v, m in zip(arr.to_pylist(), p.row_mask.numpy()) if m]
    assert got.to_host().to_arrow().column("s").to_pylist() == expect
    # shrinking keeps the byte matrix's width and the lengths plane
    small = tdev.shrink_to_fit(got, 8)
    assert small.capacity < got.capacity
    assert small.to_host().to_arrow().column("s").to_pylist() == expect
