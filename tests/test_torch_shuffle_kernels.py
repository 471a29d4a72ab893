"""The shuffle kernels' wrappers (``partition_ids``, ``counting_order``) and
the launch helper every kernel wrapper goes through, without the JAX
package, so the file also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_shuffle_kernels.py

On the CPU the wrappers compute their plain versions; the ``cuda`` tests
hold the kernels against those bit for bit, and check that a wrapper
launches on its input's device and that device's current stream (a launch
elsewhere fails the capture of a CUDA graph on a side stream)."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.device import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.shuffle.manager import (
    counting_order, counting_order_reference, device_partition_ids,
    partition_ids, partition_order)

_PKG = pathlib.Path(__file__).resolve().parent.parent \
    / "spark_rapids_tpu_torch"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


def _table(n: int, seed: int, device="cpu"):
    """An int64, a width-16 string, a DECIMAL(25,2) limb pair and a float64
    key with signed zeros and NaN payloads, about 5 % nulls each, and a row
    mask."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lengths = rng.integers(0, 17, n).astype(np.int32)
    mat = rng.integers(97, 123, (n, 16)).astype(np.uint8)
    mat[np.arange(16)[None, :] >= lengths[:, None]] = 0
    f = rng.normal(size=n)
    pick = rng.integers(0, 6, n)
    f[pick == 0] = 0.0
    f[pick == 1] = -0.0
    f.view(np.uint64)[pick == 2] = 0xFFF8000000000001
    f.view(np.uint64)[pick == 3] = 0x7FF8000000000000
    cols = (
        DeviceColumn(t(rng.integers(-2**40, 2**40, n)),
                     t(rng.uniform(size=n) > .05), dt.LONG),
        DeviceColumn(t(mat), t(rng.uniform(size=n) > .05), dt.STRING,
                     lengths=t(lengths)),
        DeviceColumn(t(np.stack([rng.integers(-2**20, 2**20, n),
                                 rng.integers(-2**62, 2**62, n)], 1)),
                     t(rng.uniform(size=n) > .05), dt.DecimalType(25, 2)),
        DeviceColumn(t(f), t(rng.uniform(size=n) > .05), dt.DOUBLE),
        DeviceColumn(t(rng.integers(-100, 100, n).astype(np.int32)),
                     t(rng.uniform(size=n) > .05), dt.INT))
    mask = t(rng.uniform(size=n) > .1)
    return DeviceTable(cols, mask, mask.sum(dtype=torch.int32),
                       ("i", "s", "d", "f", "j"))


_KEY_SETS = [["i"], ["i", "s"], ["d"], ["f"], ["j", "s", "d", "i"]]


@pytest.mark.parametrize("keys", _KEY_SETS, ids="+".join)
def test_partition_ids_cpu_is_the_plain_version(keys):
    t = _table(3000, 1)
    for p in (1, 4, 7, 256):
        for norm in (False, True):
            want = device_partition_ids(t, keys, p, normalize_floats=norm)
            assert torch.equal(partition_ids(t, keys, p,
                                             normalize_floats=norm), want)
            assert torch.equal(
                partition_ids(t, keys, p, normalize_floats=norm,
                              row_mask=t.row_mask),
                torch.where(t.row_mask, want, p))
            assert int(want.min()) >= 0 and int(want.max()) < p


def test_normalised_float_hash_meets_zeros_and_nans():
    """-0.0 hashes as 0.0 and every NaN alike when normalised; as bits
    (the JAX package's hash) they part."""
    v = torch.tensor([0.0, -0.0, float("nan"), 1.0], dtype=torch.float64)
    v.view(torch.int64)[2] = -(2**63) + 0x7FF8000000000001  # a NaN payload
    v2 = torch.tensor([0.0, 0.0, float("nan"), 1.0], dtype=torch.float64)
    t = DeviceTable((DeviceColumn(v, torch.ones(4, dtype=torch.bool),
                                  dt.DOUBLE),), torch.ones(4, dtype=bool),
                    torch.tensor(4, dtype=torch.int32), ("f",))
    t2 = DeviceTable((DeviceColumn(v2, torch.ones(4, dtype=torch.bool),
                                   dt.DOUBLE),), t.row_mask, t.num_rows,
                     ("f",))
    a = partition_ids(t, ["f"], 1 << 30, normalize_floats=True)
    b = partition_ids(t2, ["f"], 1 << 30, normalize_floats=True)
    assert torch.equal(a, b)
    raw = partition_ids(t, ["f"], 1 << 30)
    assert raw[0] != raw[1] and raw[2] != b[2]


@pytest.mark.parametrize("n,p", [(0, 3), (1, 1), (999, 4), (5000, 31),
                                 (5000, 33), (20000, 256), (300, 8191)])
def test_counting_order_plain_is_argsort_and_bincount(n, p):
    rng = np.random.default_rng(n + p)
    ids = torch.from_numpy(rng.integers(0, p, n).astype(np.int32))
    order, counts = counting_order(ids, p)
    assert order.dtype == torch.int32 and counts.dtype == torch.int32
    assert torch.equal(order.long(), torch.argsort(ids, stable=True))
    assert torch.equal(counts.long(), torch.bincount(ids.long(),
                                                     minlength=p))
    o2, c2 = partition_order(ids, p - 1) if p > 1 else (order, counts)
    assert torch.equal(o2, order) and torch.equal(c2, counts)


def test_counting_order_checks_its_inputs():
    with pytest.raises(TypeError):
        counting_order(torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        counting_order(torch.zeros(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        counting_order(torch.zeros(4, dtype=torch.int32), 8193)


def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def test_every_kernel_launch_goes_through_the_device_guarded_helper():
    """A wrapper that launched outside ``native.launch`` (or read the
    current stream without naming its device) would launch a shard's
    kernel on the calling thread's device: each ``srt_*`` kernel of the
    library is reached only as a string given to ``launch``, and every
    ``torch.cuda.current_stream`` call names its device."""
    from spark_rapids_tpu_torch import native
    kernels = set()
    for src in sorted(_PKG.rglob("*.py")):
        tree = ast.parse(src.read_text(encoding="utf-8"))
        for call in _calls(tree):
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "current_stream":
                assert call.args, (f"{src.name}:{call.lineno}: "
                                   "current_stream() names no device")
            name = f.id if isinstance(f, ast.Name) else \
                f.attr if isinstance(f, ast.Attribute) else None
            if name in ("launch", "_launch") and len(call.args) >= 3 \
                    and isinstance(call.args[1], ast.Constant):
                kernels.add(call.args[1].value)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith(
                    "srt_") and src.name != "native.py":
                # host functions of the library: scratch sizes and the
                # BYTE_ARRAY walk, which launch nothing
                assert node.attr.endswith(("_scratch", "_scratch_bytes",
                                           "_small_cap", "ba_walk")), \
                    f"{src.name}:{node.lineno}: {node.attr} called directly"
    launched = {"srt_axpy_f32", "srt_nfa_match", "srt_pq_expand_hybrid",
                "srt_pq_gather_fixed", "srt_pq_gather_byte_array",
                "srt_d128_mul_rescaled", "srt_d128_rescale",
                "srt_d128_segment_sum", "srt_seg_scan", "srt_frame_bounds",
                "srt_frame_reduce", "srt_partition_ids",
                "srt_counting_order"}
    assert launched <= kernels, launched - kernels
    # window_kernels' ``_launch`` hands its kernel on to ``launch``
    assert "launch(fn, kernel, device, *args)" in (
        _PKG / "exec" / "window_kernels.py").read_text(encoding="utf-8")
    assert "torch.cuda.device(device)" in (
        _PKG / "native.py").read_text(encoding="utf-8")
    assert native.launch.__doc__


@pytest.mark.cuda
@pytest.mark.parametrize("keys", _KEY_SETS, ids="+".join)
def test_partition_ids_kernel_equals_plain(cuda_device, keys):
    for n in (1, 1000, 70001):
        t = _table(n, n, cuda_device)
        for p in (1, 4, 256):
            for norm in (False, True):
                want = device_partition_ids(t, keys, p, normalize_floats=norm)
                got = partition_ids(t, keys, p, normalize_floats=norm,
                                    row_mask=t.row_mask)
                torch.cuda.synchronize()
                assert torch.equal(got, torch.where(t.row_mask, want, p))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 2047, 2048, 2049, 100003,
                               (1 << 23) + 5])
def test_counting_order_kernel_equals_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    for p in (1, 5, 65, 257, 8192):
        if n > (1 << 20) and p > 257:
            continue
        ids = torch.from_numpy(rng.integers(0, p, n).astype(
            np.int32)).to(cuda_device)
        order, counts = counting_order(ids, p)
        r_order, r_counts = counting_order_reference(ids, p)
        torch.cuda.synchronize()
        assert torch.equal(order, r_order), (n, p)
        assert torch.equal(counts, r_counts), (n, p)
        assert torch.equal(order.long(), torch.argsort(ids, stable=True))


@pytest.mark.cuda
def test_wrappers_launch_on_the_current_stream(cuda_device):
    """Captured in a CUDA graph on a side stream, a launch on any other
    stream would fail the capture; the replay must give the plain result."""
    from spark_rapids_tpu_torch.expr.decimal128 import (d128_rescale,
                                                        d128_rescale_reference)
    from spark_rapids_tpu_torch.exec.window_kernels import (
        seg_scan, seg_scan_reference)
    from spark_rapids_tpu_torch.udf.kernels import axpy, axpy_reference
    t = _table(5000, 3, cuda_device)
    ids = torch.randint(0, 9, (5000,), dtype=torch.int32,
                        device=cuda_device)
    a, x, y = (torch.randn(5000, device=cuda_device) for _ in range(3))
    limbs = t.column("d").data.contiguous()
    vals = torch.randint(-9, 9, (5000,), dtype=torch.int64,
                         device=cuda_device)
    flags = torch.rand(5000, device=cuda_device) < 0.01
    runs = {
        "partition_ids": (lambda: partition_ids(t, ["i", "s"], 8),
                          lambda: device_partition_ids(t, ["i", "s"], 8)),
        "counting_order": (lambda: counting_order(ids, 9)[0],
                           lambda: counting_order_reference(ids, 9)[0]),
        "axpy": (lambda: axpy(a, x, y), lambda: axpy_reference(a, x, y)),
        "d128_rescale": (lambda: d128_rescale(limbs, 2, 4, 38)[0],
                         lambda: d128_rescale_reference(limbs, 2, 4, 38)[0]),
        "seg_scan": (lambda: seg_scan(vals, flags, "add"),
                     lambda: seg_scan_reference(vals, flags, "add")),
    }
    for name, (fn, plain) in runs.items():
        fn()  # load the library and warm up outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, plain()), name


@pytest.mark.cuda
def test_wrappers_launch_on_the_input_device(cuda_device):
    """With two cards, an input on ``cuda:1`` launches there while the
    calling thread's device is ``cuda:0``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    t = _table(4000, 4, dev)
    ids = torch.randint(0, 9, (4000,), dtype=torch.int32, device=dev)
    with torch.cuda.device(0):
        got = partition_ids(t, ["i", "s", "d"], 4)
        order, _ = counting_order(ids, 9)
    torch.cuda.synchronize(dev)
    assert got.device == dev and order.device == dev
    assert torch.equal(got, device_partition_ids(t, ["i", "s", "d"], 4))
    assert torch.equal(order.long(), torch.argsort(ids, stable=True))
