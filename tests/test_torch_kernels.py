"""The port's kernel wrappers without the JAX package, so the file also runs
on the card's machine, where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On a CPU-only machine the ``cuda`` tests skip and the wrapper tests check
the CPU path and the input checks; on the card every kernel is held against
its plain version."""
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch.expr.functions import col
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf.examples import pallas_axpy
from spark_rapids_tpu_torch.udf.kernels import axpy, axpy_reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


def _abc(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(3)]


def _frame():
    # tests/test_udf_examples.py::test_pallas_axpy's data
    rng = np.random.default_rng(2)
    return pd.DataFrame({
        "a": rng.normal(size=64).astype(np.float32),
        "x": rng.normal(size=64).astype(np.float32),
        "y": rng.normal(size=64).astype(np.float32),
    })


def test_axpy_wrapper_on_cpu_is_the_plain_version():
    a, x, y = map(torch.from_numpy, _abc(100, 1))
    launches = axpy.launches
    np.testing.assert_array_equal(axpy(a, x, y).numpy(),
                                  axpy_reference(a, x, y).numpy())
    assert axpy.launches == launches  # no kernel on the CPU
    assert axpy(*(t[:0] for t in (a, x, y))).shape == (0,)


@pytest.mark.parametrize("bad", ["float64", "2-D", "strided", "shape"])
def test_axpy_wrapper_rejects_bad_inputs(bad):
    a, x, y = map(torch.from_numpy, _abc(64, 2))
    if bad == "float64":
        a = a.double()
    elif bad == "2-D":
        a = a.reshape(8, 8)
    elif bad == "strided":
        a = torch.from_numpy(_abc(128, 3)[0])[::2]
    else:
        y = y[:32]
    with pytest.raises((TypeError, ValueError)):
        axpy(a, x, y)


def test_session_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000003, 1 << 20])
def test_axpy_kernel_matches_plain_version_on_card(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    a, x, y = (torch.randn(n, generator=gen, device=cuda_device)
               for _ in range(3))
    launches = axpy.launches
    got = axpy(a, x, y)
    torch.cuda.synchronize()
    assert axpy.launches == launches + 1
    assert torch.equal(got, axpy_reference(a, x, y))


@pytest.mark.cuda
def test_pallas_axpy_query_launches_the_kernel_on_card(cuda_device):
    pdf = _frame()
    sess = TorchSession({"spark.rapids.tpu.batchRowsMinBucket": 8})
    q = sess.create_dataframe(pdf, num_partitions=2).select(
        pallas_axpy(col("a"), col("x"), col("y")).alias("r"))
    axpy.launches = 0
    dev = q.collect()
    assert axpy.launches == 2  # one per input batch
    assert dev.equals(q.collect(device=False))
