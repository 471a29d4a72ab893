"""The OOM ladder on the card: a real caching-allocator OOM is classified as
retryable (and as ``oom`` by the fallback boundary), and the ladder
recovers a batch that does not fit by splitting it, with the record naming
``torch.OutOfMemoryError`` as its cause. A stage that launches a
hand-written kernel re-raises ``action=fatal`` instead of falling back. These tests need an NVIDIA card
(marked ``cuda``; they skip here) and import no JAX, so the card runs them
with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_oom_cuda.py``."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar.device import DeviceTable
from spark_rapids_tpu_torch.columnar.host import HostTable
from spark_rapids_tpu_torch.exec.fallback import classify_failure
from spark_rapids_tpu_torch.memory import retry


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the caching allocator's "
                    "OOM; run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_real_allocator_oom_is_classified(cuda_device):
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(4 * total, dtype=torch.uint8, device=cuda_device)
    assert retry.is_retryable_oom(ei.value)
    assert classify_failure(ei.value) == "oom"
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_ladder_recovers_a_split_on_the_card(cuda_device):
    """A batch whose temporary needs 512 MiB under a 400 MiB cap: the full
    batch raises the allocator's OOM, each half fits, and the split's
    concat equals the answer computed on the CPU."""
    n = 1 << 22
    t = pa.table({"a": np.arange(n, dtype=np.int64)})
    table = DeviceTable.from_host(HostTable.from_arrow(t), 1024, cuda_device)

    def fn(b: DeviceTable) -> DeviceTable:
        scratch = torch.empty(b.capacity * 128, dtype=torch.uint8,
                              device=b.device)
        scratch.zero_()
        col = b.columns[0]
        out = col.data * 2 + scratch[:1].to(torch.int64)
        return DeviceTable((type(col)(out, col.validity, col.dtype,
                                      col.all_valid),),
                           b.row_mask, b.num_rows, b.names)

    retry.reset_retry_state()
    index = torch.cuda.current_device()  # the fraction wants an index
    total = torch.cuda.get_device_properties(index).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(index)
    torch.cuda.set_per_process_memory_fraction(
        (base + (400 << 20)) / total, index)
    try:
        out = retry.with_retry_split(fn, table,
                                     splitter=retry.split_device_rows,
                                     scope="card-split")
        got = out.to_host().to_arrow()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, index)
        torch.cuda.empty_cache()
    assert got.column("a").to_numpy().tolist() \
        == (np.arange(n, dtype=np.int64) * 2).tolist()
    s = retry.retry_stats()
    assert s["oom_splits"] >= 1
    (rec,) = retry.drain_oom_retry_records()
    assert rec["cause"] == "OutOfMemoryError"
    assert rec["outcome"] == "recovered" and rec["splits"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q1_decimal", "like_filter"])
def test_a_kernel_bearing_stage_re_raises_on_the_card(cuda_device, query):
    """Q1 decimal (the d128 kernels) and a LIKE filter (``nfa_match``)
    under ``alloc.jit:times=1:action=fatal``: the failure re-raises, no
    batch runs on the host and nothing is quarantined; the clean run
    launched the kernels."""
    from spark_rapids_tpu_torch.exec import fallback
    from spark_rapids_tpu_torch.expr import decimal128
    from spark_rapids_tpu_torch.expr.functions import col
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    from spark_rapids_tpu_torch.udf import kernels
    from spark_rapids_tpu_torch.utils import faults

    def build(sess):
        if query == "q1_decimal":
            li = tpch.decimal_lineitem(tpch.gen_lineitem(0, rows=20000))
            return tpch.q1_decimal({"lineitem": sess.create_dataframe(
                li, num_partitions=2)})
        part = sess.create_dataframe(tpch.gen_part(0.01, seed=3),
                                     num_partitions=2)
        return part.filter(col("p_name").like("%green%l%")).select(
            "p_partkey")
    fallback.reset_fallback_state()
    counter = decimal128.d128_mul_rescaled if query == "q1_decimal" \
        else kernels.nfa_match
    before = counter.launches
    assert build(TorchSession({}, device="cuda")).collect().num_rows
    assert counter.launches > before
    sess = TorchSession({"spark.rapids.tpu.faults.enabled": True,
                         "spark.rapids.tpu.faults.spec":
                             "alloc.jit:times=1:action=fatal"},
                        device="cuda")
    try:
        with pytest.raises(retry.InjectedDeviceFailure):
            build(sess).collect()
    finally:
        faults.reset_faults()
        TorchSession({}, device="cuda")
    s = fallback.fallback_stats()
    assert s["host_fallbacks"] == 0 and s["quarantine_notes"] == 0
