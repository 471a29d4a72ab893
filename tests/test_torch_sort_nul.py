"""Sorting strings with embedded NULs (ROADMAP Queue 3: a reference fault
pinned). Spark orders strings by their UTF-8 bytes, so "a" < "a\\x00" <
"a\\x00b" < "a\\x01": Python's order. The port's device sort (the zero-padded
byte matrix and the lengths) and its host engine follow it, ascending and
descending. The JAX package's host engine codes string sort keys with
``pd.factorize(sort=True)`` (spark_rapids_tpu/plan/physical.py:407), which
ties strings that differ only from an embedded NUL on: the test pins that
answer as the reference's fault, as the LIKE faults are pinned."""
import pyarrow as pa
import pytest

from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.session import TorchSession

_VALUES = ["a\x00c", "a", "b", "a\x00b", "", "\x00", "a\x00", "\x00\x00",
           "ab", "a\x00\x00", "a\x01", "é\x00", "é"]
_CONF = {"spark.rapids.tpu.batchRowsMinBucket": 8}


def _table():
    return pa.table({"s": _VALUES, "i": list(range(len(_VALUES)))})


@pytest.mark.parametrize("partitions", [1, 2])
@pytest.mark.parametrize("ascending", [True, False])
def test_port_sorts_nul_strings_in_python_order(ascending, partitions):
    want = sorted(_VALUES, reverse=not ascending)
    q = TorchSession(_CONF, device="cpu").create_dataframe(
        _table(), num_partitions=partitions).sort("s", ascending=ascending)
    assert q.collect().column("s").to_pylist() == want
    assert q.collect(device=False).column("s").to_pylist() == want


@pytest.mark.parametrize("ascending", [True, False])
def test_jax_host_engine_ties_strings_after_a_nul(ascending):
    """The reference's fault: its host engine sorts by each string cut at
    its first NUL, ties kept in input order; its device sort is right."""
    q = TpuSession(_CONF).create_dataframe(_table(), num_partitions=2) \
        .sort("s", ascending=ascending)
    assert q.collect(device=True).column("s").to_pylist() \
        == sorted(_VALUES, reverse=not ascending)
    fault = sorted(_VALUES, key=lambda v: v.split("\x00")[0],
                   reverse=not ascending)
    assert q.collect(device=False).column("s").to_pylist() == fault
    assert fault != sorted(_VALUES, reverse=not ascending)
