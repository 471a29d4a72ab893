"""All 22 TPC-H queries through the PyTorch port on the CPU with AQE off
(every exchange planned up front), at ``gen_all(0, tiny=True)`` in 2
partitions. The queries outside tests/test_tpch_full.py's ``_HEAVY`` set
are held against the JAX package (results, device plans) and the port's
host engine; the heavy ones, whose JAX compiles dominate the time, against
the port's host engine, with the plan all device nodes above the scans
(tests/test_torch_tpch22.py holds the helpers; the AQE-on runs hold every
query against the JAX package)."""
import pytest

from spark_rapids_tpu_torch.tools import tpch
from test_torch_tpch22 import (CONF, HEAVY, compare, run_against_jax,
                               run_port)

_OFF = {**CONF, "spark.rapids.tpu.aqe.enabled": False}


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_all(0, tiny=True)


@pytest.mark.parametrize("name", [f"q{i}" for i in range(1, 23)
                                  if f"q{i}" not in HEAVY])
def test_query_without_aqe_matches_jax_package_and_host_engine(tables,
                                                               name):
    run_against_jax(name, tables, _OFF)


@pytest.mark.parametrize("name", sorted(HEAVY, key=lambda q: int(q[1:])))
def test_heavy_query_without_aqe_matches_host_engine(tables, name):
    out, plan, host = run_port(name, tables, _OFF)
    assert out.schema == host.schema
    compare(name, out, host)
    text = plan.tree_string()
    assert "AdaptiveExec" not in text
    assert "Cpu" not in text.replace("CpuScanExec", "")
