"""TPC-H Q12–Q22 through the PyTorch port on the CPU, its host engine and
the JAX package with AQE on (the default), at ``gen_all(0, tiny=True)`` in
2 partitions: results by tests/test_tpch_full.py's rules, device plans and
AQE events equal to the JAX package's (tests/test_torch_tpch22.py holds the
helpers and Q1–Q11)."""
import pytest

from spark_rapids_tpu_torch.tools import tpch
from test_torch_tpch22 import CONF, run_against_jax


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_all(0, tiny=True)


@pytest.mark.parametrize("name", [f"q{i}" for i in range(12, 23)])
def test_query_with_aqe_matches_jax_package_and_host_engine(tables, name):
    run_against_jax(name, tables, CONF)
