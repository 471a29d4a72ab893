"""TPC-H Q20 on a non-empty result (ROADMAP Queue 3's repaired fault: no
test compared Q20 on rows). The generators draw lineitem's (l_partkey,
l_suppkey) independently of partsupp's pairs, so Q20's nested semi joins
find no supplier; here lineitem is rebuilt inside the test with its pairs
drawn from partsupp, the generators left byte-equal to the JAX ones. Q20
then runs through the port's device path, its host engine and the JAX
package, with AQE on and off: equal rows, plans and AQE events."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.tools import tpch

from test_torch_tpch22 import CONF, run_against_jax, run_port


def q20_tables(sf: float, seed: int = 20) -> dict:
    """Q20's tables at ``sf`` with lineitem's (part, supplier) pairs drawn
    uniformly from partsupp's."""
    t = {"part": tpch.gen_part(sf, seed=3),
         "partsupp": tpch.gen_partsupp(sf, seed=5),
         "supplier": tpch.gen_supplier(sf, seed=4),
         "nation": tpch.gen_nation(),
         "lineitem": tpch.gen_lineitem(sf, seed=0)}
    ps, li = t["partsupp"], t["lineitem"]
    pick = np.random.default_rng(seed).integers(0, ps.num_rows, li.num_rows)
    for c, pc in (("l_partkey", "ps_partkey"), ("l_suppkey", "ps_suppkey")):
        li = li.set_column(li.schema.get_field_index(c), c,
                           pa.array(ps.column(pc).to_numpy()[pick]))
    t["lineitem"] = li
    return t


@pytest.fixture(scope="module")
def tables():
    return q20_tables(0.01)


@pytest.mark.parametrize("aqe", [True, False])
def test_q20_returns_rows_equal_to_jax_and_host_engine(tables, aqe):
    conf = dict(CONF, **{"spark.rapids.tpu.aqe.enabled": aqe})
    run_against_jax("q20", tables, conf)
    out, _, host = run_port("q20", tables, conf)
    assert out.num_rows >= 1
    assert out.equals(host)


def test_generated_pairs_alone_give_q20_no_row(tables):
    """Why the rebuild: with the generator's own lineitem the result is
    empty at this scale."""
    t = dict(tables, lineitem=tpch.gen_lineitem(0.01, seed=0))
    out, _, host = run_port("q20", t, CONF)
    assert out.num_rows == host.num_rows == 0
