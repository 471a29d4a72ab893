"""Signed zeros and subnormals in the port against the JAX package, compared
by float bits: ``tests/harness.py assert_tables_equal`` holds 0.0 and -0.0
equal, and 5e-324 close to 0.0, so it sees neither difference.

- min and max order -0.0 below 0.0 on the port's device path and its host
  engine, as the JAX package does: a group of {0.0, -0.0} has min -0.0 and
  max 0.0 (grouped and not, one partition and two, so the final merge
  meets both zeros too).
- The JAX package flushes subnormals to zero on the CPU in its grouping,
  ``<=>`` and ``>``; the port keeps them (Spark's answer): 10 groups where
  the JAX package finds 9, and ``5e-324 <=> 0.0`` false, ``5e-324 > 0.0``
  true. Those are the reference's faults, pinned here."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.expr import functions as JF
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_NAN = float("nan")
_TINY = 5e-324
#: group -> values; the min and max each group must give
_GROUPS = {
    0: [0.0, -0.0],              # both zeros: min -0.0, max 0.0
    1: [-0.0, -0.0],             # only -0.0: both -0.0
    2: [-0.0, _NAN],             # min -0.0, max NaN
    3: [-0.0, 0.0, -0.0],        # the other order
    4: [0.0, 0.0],               # only 0.0: both 0.0
    5: [-0.0, 3.5],
    6: [0.0, -2.5],
}
_WANT = {0: (-0.0, 0.0), 1: (-0.0, -0.0), 2: (-0.0, _NAN),
         3: (-0.0, 0.0), 4: (0.0, 0.0), 5: (-0.0, 3.5), 6: (-2.5, 0.0)}


def _zeros_table() -> pa.Table:
    keys = [k for k, vs in _GROUPS.items() for _ in vs]
    vals = [v for vs in _GROUPS.values() for v in vs]
    return pa.table({"k": np.array(keys, np.int64),
                     "f": np.array(vals, np.float64)})


def _bits(values) -> list:
    """Each float as its int64 bit pattern (every NaN as one pattern)."""
    a = np.array(values, np.float64)
    a[np.isnan(a)] = _NAN
    return a.view(np.int64).tolist()


def _engines(table: pa.Table, build, parts: int) -> dict:
    sess = TorchSession({}, device="cpu")
    q = build(F, sess.create_dataframe(table, num_partitions=parts))
    jq = build(JF, TpuSession({}).create_dataframe(table,
                                                   num_partitions=parts))
    return {"port device": q.collect(), "port host": q.collect(device=False),
            "jax": jq.collect(device=True)}


@pytest.mark.parametrize("parts", [1, 2])
def test_grouped_min_max_order_negative_zero_first(parts):
    def build(f, df):
        return df.group_by("k").agg(f.min(f.col("f")).alias("mn"),
                                    f.max(f.col("f")).alias("mx"))
    for engine, out in _engines(_zeros_table(), build, parts).items():
        got = sorted(zip(out.column("k").to_pylist(),
                         _bits(out.column("mn").to_pylist()),
                         _bits(out.column("mx").to_pylist())))
        want = [(k, *_bits(v)) for k, v in sorted(_WANT.items())]
        assert got == want, engine


@pytest.mark.parametrize("values,want", [
    ([0.0, -0.0], (-0.0, 0.0)),
    ([-0.0, 0.0, 0.0], (-0.0, 0.0)),
    ([-0.0, -0.0], (-0.0, -0.0)),
    ([-0.0, _NAN], (-0.0, _NAN)),
])
@pytest.mark.parametrize("parts", [1, 2])
def test_grand_min_max_order_negative_zero_first(values, want, parts):
    table = pa.table({"f": np.array(values, np.float64)})

    def build(f, df):
        return df.agg(f.min(f.col("f")).alias("mn"),
                      f.max(f.col("f")).alias("mx"))
    for engine, out in _engines(table, build, parts).items():
        got = _bits([out.column("mn")[0].as_py(), out.column("mx")[0].as_py()])
        assert got == _bits(want), engine


def test_float32_min_max_order_negative_zero_first():
    table = pa.table({"k": np.array([0, 0, 1, 1], np.int64),
                      "f": np.array([0.0, -0.0, 0.0, 0.0], np.float32)})

    def build(f, df):
        return df.group_by("k").agg(f.min(f.col("f")).alias("mn"),
                                    f.max(f.col("f")).alias("mx"))
    for engine, out in _engines(table, build, 2).items():
        rows = sorted(zip(out.column("k").to_pylist(),
                          out.column("mn").to_pylist(),
                          out.column("mx").to_pylist()))
        signs = [(k, bool(np.signbit(a)), bool(np.signbit(b)))
                 for k, a, b in rows]
        assert signs == [(0, True, False), (1, False, False)], engine


# ---------------------------------------------------------------------------
# subnormals: the port keeps them, the JAX package flushes them on the CPU
# ---------------------------------------------------------------------------
#: ten Spark groups: 0.0 and -0.0 are one, 5e-324 is its own, NaN one
_SUBNORMAL_VALUES = [0.0, -0.0, _TINY, _NAN, 1.0, -1.0, 2.5, -7.0,
                     float("inf"), float("-inf"), 3.0]


def test_group_by_keeps_subnormals_where_jax_flushes_them():
    table = pa.table({"f": np.array(_SUBNORMAL_VALUES * 2, np.float64),
                      "x": np.arange(2 * len(_SUBNORMAL_VALUES))})

    def build(f, df):
        return df.group_by("f").agg(f.count(f.col("x")).alias("n"))
    outs = _engines(table, build, 2)
    for engine in ("port device", "port host"):
        out = outs[engine]
        assert out.num_rows == 10, engine
        tiny = [n for v, n in zip(out.column("f").to_pylist(),
                                  out.column("n").to_pylist())
                if v == _TINY]
        assert tiny == [2], engine
    # the reference's fault: 5e-324 joins the zeros' group
    assert outs["jax"].num_rows == 9
    zeros = [n for v, n in zip(outs["jax"].column("f").to_pylist(),
                               outs["jax"].column("n").to_pylist()) if v == 0]
    assert zeros == [6]


def test_compare_keeps_subnormals_where_jax_flushes_them():
    table = pa.table({"f": np.array([_TINY, 0.0, -_TINY], np.float64)})

    def build(f, df):
        return df.select(f.col("f").eq_null_safe(f.lit(0.0)).alias("ns"),
                         (f.col("f") > f.lit(0.0)).alias("gt"))
    outs = _engines(table, build, 1)
    for engine in ("port device", "port host"):
        out = outs[engine]
        assert out.column("ns").to_pylist() == [False, True, False], engine
        assert out.column("gt").to_pylist() == [True, False, False], engine
    # the reference's fault: the subnormals compare as zeros
    assert outs["jax"].column("ns").to_pylist() == [True, True, True]
    assert outs["jax"].column("gt").to_pylist() == [False, False, False]
