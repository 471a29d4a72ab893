"""Decimal -> integral casts on the port's device path and its host engine
against Python's exact ``int(Decimal)`` truncation, both tiers (scaled
int64 up to 18 digits, two limbs beyond): truncation toward zero in integer
space, and past the target's range its low bits (Spark's non-ANSI
``Decimal.toLong``, then ``.toInt``, ``.toShort``, ``.toByte``).

The JAX package converts through float64 (its ``expr/cast.py`` decimal
branch) and saturates out of range: wrong from 2^53 on, and pinned here as
the reference's fault with its values. On the card (``cuda``) the same
inputs run through the kernels' device path; that case needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decimal_cast.py
"""
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import functions as F
from spark_rapids_tpu_torch.session import TorchSession

_BITS = {"LONG": 64, "INT": 32, "SHORT": 16, "BYTE": 8}


def _exact(v: Decimal, to: str) -> int:
    """``int(v)`` (truncation toward zero), its low bits of the target."""
    b = _BITS[to]
    return (int(v) + 2 ** (b - 1)) % 2 ** b - 2 ** (b - 1)


def _random_d30_4(n: int = 300) -> list:
    """``n`` DECIMAL(30,4) values uniform in magnitude below 1e16 (unscaled
    below 10^20), both signs: most pass 2^53 unscaled."""
    rng = np.random.default_rng(30)
    hi = rng.integers(0, 10 ** 10, n)
    lo = rng.integers(0, 10 ** 10, n)
    neg = rng.random(n) < 0.5
    return [Decimal(-v if ng else v).scaleb(-4) for v, ng in
            zip((int(h) * 10 ** 10 + int(x) for h, x in zip(hi, lo)), neg)]


#: label -> (values, precision, scale, targets)
CASES = {
    "decimal(18,0) past 2^53": (
        [Decimal(100000000000000007), Decimal(123456789012345678),
         Decimal(-123456789012345678), Decimal(0)], 18, 0, ["LONG"]),
    "decimal(12,2) fractions": (
        [Decimal("-1.99"), Decimal("1.99"), Decimal("-0.01"),
         Decimal("99999999.99"), Decimal("-2147483648.50")], 12, 2,
        ["LONG", "INT", "SHORT", "BYTE"]),
    "300 random decimal(30,4) below 1e16": (_random_d30_4(), 30, 4,
                                            ["LONG", "INT"]),
    "decimal(38,0) out of range": (
        [Decimal(2 ** 63 + 5), Decimal(3 * 10 ** 30), Decimal(2 ** 31 + 9),
         Decimal(-(2 ** 63 + 5)), Decimal(-12), Decimal(10 ** 38 - 1),
         Decimal(-(10 ** 38 - 1))], 38, 0, ["LONG", "INT", "SHORT", "BYTE"]),
    "decimal(38,10) out of range": (
        [Decimal(3 * 10 ** 27 + 7).scaleb(-10),
         Decimal(-(2 ** 100 + 12345)).scaleb(-10)], 38, 10, ["LONG", "INT"]),
}


def _table(values, p: int, s: int) -> pa.Table:
    return pa.table({"d": pa.array(values, type=pa.decimal128(p, s))})


def _casts(df, targets):
    return df.select(*[F.col("d").cast(getattr(dt, to)).alias(to)
                       for to in targets])


@pytest.mark.parametrize("label", list(CASES))
def test_decimal_to_integral_truncates_exactly_on_both_engines(label):
    values, p, s, targets = CASES[label]
    q = _casts(TorchSession({}, device="cpu").create_dataframe(
        _table(values, p, s), num_partitions=2), targets)
    device, host = q.collect(), q.collect(device=False)
    for to in targets:
        want = [_exact(v, to) for v in values]
        assert device.column(to).to_pylist() == want, to
        assert host.column(to).to_pylist() == want, to


def _jax(values, p: int, s: int, targets) -> dict:
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.expr import functions as JF
    from spark_rapids_tpu.session import TpuSession
    out = TpuSession({}).create_dataframe(_table(values, p, s)).select(
        *[JF.col("d").cast(getattr(jdt, to)).alias(to) for to in targets]) \
        .collect(device=True)
    return {to: out.column(to).to_pylist() for to in targets}


def test_jax_float_path_is_the_reference_fault():
    """The JAX package's answers where it differs from Spark's: float64
    rounding past 2^53, saturation out of range."""
    pytest.importorskip("jax")
    got = _jax(*CASES["decimal(18,0) past 2^53"][:3], ["LONG"])
    assert got["LONG"][:2] == [100000000000000000, 123456789012345680]
    got = _jax([Decimal(2 ** 63 + 5), Decimal(3 * 10 ** 30),
                Decimal(2 ** 31 + 9)], 38, 0, ["LONG", "INT"])
    assert got == {"LONG": [2 ** 63 - 1, 2 ** 63 - 1, 2 ** 31 + 9],
                   "INT": [2 ** 31 - 1] * 3}
    values, p, s, _ = CASES["300 random decimal(30,4) below 1e16"]
    jax = _jax(values, p, s, ["LONG"])["LONG"]
    wrong = sum(j != _exact(v, "LONG") for j, v in zip(jax, values))
    assert wrong == 153, wrong


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CASES))
def test_decimal_to_integral_on_the_card(label):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (run on the card)")
    values, p, s, targets = CASES[label]
    out = _casts(TorchSession({}, device="cuda").create_dataframe(
        _table(values, p, s), num_partitions=2), targets).collect()
    for to in targets:
        assert out.column(to).to_pylist() == [_exact(v, to)
                                              for v in values], to
