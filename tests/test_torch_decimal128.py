"""The port's decimal128 module (``spark_rapids_tpu_torch/expr/decimal128.py``)
against the JAX package's ``spark_rapids_tpu/expr/decimal128.py``, plane
for plane: the same int64 limbs, made from a seed with numpy, go through
both, and every output (limbs, digit planes, flags, words) must be equal,
bit for bit. The cases are those of ``tests/test_decimal128.py`` at seeds 0
and 7, plus the kernel phase's edge rows (``chip_smoke.py``) at a small
size, and each against exact Python ints where the JAX test checks that.

The JAX package's uint64 words are int64 in the port with the same bits;
``d128_from_f64``'s limbs are compared where its flag is clear (past 2^127
the two truncations differ, and both flag the row)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.expr import decimal128 as jd

import chip_smoke as cs
from spark_rapids_tpu_torch.expr import decimal128 as td

SEEDS = [0, 7]


def _rand_ints(rng, n, bits):
    """tests/test_decimal128.py's values: random magnitudes under
    ``2^bits`` of both signs, the first rows the edge cases."""
    out = np.empty(n, dtype=object)
    for i in range(n):
        b = int(rng.integers(0, bits))
        v = int(rng.integers(0, 2 ** 62)) | (int(rng.integers(0, 2 ** 62))
                                              << 62)
        v &= (1 << b) - 1 if b else 0
        out[i] = -v if rng.random() < 0.5 else v
    edges = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 2 ** 64, -(2 ** 64),
             10 ** 18, -(10 ** 18), 10 ** 37, -(10 ** 37),
             (1 << 126) - 1, -((1 << 126) - 1)]
    out[:len(edges)] = edges[:len(out)]
    return out


def _limbs(vals) -> np.ndarray:
    return jd.limbs_from_py_ints(vals, len(vals))


def _both(vals):
    """(port tensor, JAX array) of the same limbs."""
    limbs = _limbs(vals)
    return torch.from_numpy(limbs.copy()), jnp.asarray(limbs)


def _np(x) -> np.ndarray:
    """A port tensor or a JAX array as numpy; uint64 as its int64 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _same(port, jax) -> None:
    np.testing.assert_array_equal(_np(port), _np(jax))


def _signed(limbs) -> list:
    out = []
    for v in jd.limbs_to_py_ints(_np(limbs)):
        v = int(v) % (1 << 128)
        out.append(v - (1 << 128) if v >= (1 << 127) else v)
    return out


@pytest.fixture(params=SEEDS)
def rng(request):
    return np.random.default_rng(request.param)


def test_limb_conversions_equal_jax(rng):
    vals = _rand_ints(rng, 64, 126)
    vals[-3:] = [10 ** 38 - 1, -(10 ** 38 - 1), None]
    got = td.limbs_from_py_ints(vals, 70)
    np.testing.assert_array_equal(got, jd.limbs_from_py_ints(vals, 70))
    back = td.limbs_to_py_ints(got)
    assert list(back) == list(jd.limbs_to_py_ints(got))
    assert list(back[:61]) == list(vals[:61])
    ints = np.array([int(v) for v in vals[:61]], dtype=object)
    small = np.array([v for v in ints if abs(v) < 2 ** 63], dtype=np.int64)
    np.testing.assert_array_equal(td.limbs_from_py_ints(small, 80),
                                  jd.limbs_from_py_ints(small, 80))


def test_add_sub_neg_equal_jax(rng):
    a, b = _rand_ints(rng, 128, 126), _rand_ints(rng, 128, 126)
    (pa, ja), (pb, jb) = _both(a), _both(b)
    for pf, jf in ((td.d128_add, jd.d128_add), (td.d128_sub, jd.d128_sub)):
        _same(pf(pa, pb), jf(ja, jb))
    _same(td.d128_neg(pa), jd.d128_neg(ja))
    m = 1 << 128

    def wrap(v):
        v %= m
        return v - m if v >= (1 << 127) else v
    assert _signed(td.d128_add(pa, pb)) == [wrap(int(x) + int(y))
                                            for x, y in zip(a, b)]
    assert _signed(td.d128_sub(pa, pb)) == [wrap(int(x) - int(y))
                                            for x, y in zip(a, b)]


def test_cmp_eq_lt_sign_abs_equal_jax(rng):
    a, b = _rand_ints(rng, 128, 126), _rand_ints(rng, 128, 126)
    b[:16] = a[:16]
    (pa, ja), (pb, jb) = _both(a), _both(b)
    for pf, jf in ((td.d128_cmp, jd.d128_cmp), (td.d128_eq, jd.d128_eq),
                   (td.d128_lt, jd.d128_lt)):
        _same(pf(pa, pb), jf(ja, jb))
    _same(td.d128_sign(pa), jd.d128_sign(ja))
    _same(td.d128_abs(pa), jd.d128_abs(ja))
    assert _np(td.d128_cmp(pa, pb)).tolist() == [
        (int(x) > int(y)) - (int(x) < int(y)) for x, y in zip(a, b)]


def test_key_words_equal_jax_and_sort_in_value_order(rng):
    a = _rand_ints(rng, 200, 126)
    pa, ja = _both(a)
    pw, jw = td.d128_key_words(pa), jd.d128_key_words(ja)
    for p, j in zip(pw, jw):
        _same(p, j)
    _same(td._biased_hi(pa), jd._biased_hi(ja))
    # the port sorts the words with their sign bit flipped
    keys = list(zip(*[(w ^ -2 ** 63).tolist() for w in pw]))
    order = sorted(range(200), key=lambda i: keys[i])
    assert [int(a[i]) for i in order] == sorted(int(v) for v in a)


@pytest.mark.parametrize("bits_a,bits_b,drop", [
    (60, 60, 0), (80, 40, 6), (100, 20, 10), (120, 6, 18), (63, 63, 4),
    (126, 126, 38)])
def test_mul_rescaled_equal_jax(rng, bits_a, bits_b, drop):
    a, b = _rand_ints(rng, 64, bits_a), _rand_ints(rng, 64, bits_b)
    (pa, ja), (pb, jb) = _both(a), _both(b)
    digits, neg = td.d128_mul(pa, pb)
    jdigits, jneg = jd.d128_mul(ja, jb)
    for p, j in zip(digits, jdigits):
        _same(p, j)
    _same(neg, jneg)
    for p, j in zip(td._div_pow10_round_half_up(digits, drop),
                    jd._div_pow10_round_half_up(jdigits, drop)):
        _same(p, j)
    limbs, over = td.d128_mul_rescaled_reference(pa, pb, drop, 38)
    jlimbs, jover = jd.d128_mul_rescaled(ja, jb, drop, 38)
    _same(limbs, jlimbs)
    _same(over, jover)
    got = _signed(limbs)
    for i in range(64):
        prod = int(a[i]) * int(b[i])
        q, r = divmod(abs(prod), 10 ** drop)
        if drop and 2 * r >= 10 ** drop:
            q += 1
        expect = -q if prod < 0 else q
        assert bool(over[i]) == (abs(expect) >= 10 ** 38)
        if not over[i]:
            assert got[i] == expect


def test_rescale_up_down_equal_jax(rng):
    a = _rand_ints(rng, 64, 90)
    pa, ja = _both(a)
    for fs, ts, p in ((2, 6, 38), (6, 2, 38), (0, 38, 38), (38, 0, 38),
                      (3, 3, 20), (0, 9, 25)):
        limbs, over = td.d128_rescale_reference(pa, fs, ts, p)
        jlimbs, jover = jd.d128_rescale(ja, fs, ts, p)
        _same(limbs, jlimbs)
        _same(over, jover)
    up, over_u = td.d128_rescale_reference(pa, 2, 6, 38)
    for i, v in enumerate(_signed(up)):
        expect = int(a[i]) * 10 ** 4
        assert bool(over_u[i]) == (abs(expect) >= 10 ** 38)
        if not over_u[i]:
            assert v == expect


def test_round_half_up_exact_half():
    vals = np.array([15, -15, 25, -25, 5, -5, 149, -149, 150, -150],
                    dtype=object)
    pa, ja = _both(vals)
    down, _ = td.d128_rescale_reference(pa, 1, 0, 38)
    assert _signed(down) == [2, -2, 3, -3, 1, -1, 15, -15, 15, -15]
    _same(down, jd.d128_rescale(ja, 1, 0, 38)[0])


def test_i64_f64_conversions_equal_jax(rng):
    ints = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 10 ** 18, -(10 ** 18)] \
        + [int(rng.integers(-2 ** 62, 2 ** 62)) for _ in range(57)]
    v = np.array(ints, dtype=np.int64)
    limbs = td.d128_from_i64(torch.from_numpy(v))
    _same(limbs, jd.d128_from_i64(jnp.asarray(v)))
    back, over = td.d128_to_i64(limbs)
    jback, jover = jd.d128_to_i64(jnp.asarray(_np(limbs)))
    _same(back, jback)
    _same(over, jover)
    wide = _rand_ints(rng, 64, 126)
    pw, jw = _both(wide)
    _same(td.d128_to_i64(pw)[1], jd.d128_to_i64(jw)[1])
    _same(td.d128_to_f64(pw), jd.d128_to_f64(jw))
    f = np.concatenate([np.array([1e30, -1e30, 1e40, -2.0 ** 127, np.nan,
                                  0.5, -0.5, 2.0 ** 64, 2.0 ** 126]),
                        rng.normal(0, 1e20, 55)])
    limbs, over = td.d128_from_f64(torch.from_numpy(f))
    jlimbs, jover = jd.d128_from_f64(jnp.asarray(f))
    _same(over, jover)
    ok = ~_np(over)
    np.testing.assert_array_equal(_np(limbs)[ok], _np(jlimbs)[ok])


def test_overflow_flag_equal_jax():
    vals = np.array([10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 38, -(10 ** 38),
                     10 ** 20, -(10 ** 20), 10 ** 20 - 1], dtype=object)
    pa, ja = _both(vals)
    for p in (38, 20):
        _same(td.d128_overflows(pa, p), jd.d128_overflows(ja, p))
    assert _np(td.d128_overflows(pa, 38)).tolist() == \
        [False, False, True, True, False, False, False]


@pytest.mark.parametrize("cap", [1, 16])
def test_segment_sum_equal_jax(rng, cap):
    n = 256
    vals = _rand_ints(rng, n, 120)
    gid = rng.integers(0, cap, n)
    contrib = rng.random(n) < 0.8
    pa, ja = _both(vals)
    limbs, over = td.d128_segment_sum_reference(
        pa, torch.from_numpy(contrib), torch.from_numpy(gid), cap, 38)
    jlimbs, jover = jd.d128_segment_sum(ja, jnp.asarray(contrib),
                                        jnp.asarray(gid), cap, 38)
    _same(limbs, jlimbs)
    _same(over, jover)
    got = _signed(limbs)
    for g in range(cap):
        expect = sum(int(v) for v, gi, c in zip(vals, gid, contrib)
                     if gi == g and c)
        assert bool(over[g]) == (abs(expect) >= 10 ** 38)
        if not over[g]:
            assert got[g] == expect


# ---------------------------------------------------------------------------
# the kernel phase's edge rows (chip_smoke.py), at a small size
# ---------------------------------------------------------------------------
_N = 300


def _cases(builder):
    return builder(np.random.default_rng(4), _N)


def _wide(ints, wide: bool):
    """(port operand, JAX limbs): a decimal64 operand is int64 in the port
    (the kernels read it as it is) and widened for the JAX function."""
    t = cs.d128_tensor(ints, wide, "cpu")
    return t, jnp.asarray(_np(td.d128_from_i64(t) if not wide else t))


@pytest.mark.parametrize("case", range(len(_cases(cs.d128_mul_cases))))
def test_mul_rescaled_edges_equal_jax(case):
    _, a, b, wa, wb, drop, p = _cases(cs.d128_mul_cases)[case]
    (pa, ja), (pb, jb) = _wide(a, wa), _wide(b, wb)
    limbs, over = td.d128_mul_rescaled_reference(pa, pb, drop, p)
    jlimbs, jover = jd.d128_mul_rescaled(ja, jb, drop, p)
    _same(limbs, jlimbs)
    _same(over, jover)


@pytest.mark.parametrize("case", range(len(_cases(cs.d128_rescale_cases))))
def test_rescale_edges_equal_jax(case):
    _, v, wide, fs, ts, p = _cases(cs.d128_rescale_cases)[case]
    pv, jv = _wide(v, wide)
    limbs, over = td.d128_rescale_reference(pv, fs, ts, p)
    jlimbs, jover = jd.d128_rescale(jv, fs, ts, p)
    _same(limbs, jlimbs)
    _same(over, jover)


@pytest.mark.parametrize("case",
                         range(len(_cases(cs.d128_segment_sum_cases))))
def test_segment_sum_edges_equal_jax(case):
    label, v, wide, c, g, cap, p = _cases(cs.d128_segment_sum_cases)[case]
    pv, jv = _wide(v, wide)
    limbs, over = td.d128_segment_sum_reference(
        pv, torch.from_numpy(c), torch.from_numpy(g), cap, p)
    jlimbs, jover = jd.d128_segment_sum(jv, jnp.asarray(c), jnp.asarray(g),
                                        cap, p)
    _same(limbs, jlimbs)
    _same(over, jover)
    if label.startswith("one group") or label.startswith("a total"):
        assert bool(over[0])


def test_edge_values_hold_every_exact_half():
    edges = cs.d128_edge_ints()
    assert max(abs(v) for v in edges) == 10 ** 38 - 1
    for k in cs.D128_DROPS:
        assert any(v % 10 ** k == 5 * 10 ** (k - 1) for v in edges
                   if v > 0), k


# ---------------------------------------------------------------------------
# Arrow <-> host decimals (columnar/host.py), against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision,scale", [(12, 2), (18, 0), (19, 4),
                                             (25, 2), (38, 2), (38, 0)])
def test_host_decimals_from_arrow_equal_jax(precision, scale):
    """The port reads the Arrow buffer as (n, 2) words, the JAX package
    builds a Decimal a row: the same ints (int64 up to 18 digits, Python
    ints beyond) on nulls, negatives and +-(10^p - 1), and the exact ones.
    Past 28 significant digits the JAX package's ``scaleb`` rounds in
    Python's default Decimal context (28 digits): 10^38 - 1 reads as
    10^38. That fault of the reference is pinned here; the port reads the
    exact value."""
    import decimal
    from decimal import Decimal
    import pyarrow as pa
    from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
    from spark_rapids_tpu_torch.columnar.host import HostColumn
    rng = np.random.default_rng(precision)
    top = 10 ** precision - 1
    ints = [top, -top, 0, 1, -1, None] + [
        int(v) for v in rng.integers(-10 ** min(precision, 18) + 1,
                                     10 ** min(precision, 18), 40)]
    exact = decimal.Context(prec=60)   # Decimal's default rounds at 28
    arr = pa.array([None if v is None else Decimal(v).scaleb(-scale, exact)
                    for v in ints], type=pa.decimal128(precision, scale))
    for a, vals in ((arr, ints), (arr.slice(3), ints[3:])):
        got, want = HostColumn.from_arrow(a), JHostColumn.from_arrow(a)
        assert got.values.dtype == want.values.dtype
        assert list(got.values) == [0 if v is None else v for v in vals]
        rounded = [len(str(abs(int(v)))) > 28 for v in got.values]
        assert [g for g, r in zip(got.values, rounded) if not r] \
            == [w for w, r in zip(want.values, rounded) if r is False]
        assert [w for w, r in zip(want.values, rounded) if r] \
            == [int(Decimal(int(g)).scaleb(0)) for g, r
                in zip(got.values, rounded) if r]
        np.testing.assert_array_equal(got.valid_mask(), want.valid_mask())
        assert got.to_arrow().equals(a)
    if precision > 28:
        assert JHostColumn.from_arrow(arr).values[0] == 10 ** precision
