"""The port's match-span machinery (``expr/regex.py``) against the JAX
package's, function for function, on the same matrices made from a seed
with numpy (a few hundred rows, widths 16 and 64, random bytes of a small
alphabet, rows of length 0 and rows filling their width): ``match_ends``,
``literal_match_ends``, ``select_leftmost_spans``, ``replace_by_spans``,
``extract_first_span``, ``compile_group_plan``, ``group_bounds_all_starts``,
``parse_replacement_template``, ``replace_by_template`` and
``extract_group_span``; and the port's ``SubstringIndex`` device path (on
``delim_select_reference``) against the JAX one's scan. The patterns
cover literal and NFA searches, anchors at either end, ``$n`` templates
with ``\\$`` escapes and group 0, output widths that clip (a write past
the width lands on its last byte) and matches reaching the width. None of
the JAX functions is Pallas; they run under ``JAX_PLATFORMS=cpu``.
Tolerance: exact."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import regex as JR
from spark_rapids_tpu.expr.base import EvalCol as JEvalCol
from spark_rapids_tpu.expr.strings import SubstringIndex as JSubstringIndex

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr import regex as TR
from spark_rapids_tpu_torch.expr.base import EvalCol
from spark_rapids_tpu_torch.expr.strings import SubstringIndex

_ALPHABET = np.frombuffer(b"ab-12 xyzc\n9,", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n: int, w: int, seed: int):
    """(numpy uint8 (n, w), int32 lengths): random bytes of the alphabet,
    zero past each length; every eighth row empty, every fifth full."""
    rng = np.random.default_rng(seed)
    vals = _ALPHABET[rng.integers(0, len(_ALPHABET), (n, w))]
    lens = rng.integers(0, w + 1, n).astype(np.int32)
    lens[::8] = 0
    lens[1::5] = w
    vals = np.where(np.arange(w)[None, :] < lens[:, None], vals, 0)
    return vals.astype(np.uint8), lens


def _same(jax_out, port_out) -> None:
    for j, t in zip(jax_out, port_out):
        assert np.array_equal(np.asarray(j), t.numpy())


_PATTERNS = ["[0-9]+", "a+b?", "^ab", "[a-z]+-[0-9]+$", "[ab]{2,3}",
             "([a-z]+)-([0-9]+)", "^([a-z]+) ([0-9]+)$"]


@pytest.fixture(scope="module", params=[(300, 16), (160, 64)])
def rows(request):
    n, w = request.param
    vals, lens = _rows(n, w, w)
    return (vals, lens, torch.from_numpy(vals), torch.from_numpy(lens))


@pytest.mark.parametrize("pattern", _PATTERNS)
def test_spans_replace_and_extract_equal_jax(rows, pattern):
    vals, lens, tv, tl = rows
    jv, jl = jnp.asarray(vals), jnp.asarray(lens)
    jn, tn = JR.compile_device_nfa(pattern), TR.compile_device_nfa(pattern)
    assert (jn.spans_supported, jn.min_len) == (tn.spans_supported,
                                                tn.min_len)
    je = jn.match_ends(jnp, jv, jl)
    te = tn.match_ends(tv, tl)
    _same([je], [te])
    js, jm = JR.select_leftmost_spans(jnp, je, jl)
    ts, tm = TR.select_leftmost_spans(te, tl)
    _same([js, jm], [ts, tm])
    w = vals.shape[1]
    for repl, out_w in ((b"#", 2 * w), (b"LONGER", w), (b"", w)):
        _same(JR.replace_by_spans(jnp, jv, jl, js, jm, repl, out_w),
              TR.replace_by_spans(tv, tl, ts, tm, repl, out_w))
    _same(JR.extract_first_span(jnp, jv, jl, je),
          TR.extract_first_span(tv, tl, te))
    plan, tplan = JR.compile_group_plan(pattern), TR.compile_group_plan(
        pattern)
    assert (plan is None) == (tplan is None)
    if plan is None:
        return
    assert (plan.items, plan.groups, plan.ngroups) == (
        tplan.items, tplan.groups, tplan.ngroups)
    for g in range(1, plan.ngroups + 1):
        _same(JR.extract_group_span(jnp, jv, jl, je, plan, g),
              TR.extract_group_span(tv, tl, te, tplan, g))
    jb = JR.group_bounds_all_starts(jnp, jv, jl, plan)
    tb = TR.group_bounds_all_starts(tv, tl, tplan)
    for g in jb:
        _same(jb[g], tb[g])
    for template, out_w in (("$2/$1", 2 * w), (r"\$[$0]", 8),
                            ("$1$1$1", 4 * w)):
        segs = JR.parse_replacement_template(template, plan.ngroups)
        assert segs == TR.parse_replacement_template(template, plan.ngroups)
        _same(JR.replace_by_template(jnp, jv, jl, js, jm, je, segs, jb,
                                     out_w),
              TR.replace_by_template(tv, tl, ts, tm, te, segs, tb, out_w))


@pytest.mark.parametrize("search", [b"ab", b"-1", b"a", b"9,", b"xyzc\n9"])
def test_literal_match_ends_equal_jax(rows, search):
    vals, lens, tv, tl = rows
    _same([JR.literal_match_ends(jnp, jnp.asarray(vals), jnp.asarray(lens),
                                 search)],
          [TR.literal_match_ends(tv, tl, search)])


@pytest.mark.parametrize("template,ngroups", [
    ("$1", 1), ("$12", 1), ("$12", 12), ("a\\$b$0", 2), ("$", 1),
    ("x\\", 1), ("$3", 2), ("\\\\$1\\x", 1), ("plain", 0)])
def test_replacement_templates_parse_as_jax(template, ngroups):
    assert TR.parse_replacement_template(template, ngroups) \
        == JR.parse_replacement_template(template, ngroups)


@pytest.mark.parametrize("pattern", [
    "([a-z]+)-([0-9]+)", "(a)(b)?", "([a-z]*)", "(a|b)x", "([a-z]+)([a-z])",
    "((a)b)", "(x+?)y", "(\\d{2})(\\d{2})", "(é)", "[0-9]+"])
def test_group_plans_compile_as_jax(pattern):
    plan, tplan = JR.compile_group_plan(pattern), TR.compile_group_plan(
        pattern)
    assert (plan is None) == (tplan is None)
    if plan is not None:
        assert (plan.items, plan.groups, plan.ngroups) == (
            tplan.items, tplan.groups, tplan.ngroups)


@pytest.mark.parametrize("delim", [",", "aa", "ab", "xyzc\n"])
@pytest.mark.parametrize("count", [2, -1, -3])
def test_delim_select_equals_the_jax_scan(rows, delim, count):
    """substring_index's rows on ``delim_select``'s plain version equal the
    JAX device path's: a prefix up to the cut (count > 0) or the suffix
    from it (count < 0)."""
    vals, lens, tv, tl = rows
    ctx = types.SimpleNamespace(xp=jnp)
    jout = JSubstringIndex._eval_device(
        None, ctx, JEvalCol(jnp.asarray(vals), None, jdt.STRING,
                            jnp.asarray(lens)), delim, count)
    out = SubstringIndex._eval_device(EvalCol(tv, None, dt.STRING, tl),
                                      delim, count)
    _same([jout.values, jout.lengths], [out.values, out.lengths])
