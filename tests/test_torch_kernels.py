"""The port's kernel wrappers without the JAX package, so the file also runs
on the card's machine, where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On a CPU-only machine the ``cuda`` tests skip and the wrapper tests check
the CPU path and the input checks; on the card every kernel is held against
its plain version."""
import types

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch.expr.functions import col
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.udf.examples import pallas_axpy
from spark_rapids_tpu_torch.expr.base import AttributeReference, Literal
from spark_rapids_tpu_torch.expr.regex import compile_device_nfa
from spark_rapids_tpu_torch.expr.strings import Like
from spark_rapids_tpu_torch.udf.kernels import (axpy, axpy_reference,
                                                nfa_kernel_tables,
                                                nfa_match,
                                                nfa_match_reference)


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


_NFA_CHARS = list("abcdeprsqu ixyz019#\n\r") + ["\u00e9", "\u4e2d",
                                                 "\U0001f600"]
_NFA_WORDS = ["special", "requests", "Customer", "Complaints", "ab", "c"]


def _utf8_rows(n: int, w: int, seed: int):
    """(values uint8 (n, w), lengths int32 (n,)): random UTF-8 rows of up
    to ``w`` bytes, one in eight empty, one in ten ``ab<digits>c``, one in
    ten a run of ``ab``/``c`` and an optional ``x``, the rest random
    characters with the LIKE patterns' words."""
    rng = np.random.default_rng(seed)
    values = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        kind = rng.random()
        if kind < 0.125:
            continue
        if kind < 0.225:
            b = ("ab" + "7" * int(rng.integers(1, 6)) + "c").encode()
        elif kind < 0.325:
            b = ("".join(rng.choice(["ab", "c"], int(rng.integers(1, 7))))
                 + "x" * int(rng.integers(0, 2))).encode()
        else:
            target = int(rng.integers(1, w + 1))
            b = b""
            while True:
                part = (_NFA_WORDS[rng.integers(len(_NFA_WORDS))]
                        if rng.random() < 0.15 else
                        _NFA_CHARS[rng.integers(len(_NFA_CHARS))]).encode()
                if len(b) + len(part) > target:
                    break
                b += part
        if len(b) > w:
            continue
        values[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return torch.from_numpy(values), torch.from_numpy(lengths)


def _nfa(label: str):
    if label.startswith("%"):      # a LIKE pattern, as Like compiles it
        return Like(AttributeReference("s"), Literal(label)).device_nfa()
    return compile_device_nfa(label)


_NFA_PATTERNS = ["%special%requests%", "%Customer%Complaints%",
                 "^ab[0-9]+c$", "^(ab|c)*x?$", "(ab|c)*x?$", "a.b"]


def _nfa_args(nfa, values, lengths):
    cls, masks = nfa.tables(values.device)
    return (values, lengths, cls, masks, nfa.start_bits, nfa.accept_bits,
            nfa.anchored_start, nfa.anchored_end, nfa.nullable)


def test_nfa_match_wrapper_on_cpu_is_the_plain_version():
    values, lengths = _utf8_rows(64, 32, 0)
    nfa = _nfa("%special%requests%")
    launches = nfa_match.launches
    args = _nfa_args(nfa, values, lengths)
    assert torch.equal(nfa_match(*args), nfa_match_reference(*args))
    assert nfa_match.launches == launches  # no kernel on the CPU
    assert nfa_match(values[:0], lengths[:0], *args[2:]).shape == (0,)


@pytest.mark.parametrize("bad", ["int8 values", "1-D values", "strided",
                                 "int64 lengths", "short lengths",
                                 "int32 masks", "33 states",
                                 "accepting start"])
def test_nfa_match_wrapper_rejects_bad_inputs(bad):
    values, lengths = _utf8_rows(16, 16, 1)
    args = list(_nfa_args(_nfa("a.b"), values, lengths))
    if bad == "int8 values":
        args[0] = values.to(torch.int8)
    elif bad == "1-D values":
        args[0] = values.reshape(-1)
    elif bad == "strided":
        args[0] = torch.cat([values, values], 1)[:, ::2]
    elif bad == "int64 lengths":
        args[1] = lengths.long()
    elif bad == "short lengths":
        args[1] = lengths[:8]
    elif bad == "int32 masks":
        args[3] = args[3].to(torch.int32)
    elif bad == "accepting start":
        args[5] |= args[4]
    else:
        args[3] = torch.zeros((2, 33), dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        nfa_match(*args)


def _edge_rows(w: int):
    """Rows of length 0 and ``w``, and rows whose multi-byte characters
    straddle 16-byte pieces and 64-byte chunks at every offset."""
    rows = [b"", b"q" * w]
    for edge in (16, 64, 128, 4096):
        for lead in range(max(0, edge - 4), edge + 1):
            for ch in ("\u00e9", "\u4e2d", "\U0001f600"):
                rows.append((b"q" * lead + ch.encode() + b"ab7c")[:w])
    values = np.zeros((len(rows), w), np.uint8)
    lengths = np.array([len(b) for b in rows], np.int32)
    for i, b in enumerate(rows):
        values[i, :len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(values), torch.from_numpy(lengths)


def _kernel_paths(nfa, device):
    """The kernel's own path for ``nfa`` and its NFA path (a DFA cap of 0),
    as tables on ``device``."""
    own = nfa_kernel_tables(nfa.class_of_byte, nfa.masks, nfa.start_bits,
                            nfa.accept_bits, nfa.anchored_start,
                            nfa.anchored_end, nfa.nullable)
    nfa_path = nfa_kernel_tables(nfa.class_of_byte, nfa.masks,
                                 nfa.start_bits, nfa.accept_bits,
                                 nfa.anchored_start, nfa.anchored_end,
                                 nfa.nullable, dfa_max_states=0)
    assert not nfa_path.dfa
    return {"own": own.to(device), "nfa": nfa_path.to(device)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16, 64, 256, 4096])
@pytest.mark.parametrize("pattern", _NFA_PATTERNS)
def test_nfa_match_kernel_matches_plain_version_on_card(cuda_device, width,
                                                        pattern):
    """Both kernel paths, on random rows plus rows of length 0 and ``w``
    and characters across piece and chunk edges, as the whole matrix and
    as views off 16-byte alignment."""
    values, lengths = _utf8_rows(3000 if width <= 256 else 300, width,
                                 width)
    ev, el = _edge_rows(width)
    values, lengths = torch.cat([values, ev]), torch.cat([lengths, el])
    nfa = _nfa(pattern)
    want_cpu = nfa_match_reference(*_nfa_args(nfa, values, lengths))
    n = len(lengths)
    flat = torch.zeros(n * width + 32, dtype=torch.uint8, device=cuda_device)
    shifted = flat[5:5 + n * width].view(n, width)
    shifted.copy_(values.to(cuda_device))
    dev_v, dev_l = values.to(cuda_device), lengths.to(cuda_device)
    views = {"whole": (dev_v, dev_l, want_cpu),
             "from row 1": (dev_v[1:], dev_l[1:].contiguous(),
                            want_cpu[1:]),
             "5 bytes off": (shifted, dev_l, want_cpu)}
    for path, tables in _kernel_paths(nfa, cuda_device).items():
        for view, (v, ln, want) in views.items():
            args = _nfa_args(nfa, v, ln)
            launches = nfa_match.launches
            got = nfa_match(*args, kernel_tables=tables)
            torch.cuda.synchronize()
            assert nfa_match.launches == launches + 1
            assert torch.equal(got, nfa_match_reference(*args)), (path, view)
            assert torch.equal(got.cpu(), want), (path, view)


def _newline_rows(w: int):
    """Random rows each ending in a newline (or two, or \\r\\n), and the
    rows of one newline."""
    values, lengths = _utf8_rows(2000, w, w + 11)
    ends = [b"\n", b"\n\n", b"\r\n", b"b\n", b"c\n", b"3c\n"]
    for i in range(len(lengths)):
        e = ends[i % len(ends)]
        cut = min(int(lengths[i]), w - len(e))
        if cut >= 0 and i % 3:
            values[i, cut:] = 0
            values[i, cut:cut + len(e)] = torch.frombuffer(bytearray(e),
                                                           dtype=torch.uint8)
            lengths[i] = cut + len(e)
    return values, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 64, 256])
@pytest.mark.parametrize("pattern", ["b$", "^ab[0-9]+c$", "^(ab|c)*x?$",
                                     "^$", "(a|b)*a(a|b)(a|b)(a|b)(a|b)"
                                     "(a|b)$"])
def test_nfa_match_dollar_before_a_final_newline_on_card(cuda_device, width,
                                                         pattern):
    """A regex `$` (``end_newline``) on both kernel paths, rows ending in
    newlines: equal to the plain version, and the flag's tables apart from
    the strict end's."""
    values, lengths = _newline_rows(width)
    nfa = _nfa(pattern)
    assert nfa.end_newline
    want = nfa_match_reference(*_nfa_args(nfa, values, lengths),
                               end_newline=True)
    args = _nfa_args(nfa, values.to(cuda_device), lengths.to(cuda_device))
    for cap in (64, 0):
        tables = nfa_kernel_tables(
            nfa.class_of_byte, nfa.masks, nfa.start_bits, nfa.accept_bits,
            nfa.anchored_start, nfa.anchored_end, nfa.nullable,
            dfa_max_states=cap, end_newline=True).to(cuda_device)
        got = nfa_match(*args, kernel_tables=tables, end_newline=True)
        assert torch.equal(got.cpu(), want), cap
    # the pattern's own cached tables, through DeviceNfa.matches
    col_ = types.SimpleNamespace(values=args[0], lengths=args[1])
    assert torch.equal(nfa.matches(None, col_).cpu(), want)


@pytest.mark.cuda
def test_like_keeps_its_strict_end_on_card(cuda_device):
    """LIKE compiles through the same NFA with its end strict: '%b' on
    "ab\\n" is false on the card, where RLIKE 'b$' is true."""
    values, lengths = _newline_rows(64)
    like, rlike = _nfa("%b"), _nfa("b$")
    assert like.anchored_end and not like.end_newline
    col_ = types.SimpleNamespace(values=values.to(cuda_device),
                                 lengths=lengths.to(cuda_device))
    got_like = like.matches(None, col_).cpu()
    assert torch.equal(got_like, nfa_match_reference(
        *_nfa_args(like, values, lengths)))
    row = b"ab\n"
    one = torch.zeros((1, 64), dtype=torch.uint8)
    one[0, :3] = torch.frombuffer(bytearray(row), dtype=torch.uint8)
    single = types.SimpleNamespace(values=one.to(cuda_device),
                                   lengths=torch.tensor([3], dtype=torch.int32,
                                                        device=cuda_device))
    assert not bool(like.matches(None, single)[0])
    assert bool(rlike.matches(None, single)[0])


@pytest.mark.cuda
def test_nfa_match_kernel_builds_tables_when_none_given(cuda_device):
    values, lengths = _utf8_rows(500, 64, 3)
    nfa = _nfa("%special%requests%")
    args = _nfa_args(nfa, values.to(cuda_device), lengths.to(cuda_device))
    assert torch.equal(nfa_match(*args),
                       nfa_match(*args, kernel_tables=nfa.kernel_tables(
                           cuda_device)))
    assert torch.equal(nfa_match(*args).cpu(),
                       nfa_match_reference(*_nfa_args(nfa, values,
                                                      lengths)))
