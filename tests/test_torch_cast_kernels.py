"""The ``str_parse``, ``str_format`` and ``row_hash`` kernels
(``csrc/strings_cast.cu``) against their plain versions, bit for bit,
without the JAX package, so the file also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cast_kernels.py

Every test needs the card and skips without one (the kernels have no CPU
mode; on the CPU the wrappers compute the plain versions, which
``test_torch_cast_strings.py`` and ``test_torch_hash.py`` hold against the
JAX package). The inputs are random rows made from a seed with numpy, the
edge cases of each grammar, garbage bytes past each row's length, several
matrix widths and a broadcast row; each wrapper is also captured in a CUDA
graph on a side stream, which fails if it launches on any other stream.
The edge sets (``edge_longs``, ``edge_days``, ``edge_strings``, kept in
``chip_smoke.py`` for its edge phase) also feed
``test_torch_strings_kernel_model.py``, which runs the CUDA source and a
numpy model of its arithmetic on the CPU: every power of ten and its
neighbours, the int64 and int32 extremes, the year clip points, rows of
spaces only and rows filling their width, widths 8 to 136 (past 128 the
parse keeps its byte loop), views that are not 16-byte aligned."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr.base import EvalCol
from spark_rapids_tpu_torch.expr.cast_kernels import (
    str_format, str_format_reference, str_parse, str_parse_reference)
from spark_rapids_tpu_torch.expr.hashing import row_hash, row_hash_reference

EDGE = cs.CAST_EDGE_STRINGS
_matrix = cs.cast_matrix
edge_strings = cs.cast_edge_strings


def random_numeric_strings(n: int, seed: int) -> list:
    """Decimal numbers, exponents, signs, whitespace, dates and stray
    characters, chosen to exercise every branch of the four grammars."""
    rng = np.random.default_rng(seed)
    digits = list("0123456789")
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            y, m, d = rng.integers(0, 10000), rng.integers(0, 14), \
                rng.integers(0, 33)
            out.append(f"{y:04d}-{m}-{d}" if rng.random() < .5
                       else f"{y:04d}-{m:02d}-{d:02d}")
            continue
        s = "".join(rng.choice(digits, rng.integers(1, 26)))
        if rng.random() < .5:
            p = rng.integers(0, len(s) + 1)
            s = s[:p] + "." + s[p:]
        if rng.random() < .4:
            s += rng.choice(["e", "E"]) + str(rng.integers(-330, 330))
        if rng.random() < .3:
            s = rng.choice(["-", "+"]) + s
        if rng.random() < .1:
            s = " " * rng.integers(1, 3) + s + "\t" * rng.integers(0, 2)
        if rng.random() < .05:
            p = rng.integers(0, len(s) + 1)
            s = s[:p] + rng.choice(list("x.-e+ ")) + s[p:]
        out.append(s)
    return out


_I64_MIN, _I64_MAX = -2**63, 2**63 - 1


def edge_longs() -> np.ndarray:
    return np.array(cs.cast_edge_longs(), dtype=np.int64)


def edge_days() -> np.ndarray:
    return np.array(cs.cast_edge_days(), dtype=np.int32)


def _rand_longs(rng, n: int) -> np.ndarray:
    """Uniform int64, and values of every digit count."""
    a = rng.integers(_I64_MIN, _I64_MAX, n // 2, dtype=np.int64,
                     endpoint=True)
    digits = rng.integers(1, 19, n - n // 2)
    b = (rng.random(n - n // 2) * 10.0 ** digits).astype(np.int64)
    return np.concatenate([a, np.where(rng.random(b.size) < .5, -b, b)])


def format_inputs(kind: str, rng, n: int) -> torch.Tensor:
    if kind in ("long", "decimal"):
        v = np.concatenate([edge_longs(), _rand_longs(rng, n)])
    elif kind == "date":
        v = np.concatenate([edge_days(), rng.integers(-2**31, 2**31, n // 2,
                                                      dtype=np.int32),
                            rng.integers(-800000, 3100000, n - n // 2,
                                         dtype=np.int32)])
    else:
        v = rng.random(n) < .5
    return torch.from_numpy(np.ascontiguousarray(v))


def matrix(strs, w: int, seed: int):
    """``_matrix`` as CPU tensors."""
    data, lens = _matrix(strs, w, seed)
    return torch.from_numpy(data), torch.from_numpy(lens)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_str_parse_equals_plain_bit_for_bit(cuda_device, kind, width):
    strs = EDGE + random_numeric_strings(5000, width)
    data, lens = _matrix(strs, width, width)
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    got, ok = str_parse(d, ln, kind)
    want, wok = str_parse_reference(d, ln, kind)
    torch.cuda.synchronize()
    assert torch.equal(ok, wok), kind
    assert _same(got, want), kind
    # the plain version on the CPU agrees too (no device-specific rounding)
    cwant, cwok = str_parse_reference(torch.from_numpy(data),
                                      torch.from_numpy(lens), kind)
    assert torch.equal(ok.cpu(), cwok) and _same(got.cpu(), cwant), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["long", "double", "date"])
def test_str_parse_broadcast_row(cuda_device, kind):
    """A literal's matrix is one row broadcast (stride 0)."""
    for s in ("  -123.5e2 ", "2020-02-29", "x"):
        row, ln = _matrix([s], 16, 0)
        d = torch.from_numpy(row).to(cuda_device).expand(300, -1)
        lens = torch.full((300,), int(ln[0]), dtype=torch.int32,
                          device=cuda_device)
        got, ok = str_parse(d, lens, kind)
        want, wok = str_parse_reference(d, lens, kind)
        torch.cuda.synchronize()
        assert torch.equal(ok, wok) and _same(got, want), (kind, s)


def _format_inputs(kind: str, n: int, seed: int, device) -> torch.Tensor:
    return format_inputs(kind, np.random.default_rng(seed), n).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,scale", [("long", 0), ("decimal", 0),
                                        ("decimal", 1), ("decimal", 2),
                                        ("decimal", 7), ("decimal", 18),
                                        ("date", 0), ("bool", 0)])
def test_str_format_equals_plain_bit_for_bit(cuda_device, kind, scale):
    """The edge values of ``format_inputs`` (the int64 and day extremes,
    every power of ten and its neighbours, the year clip points) and
    random ones."""
    v = _format_inputs(kind, 20000, scale, cuda_device)
    got, lens = str_format(v, kind, scale)
    want, wlens = str_format_reference(v, kind, scale)
    torch.cuda.synchronize()
    assert torch.equal(lens, wlens), kind
    assert torch.equal(got, want), kind


def hash_columns(n: int, seed: int, device, width: int = 16) -> list:
    """Every kind of column the kernel hashes: booleans, the integer
    widths, a date, a long, floats with -0.0 and NaN payloads, strings of
    every length up to the width (garbage past the length), about 10 %
    nulls each."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def valid():
        return t(rng.random(n) > .1)

    f = rng.normal(size=n)
    pick = rng.integers(0, 6, n)
    f[pick == 0] = 0.0
    f[pick == 1] = -0.0
    f.view(np.uint64)[pick == 2] = 0xFFF8000000000001
    f.view(np.uint64)[pick == 3] = 0x7FF0000000000123
    f32 = rng.normal(size=n).astype(np.float32)
    f32[pick == 1] = -0.0
    f32.view(np.uint32)[pick == 2] = 0xFFC00001
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    mat = rng.integers(0, 256, (n, width)).astype(np.uint8)
    return [
        EvalCol(t(rng.random(n) < .5), valid(), dt.BOOLEAN),
        EvalCol(t(rng.integers(-128, 128, n).astype(np.int8)), valid(),
                dt.BYTE),
        EvalCol(t(rng.integers(-2**15, 2**15, n).astype(np.int16)), None,
                dt.SHORT),
        EvalCol(t(rng.integers(-2**31, 2**31, n).astype(np.int32)), valid(),
                dt.INT),
        EvalCol(t(rng.integers(-10**6, 10**6, n).astype(np.int32)), valid(),
                dt.DATE),
        EvalCol(t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
                valid(), dt.LONG),
        EvalCol(t(f), valid(), dt.DOUBLE),
        EvalCol(t(f32), valid(), dt.FLOAT),
        EvalCol(t(mat), valid(), dt.STRING, t(lens)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("xx", [False, True])
@pytest.mark.parametrize("width", [8, 16, 72])
def test_row_hash_equals_plain_bit_for_bit(cuda_device, xx, width):
    n = 7000
    cols = hash_columns(n, width, cuda_device, width)
    for pick in (cols, cols[-1:], cols[5:6], cols[::-1], []):
        got = row_hash(pick, n, xx, device=cuda_device)
        want = row_hash_reference(pick, n, xx, device=cuda_device)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (xx, width, len(pick))


@pytest.mark.cuda
def test_wrappers_launch_on_the_current_stream(cuda_device):
    """Captured in a CUDA graph on a side stream, each wrapper's replay
    gives its plain result."""
    data, lens = _matrix(EDGE + random_numeric_strings(3000, 5), 32, 5)
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    days = _format_inputs("date", 3000, 6, cuda_device)
    cols = hash_columns(3000, 7, cuda_device)
    runs = {
        "str_parse": (lambda: str_parse(d, ln, "double")[0],
                      lambda: str_parse_reference(d, ln, "double")[0]),
        "str_format": (lambda: str_format(days, "date")[0],
                       lambda: str_format_reference(days, "date")[0]),
        "row_hash": (lambda: row_hash(cols, 3000, True),
                     lambda: row_hash_reference(cols, 3000, True)),
    }
    side = torch.cuda.Stream()
    for name, (fn, plain) in runs.items():
        fn()  # load the library and warm up outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert _same(out, plain()), name


@pytest.mark.cuda
def test_launch_counts(cuda_device):
    """Each wrapper counts one launch a call on the card."""
    data, lens = _matrix(["12", "x"], 8, 0)
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    before = (str_parse.launches, str_format.launches, row_hash.launches)
    str_parse(d, ln, "long")
    str_format(ln.to(torch.int64), "long")
    row_hash([EvalCol(ln, None, dt.INT)], 2, False, device=cuda_device)
    after = (str_parse.launches, str_format.launches, row_hash.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
@pytest.mark.parametrize("width", [8, 20, 24, 128, 136])
def test_str_parse_edge_rows(cuda_device, kind, width):
    """Spaces only, rows filling their width, the grammars' edges; 16-byte
    vectors at width 128, 8-byte ones at 8 and 24, bytes at 20, the byte
    loop past 128."""
    strs = edge_strings(width) + random_numeric_strings(2000, width + 1)
    data, lens = matrix(strs, width, width + 1)
    d, ln = data.to(cuda_device), lens.to(cuda_device)
    got, ok = str_parse(d, ln, kind)
    want, wok = str_parse_reference(d, ln, kind)
    torch.cuda.synchronize()
    assert torch.equal(ok, wok) and _same(got, want), kind
    # on the CPU too, but for a NaN's bits: 0 * inf (as '0e400' gives)
    # is the card's default NaN there, x86's here
    cwant, cwok = str_parse_reference(data, lens, kind)
    got = got.cpu()
    nan = torch.isnan(got) & torch.isnan(cwant) if kind == "double" \
        else torch.zeros_like(cwok)
    assert torch.equal(ok.cpu(), cwok), kind
    assert _same(torch.where(nan, 0.0, got), torch.where(nan, 0.0, cwant)) \
        if kind == "double" else _same(got, cwant), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["long", "double", "bool", "date"])
def test_str_parse_unaligned_views(cuda_device, kind):
    """Views 1 and 8 bytes into 48-byte rows: bytes one by one, then 8-byte
    vectors."""
    strs = edge_strings(32) + random_numeric_strings(2000, 4)
    big, lens = matrix(strs, 48, 4)
    big = big.to(cuda_device)
    for lo in (1, 8):
        view = big[:, lo:lo + 32]
        vlens = torch.clamp(lens - lo, 0, 32).to(torch.int32).to(cuda_device)
        got, ok = str_parse(view, vlens, kind)
        want, wok = str_parse_reference(view, vlens, kind)
        torch.cuda.synchronize()
        assert torch.equal(ok, wok) and _same(got, want), (kind, lo)


@pytest.mark.cuda
def test_redesigned_paths_in_a_graph_on_a_side_stream(cuda_device):
    """Each load path of str_parse (16- and 8-byte vectors, bytes, the
    wide rows' byte loop) and each kind of str_format, captured in a CUDA
    graph on a side stream: the replay gives the plain result."""
    strs = edge_strings(32) + random_numeric_strings(1000, 8)
    runs = {}
    for width in (8, 128, 136):
        data, lens = matrix(strs, width, width)
        d, ln = data.to(cuda_device), lens.to(cuda_device)
        runs[f"str_parse w{width}"] = (
            lambda d=d, ln=ln: str_parse(d, ln, "double")[0],
            lambda d=d, ln=ln: str_parse_reference(d, ln, "double")[0])
    big, lens = matrix(strs, 40, 3)
    view = big.to(cuda_device)[:, 3:35]
    vlens = torch.clamp(lens - 3, 0, 32).to(torch.int32).to(cuda_device)
    runs["str_parse unaligned"] = (
        lambda: str_parse(view, vlens, "long")[0],
        lambda: str_parse_reference(view, vlens, "long")[0])
    rng = np.random.default_rng(8)
    for kind, scale in (("long", 0), ("decimal", 2), ("date", 0),
                        ("bool", 0)):
        v = format_inputs(kind, rng, 2000).to(cuda_device)
        runs[f"str_format {kind}"] = (
            lambda v=v, k=kind, s=scale: str_format(v, k, s)[0],
            lambda v=v, k=kind, s=scale: str_format_reference(v, k, s)[0])
    side = torch.cuda.Stream()
    for name, (fn, plain) in runs.items():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert _same(out, plain()), name
