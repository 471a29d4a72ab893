"""The ``regex_replace``, ``regex_extract`` and ``delim_select`` kernels
(``csrc/regex.cu``) against their plain versions, bit for bit, without the
JAX package, so the file also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_regex_kernels.py

Every test needs the card and skips without one (the kernels have no CPU
mode; on the CPU the wrappers compute the plain versions, which
``test_torch_regex_spans.py`` holds against the JAX package, and
``test_torch_regex_kernel_model.py`` runs the CUDA source under g++). The
cases are ``chip_smoke.py``'s: random rows of width 32 and edge rows at
widths 8, 16, 64 and 136, outputs that clip, a broadcast row, a view off
16-byte alignment, ``REGEX_EDGE_STRINGS`` (a final newline under `$`,
matches as long as the row, a pattern past the span DFA's cap) at widths
8 and 16 (regex_extract's lane groups of 4 lanes), 32 (8), 64 (16) and
136, every NFA case again with no span DFA (the NFA's successor sets
step); rows of 128 KiB, which regex_extract reads where they lie, against
Python's re (``WIDE_CASES``); each wrapper is also captured in a CUDA
graph on a side stream, which fails if it launches on any other
stream."""
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


_CASES = cs.regex_case_programs()
_IDS = [c[0] for c in _CASES]
_NFA_CASES = cs.regex_nfa_case_programs()
_NFA_INDEX = [i for i, c in enumerate(_IDS)
              if not c.startswith(("delim", "replace b'"))]


#: the width of rows past what regex_extract stages in shared memory (a
#: row and its output beside the program, about 116 KB): its kernel reads
#: them where they lie
WIDE = 1 << 17


def _re_replace(pat, repl):
    return lambda s: re.sub(pat, repl, s)


def _re_group(pat, g):
    return lambda s: m.group(g) if (m := re.search(pat, s)) else ""


#: (label, kind, pattern, argument, Python's re on a row) at width
#: ``WIDE``: patterns on which Java's find(), the port and re agree; a
#: template that triples each digit (an output about 4x the width), a
#: `$` before a final newline
WIDE_CASES = [
    ("replace '([0-9])' -> '$1$1$1'", "replace", "([0-9])", "$1$1$1",
     _re_replace("([0-9])", r"\1\1\1")),
    ("replace '[aeiou]+' -> '#'", "replace", "[aeiou]+", "#",
     _re_replace("[aeiou]+", "#")),
    ("extract '([0-9]+)-([0-9]+)-([0-9]+)' 3", "extract",
     "([0-9]+)-([0-9]+)-([0-9]+)", 3,
     _re_group("([0-9]+)-([0-9]+)-([0-9]+)", 3)),
    ("extract 'b$' 0", "extract", "b$", 0, _re_group("b$", 0))]


def wide_rows(n: int = 7, seed: int = 17) -> tuple:
    """(uint8 (n, WIDE), int32 lengths) as numpy arrays: ``regex_rows``
    (an empty row, a full one, random lengths); the row before the last
    letters up to a match 100,000 bytes in whose third group is 5,000
    digits long; the last row ending in '12-34-56 ab\\n' at its
    length."""
    data, lens = cs.regex_rows(n, WIDE, seed)
    deep = b"x" * 100_000 + b"1-2-" + b"3" * 5000 + b" ae"
    data[-2, :len(deep)] = np.frombuffer(deep, np.uint8)
    lens[-2] = len(deep)
    tail = np.frombuffer(b"12-34-56 ab\n", np.uint8)
    end = max(int(lens[-1]), len(tail))
    data[-1, end - len(tail):end] = tail
    lens[-1] = end
    return data, lens


def wide_case(case, nfa_sets: bool = False):
    """(label, kind, program, argument) of a ``WIDE_CASES`` entry; with
    ``nfa_sets`` its program has no span DFA."""
    from spark_rapids_tpu_torch.expr.regex_kernels import (
        _without_span_dfa, extract_program, replace_program)
    label, kind, pat, arg, _ = case
    prog = replace_program(pat, arg) if kind == "replace" \
        else extract_program(pat, arg)
    return (label, kind, _without_span_dfa(prog) if nfa_sets else prog,
            None if kind == "replace" else arg)


def wide_want(case, data: np.ndarray, lens: np.ndarray, out_w: int):
    """``case``'s outputs by Python's re: each row's result from byte 0,
    zero past it (no output here reaches ``out_w``), and its length."""
    out = np.zeros((len(lens), out_w), np.uint8)
    out_len = np.zeros(len(lens), np.int32)
    for i, n in enumerate(lens):
        b = case[4](bytes(data[i, :n]).decode("latin-1")).encode("latin-1")
        assert len(b) < out_w
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        out_len[i] = len(b)
    return torch.from_numpy(out), torch.from_numpy(out_len)


def _check(case, data, lens, out_w=None) -> None:
    label, kind, prog, arg = case
    got = cs.run_regex_case(kind, prog, arg, data, lens, False, out_w)
    want = cs.run_regex_case(kind, prog, arg, data, lens, True, out_w)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_), label


def _rows(n, w, seed, device):
    data, lens = cs.regex_rows(n, w, seed)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(lens).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(_CASES)), ids=_IDS)
def test_kernel_equals_plain_bit_for_bit(cuda_device, index):
    case = _CASES[index]
    _check(case, *_rows(20_000, 32, index, cuda_device))
    for w in (8, 16, 64, 136):
        _check(case, *_rows(2000, w, 100 + w, cuda_device))
    if case[1] == "replace":
        for out_w in (8, 12):
            _check(case, *_rows(2000, 16, index, cuda_device), out_w=out_w)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(_CASES)), ids=_IDS)
def test_broadcast_row_and_unaligned_view(cuda_device, index):
    case = _CASES[index]
    row, ln = _rows(1, 32, 3, cuda_device)
    _check(case, row.expand(700, -1), ln.expand(700).contiguous())
    big, blen = _rows(3000, 48, 7, cuda_device)
    _check(case, big[:, 1:33], (blen - 1).clamp(0, 32))


@pytest.mark.cuda
def test_each_wrapper_launches_on_the_current_stream(cuda_device):
    """Captured in a CUDA graph on a side stream: a launch on any other
    stream fails the capture. Replayed, the graph gives the eager rows."""
    data, lens = _rows(4096, 32, 5, cuda_device)
    kinds = [c[1] for c in _CASES]
    for case in (_CASES[0], _CASES[9], _CASES[kinds.index("extract")],
                 _CASES[-1]):
        label, kind, prog, arg = case
        eager = cs.run_regex_case(kind, prog, arg, data, lens, False)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                out = cs.run_regex_case(kind, prog, arg, data, lens, False)
        graph.replay()
        torch.cuda.synchronize()
        for g, e in zip(out, eager):
            assert torch.equal(g, e), label


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(_CASES)), ids=_IDS)
def test_newline_ends_lane_groups_and_long_matches(cuda_device, index):
    for w in (8, 16, 32, 64, 136):
        data, lens = cs.regex_edge_rows(w, w)
        _check(_CASES[index], torch.from_numpy(data).to(cuda_device),
               torch.from_numpy(lens).to(cuda_device))
        _check(_CASES[index], *_rows(3000, w, 7 * w + index, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("index", _NFA_INDEX,
                         ids=[_IDS[i] for i in _NFA_INDEX])
def test_nfa_successor_sets_equal_plain_bit_for_bit(cuda_device, index):
    case = _NFA_CASES[index]
    assert case[2].dfa_states == 0
    _check(case, *_rows(20_000, 32, index, cuda_device))
    for w in (16, 136):
        data, lens = cs.regex_edge_rows(w, w)
        _check(case, torch.from_numpy(data).to(cuda_device),
               torch.from_numpy(lens).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("nfa_sets", [False, True], ids=["dfa", "nfa"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_rows_too_wide_to_stage(cuda_device, case, nfa_sets):
    """Rows of 128 KiB (regex_extract reads them where they lie; a
    thread-a-row regex_replace at any width), against Python's re."""
    from spark_rapids_tpu_torch.expr.regex_kernels import replace_width
    data, lens = wide_rows()
    label, kind, prog, arg = wide_case(case, nfa_sets)
    out_w = replace_width(prog, WIDE) if kind == "replace" else WIDE
    got = cs.run_regex_case(kind, prog, arg,
                            torch.from_numpy(data).to(cuda_device),
                            torch.from_numpy(lens).to(cuda_device), False)
    for g, w_ in zip(got, wide_want(case, data, lens, out_w)):
        assert torch.equal(g.cpu(), w_), label
