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
16-byte alignment; each wrapper is also captured in a CUDA graph on a
side stream, which fails if it launches on any other stream."""
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
    for case in (_CASES[0], _CASES[9], _CASES[15], _CASES[-1]):
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
