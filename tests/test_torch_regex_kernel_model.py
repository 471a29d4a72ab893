"""``csrc/regex.cu`` on the CPU: the CUDA source compiled by ``g++``
against the runtime emulation of ``test_torch_shuffle_kernel_model.py``
(a block's threads as fibers; each launch a call, 3 blocks a grid-stride
loop, so every thread walks many rows) and the vector types of
``test_torch_strings_kernel_model.py``, every 16- and 8-byte access
checked for alignment. ``regex_replace``, ``regex_extract`` and
``delim_select`` are held bit for bit against their plain versions
(``regex_replace_reference``, ``regex_extract_reference``,
``delim_select_reference``), which ``test_torch_regex_spans.py`` holds
against the JAX package, on every case of ``chip_smoke.py``
(``REGEX_REPLACE_CASES``, ``REGEX_EXTRACT_CASES``, ``DELIM_CASES``):
10^4 random rows of width 32, edge rows at widths 8, 16, 64 and 136 (rows
of length 0 and filling their width, matches reaching the width, random
bytes past each length), replace outputs that clip at 8 and 12 bytes (the
byte-store path), a broadcast row and a view one byte into 48-byte rows.
The kernels themselves cannot run here; this is the nearest check.
Tolerance: exact."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_shuffle_kernel_model import _EMULATION
from test_torch_strings_kernel_model import _INTRINSICS

_SRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc" / "regex.cu"


def _emulated_source() -> str:
    """regex.cu for g++: the emulation for the runtime, every launch a
    call, 3 blocks a grid, each vector access checked for alignment, the
    dynamic shared memory the blocks' common static storage."""
    src = _SRC.read_text().replace("#include <cuda_runtime.h>",
                                   '#include "strings_emul.h"')
    subs = [(r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;", 1),
            (r"\*reinterpret_cast<const uint4\*>\(a\)",
             "*emu_aligned<const uint4>(reinterpret_cast<const void*>(a))", 1),
            (r"\*reinterpret_cast<(uint[24])\*>\(", r"*emu_aligned<\1>(", 2),
            (r"extern __shared__ uint32_t (\w+)\[\];",
             r"static uint32_t \1[1 << 16];", 2)]
    for pat, rep, count in subs:
        src, n = re.subn(pat, rep, src)
        assert n == count, pat
    src, n = re.subn(r"([\w]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*(.*?),"
                     r"\s*(.*?)>>>\(", r"emu_launch(\1, \2, \3, ", src,
                     flags=re.S)
    assert n == 3, "every launch of regex.cu is rewritten"
    return src


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops (the plain versions) on one thread: the tests run in
    several worker processes at once, and a thread pool each
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    tmp = tmp_path_factory.mktemp("regex_model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "strings_emul.h").write_text(_INTRINSICS)
    (tmp / "regex.cpp").write_text(_emulated_source())
    so = tmp / "libregexmodel.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                          "-fno-gnu-unique", "-fno-strict-aliasing", "-w",
                          "-fPIC", "-o", str(so), str(tmp / "regex.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    for fn in (lib.srt_regex_replace, lib.srt_regex_extract):
        fn.argtypes = [ptr, i64, i32, ptr, i64, ptr, i32, i32, ptr, ptr, ptr]
    lib.srt_delim_select.argtypes = [ptr, i64, i32, ptr, i64, ptr, i32, i32,
                                     ptr, ptr]
    lib.emu_launches.restype = i64
    lib.emu_misaligned.restype = i64
    return lib


@pytest.fixture(scope="module")
def cases():
    return cs.regex_case_programs()


def _model(lib, kind: str, prog, arg, data: torch.Tensor,
           lens: torch.Tensor, out_w=None) -> tuple:
    """One case through the CUDA source: the wrapper's arguments, by hand."""
    from spark_rapids_tpu_torch.expr.regex_kernels import replace_width
    n, width = data.shape
    before = lib.emu_launches()
    if kind == "delim":
        d = torch.from_numpy(np.frombuffer(prog, np.uint8).copy())
        cut = torch.full((n,), -7, dtype=torch.int32)
        assert lib.srt_delim_select(data.data_ptr(), data.stride(0), width,
                                    lens.data_ptr(), n, d.data_ptr(),
                                    len(prog), arg, cut.data_ptr(),
                                    None) == 0
        out = (cut,)
    else:
        words = torch.from_numpy(prog.words.view(np.int32).copy())
        w = width if kind == "extract" else (
            out_w or replace_width(prog, width))
        buf = torch.full((n * w + 16,), 0xA5, dtype=torch.uint8)
        off = (-buf.data_ptr()) % 16 if w % 8 == 0 else 1
        res = buf[off:off + n * w].view(n, w)
        out_len = torch.full((n,), -7, dtype=torch.int32)
        fn = lib.srt_regex_replace if kind == "replace" \
            else lib.srt_regex_extract
        assert fn(data.data_ptr(), data.stride(0), width, lens.data_ptr(), n,
                  words.data_ptr(), words.numel(),
                  w if kind == "replace" else arg, res.data_ptr(),
                  out_len.data_ptr(), None) == 0
        out = (res, out_len)
    assert lib.emu_launches() == before + (1 if n else 0)
    assert lib.emu_misaligned() == 0
    return out


def _check(lib, case, data, lens, out_w=None) -> None:
    label, kind, prog, arg = case
    got = _model(lib, kind, prog, arg, data, lens, out_w)
    want = cs.run_regex_case(kind, prog, arg, data, lens, plain=True,
                             out_w=out_w)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_), label


def _tensors(data: np.ndarray, lens: np.ndarray):
    return torch.from_numpy(data), torch.from_numpy(lens)


_CASE_IDS = [c[0] for c in cs.regex_case_programs()]


@pytest.mark.parametrize("index", range(len(_CASE_IDS)), ids=_CASE_IDS)
def test_source_equals_the_plain_version(lib, cases, index):
    """10^4 random rows of width 32, and 300 edge rows at widths 8, 16, 64
    and 136."""
    case = cases[index]
    _check(lib, case, *_tensors(*cs.regex_rows(10_000, 32, index)))
    for w in (8, 16, 64, 136):
        _check(lib, case, *_tensors(*cs.regex_rows(300, w, 100 + w)))


@pytest.mark.parametrize("index", [i for i, c in enumerate(_CASE_IDS)
                                   if c.startswith("replace")],
                         ids=[c for c in _CASE_IDS if c.startswith("replace")])
@pytest.mark.parametrize("out_w", [8, 12])
def test_replace_clips_where_the_output_is_narrow(lib, cases, index, out_w):
    """Outputs narrower than the rows: every byte at or past out_w - 1
    lands on out_w - 1 and the length counts them all (12 bytes: the
    byte-store path)."""
    _check(lib, cases[index], *_tensors(*cs.regex_rows(2000, 16, index)),
           out_w=out_w)


@pytest.mark.parametrize("index", range(len(_CASE_IDS)), ids=_CASE_IDS)
def test_broadcast_rows_views_and_no_rows(lib, cases, index):
    case = cases[index]
    row, ln = _tensors(*cs.regex_rows(1, 32, 3))
    row[0, :19] = torch.frombuffer(bytearray(b"ab-12 the aa,lyx-7"
                                             b"9"), dtype=torch.uint8)
    ln[0] = 19
    _check(lib, case, row.expand(500, -1), ln.expand(500).contiguous())
    big, blen = _tensors(*cs.regex_rows(1000, 48, 7))
    _check(lib, case, big[:, 1:33], (blen - 1).clamp(0, 32))
    _check(lib, case, big[:0], blen[:0])
