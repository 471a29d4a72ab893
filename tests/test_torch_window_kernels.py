"""The window kernels (``spark_rapids_tpu_torch/csrc/window.cu``) and their
plain versions (``exec/window_kernels.py``).

1. The plain versions against the JAX functions they replace, on numpy
   inputs from a seed: ``seg_scan_reference`` against ``_segmented_scan``,
   ``frame_bounds_reference`` against ``_device_bsearch`` and
   ``frame_reduce_reference`` against ``_device_range_minmax``. Integers,
   min/max and bounds are held exactly. A float sum is held against the
   exactly rounded sum of its own values (``math.fsum``): both orders of
   adds are within (len - 1) * u * sum|x| of the exact sum, so the test
   allows 2 * len * u * sum|x| (u = 2^-53, or 2^-24 for float32). The JAX
   functions import inside their tests, which skip where JAX is missing,
   so the file runs on the card's machine, which has no JAX:

       python -m pytest --noconftest -p no:cacheprovider tests/test_torch_window_kernels.py

2. The CUDA source compiled by ``g++`` against a header that emulates what
   it uses (a block as ``std::thread``s, ``__syncthreads`` and each warp's
   shuffles as barriers, shared memory as statics, at most 3 blocks a
   grid-stride loop), held against the plain versions on the smoke run's
   cases (``chip_smoke.py window_scan_cases``, ``window_bounds_cases``,
   ``window_reduce_cases``): segments that start exactly on a tile, span
   many tiles or the whole batch, n not a multiple of the tile, and, with
   the tile cut to 64 rows, more tiles than one pass of the carries
   kernel takes; frames short and long enough to walk every level of the
   block aggregates. A float scan's sums stay within the kernel's
   tree-height bound (``chip_smoke.py _scan_sum_tolerance``) at the
   source's tile, within the bound of any order at the cut tile.

3. The wrappers' CPU path and input checks; on the card (``cuda``), each
   kernel against its plain version on the same cases, float sums the same
   bits over three runs."""
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_tpu_torch.exec import window_kernels as wk

_SRC = Path(__file__).resolve().parents[1] / "spark_rapids_tpu_torch" \
    / "csrc" / "window.cu"
_TORCH = {"int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32, "float64": torch.float64}


def _no_signed_zero_or_nan(rng, n, dtype):
    """Values the JAX ``jnp.minimum``/``maximum`` order agrees with Spark's
    on (no NaN, no -0.0 beside 0.0)."""
    if dtype.startswith("int"):
        return cs._window_values(rng, n, dtype)
    return (rng.standard_normal(n) + 0.5).astype(dtype)


# ---------------------------------------------------------------------------
# 1. the plain versions against the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_seg_scan_reference_equals_jax_segmented_scan(dtype, op):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from spark_rapids_tpu.exec.window import _segmented_scan
    rng = np.random.default_rng(3)
    n = 2 * cs.WINDOW_TILE + 77
    values = _no_signed_zero_or_nan(rng, n, dtype)
    jop = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    scan = jax.jit(lambda v, f: _segmented_scan(v, f, jop))
    for fname, flags in cs._window_flags(rng, n).items():
        want = np.asarray(scan(jnp.asarray(values), jnp.asarray(flags)))
        v, f = torch.from_numpy(values), torch.from_numpy(flags)
        got = wk.seg_scan_reference(v, f, op)
        tol = None
        if op == "add" and dtype.startswith("float"):
            tol = cs._float_sum_tolerance(
                wk.seg_scan_reference(v.abs().double(), f, "add"),
                cs._scan_lengths(f), v.dtype)
        cs._window_equal(f"{dtype} {op} {fname}", got,
                         torch.from_numpy(want), tol)


@pytest.mark.parametrize("strict", [False, True])
def test_frame_bounds_reference_equals_jax_device_bsearch(strict):
    jnp = pytest.importorskip("jax.numpy")
    from spark_rapids_tpu.exec.window import _device_bsearch
    rng = np.random.default_rng(4)
    for label, key, target, lo, hi, st in cs.window_bounds_cases(rng, 3000):
        if st != strict:
            continue
        want = np.asarray(_device_bsearch(
            jnp.asarray(key), jnp.asarray(target), jnp.asarray(lo),
            jnp.asarray(hi), strict))
        got = wk.frame_bounds_reference(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (key, target, lo, hi)), strict)
        assert np.array_equal(got.numpy(), want), label


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_frame_reduce_reference_equals_jax_range_minmax(dtype, op):
    """Min and max exactly (NaN as Spark orders it: a min is NaN only when
    every valid value is), and the count's validity."""
    jnp = pytest.importorskip("jax.numpy")
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.exec.window import _device_range_minmax
    rng = np.random.default_rng(5)
    n = 3000
    for label, values, valid, lo, hi, cop in cs.window_reduce_cases(rng, n):
        if cop != op or values.dtype != np.dtype(dtype):
            continue
        if dtype == "float64":   # NaN kept, signed zeros left out
            values = np.where(values == 0, 0.25, values)
        col = _device_range_minmax(
            op == "min", jnp.asarray(values), jnp.asarray(valid),
            jnp.asarray(lo), jnp.asarray(hi),
            jdt.DOUBLE if dtype == "float64" else jdt.LONG, n)
        has = np.asarray(col.validity)
        want = np.asarray(col.data)
        got, count = wk.frame_reduce_reference(
            *(torch.from_numpy(a) for a in (values, valid, lo, hi)), op)
        assert np.array_equal(count.numpy() > 0, has), label
        g = got.numpy()[has]
        w = want[has]
        assert np.array_equal(g, w, equal_nan=True), label


def test_frame_reduce_reference_sums_are_the_frames_own_values():
    """Float sums against math.fsum of each frame's valid values; frames of
    a large value's neighbour partition keep their own sums (the JAX
    package's prefix differences give 0.0 there)."""
    rng = np.random.default_rng(6)
    for label, values, valid, lo, hi, op in cs.window_reduce_cases(rng,
                                                                    2000):
        if op != "add" or values.dtype != np.float64:
            continue
        values = np.where(np.isfinite(values), values, 1.5)
        got, count = wk.frame_reduce_reference(
            *(torch.from_numpy(a) for a in (values, valid, lo, hi)), "add")
        for i in range(0, 2000, 7):
            frame = values[lo[i]:hi[i]][valid[lo[i]:hi[i]]]
            exact = math.fsum(frame)
            tol = 2 * max(len(frame), 1) * 2.0 ** -53 \
                * math.fsum(np.abs(frame))
            assert abs(float(got[i]) - exact) <= tol, (label, i)
            assert int(count[i]) == len(frame)
    x = torch.tensor([1e20, 1.0, 1.0, 1.0], dtype=torch.float64)
    ok = torch.ones(4, dtype=torch.bool)
    lo = torch.tensor([0, 1, 1, 2])
    hi = torch.tensor([1, 2, 3, 4])
    got, _ = wk.frame_reduce_reference(x, ok, lo, hi, "add")
    assert got.tolist() == [1e20, 1.0, 2.0, 2.0]
    run = wk.seg_scan_reference(x, torch.tensor([True, True, False, False]),
                                "add")
    assert run.tolist() == [1e20, 1.0, 2.0, 3.0]


def test_float_min_max_follow_spark_order():
    """NaN above +inf (min NaN only when all are), -0.0 below 0.0, and a
    NaN result the canonical NaN, in both plain versions."""
    nan_payload = np.array([0x7FF8000000000001], dtype=np.uint64) \
        .view(np.float64)[0]
    x = torch.tensor([np.nan, 1.0, -0.0, 0.0, nan_payload, -np.inf],
                     dtype=torch.float64)
    f = torch.tensor([True, False, True, False, True, True])
    mn = wk.seg_scan_reference(x, f, "min")
    mx = wk.seg_scan_reference(x, f, "max")
    assert np.isnan(mn[0]) and mn[1] == 1.0
    assert mn[3].item() == 0.0 and math.copysign(1, mn[3].item()) == -1
    assert math.copysign(1, mx[3].item()) == 1
    canon = torch.tensor([np.nan], dtype=torch.float64).view(torch.int64)
    assert mn[4:5].view(torch.int64).item() == canon.item()
    assert mn[5].item() == -np.inf and np.isnan(mx[0])
    valid = torch.ones(6, dtype=torch.bool)
    lo, hi = torch.zeros(6, dtype=torch.int64), torch.full((6,), 6)
    rmin, cnt = wk.frame_reduce_reference(x, valid, lo, hi, "min")
    rmax, _ = wk.frame_reduce_reference(x, valid, lo, hi, "max")
    assert (rmin == -np.inf).all() and torch.isnan(rmax).all()
    assert (cnt == 6).all()


# ---------------------------------------------------------------------------
# 2. the CUDA source on the CPU
# ---------------------------------------------------------------------------
_EMULATION = r"""
#pragma once
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(n)
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
struct emu_dim3 { unsigned x = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
namespace emu {
inline std::barrier<>* block_bar = nullptr;
struct Warp { std::barrier<>* bar = nullptr; unsigned long long val[32]; };
inline Warp warps[32];
inline Warp& warp() { return warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }
inline unsigned long long exchange(unsigned long long v, int src) {
  Warp& w = warp();
  w.val[lane()] = v;
  w.bar->arrive_and_wait();
  unsigned long long r = w.val[src];
  w.bar->arrive_and_wait();
  return r;
}
template <class T> unsigned long long bits(T v) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}
template <class T> T from(unsigned long long u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warp().bar->arrive_and_wait(); }
inline long long __double_as_longlong(double x) {
  return emu::from<long long>(emu::bits(x));
}
inline double __longlong_as_double(long long x) {
  return emu::from<double>(emu::bits(x));
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return emu::from<T>(emu::exchange(emu::bits(v), src));
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  int l = emu::lane();
  return emu::from<T>(emu::exchange(emu::bits(v), l >= d ? l - d : l));
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  int l = emu::lane();
  return emu::from<T>(emu::exchange(emu::bits(v), l + d < 32 ? l + d : l));
}
template <class K, class... A>
void emu_launch(K kernel, unsigned grid, unsigned block, A... args) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu::block_bar = &bar;
    std::vector<std::barrier<>*> wb;
    for (unsigned w = 0; w < block / 32; ++w) {
      wb.push_back(new std::barrier<>(32));
      emu::warps[w].bar = wb.back();
    }
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
    for (auto* p : wb) delete p;
  }
}
"""


def _emulated_source(small_tile: bool) -> str:
    """window.cu for g++: the emulation header for the runtime's, every
    ``<<<grid, block, 0, stream>>>`` launch a call, at most 3 blocks a
    grid-stride loop; with ``small_tile`` a tile of one warp x 2 rows, so
    a few thousand rows pass one pass of the carries kernel."""
    src = _SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emul.h"')
    subs = [(r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;")]
    if small_tile:
        subs += [(r"constexpr int kThreads = 256;",
                  "constexpr int kThreads = 32;"),
                 (r"constexpr int kItems = 8;", "constexpr int kItems = 2;")]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    src, n = re.subn(r"(\w+(?:<[\w, ]*>)?)<<<(.*?),\s*(\w+),\s*0,\s*"
                     r"(.*?)>>>\(", r"emu_launch(\1, \2, \3, ", src,
                     flags=re.S)
    assert n == 7, "every launch of window.cu is rewritten"
    return src


class _Model:
    """The emulated library, called like the wrappers on CPU tensors."""

    def __init__(self, lib):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.srt_seg_scan.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
        lib.srt_frame_bounds.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32,
                                         i32, ptr]
        lib.srt_frame_reduce.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                         ptr, ptr, ptr, ptr]
        for fn in (lib.srt_seg_scan_scratch_bytes,
                   lib.srt_frame_reduce_scratch_bytes):
            fn.argtypes = [i64]
            fn.restype = i64
        self.lib = lib

    def seg_scan(self, v, f, op):
        n = v.shape[0]
        out = torch.empty_like(v)
        scratch = torch.empty(self.lib.srt_seg_scan_scratch_bytes(n),
                              dtype=torch.uint8)
        assert self.lib.srt_seg_scan(
            v.data_ptr(), f.data_ptr(), n, wk._SCAN_DTYPES[v.dtype],
            wk.OPS[op], scratch.data_ptr(), out.data_ptr(), None) == 0
        return out

    def frame_bounds(self, key, target, lo, hi, strict):
        n = key.shape[0]
        out = torch.empty(n, dtype=torch.int64)
        assert self.lib.srt_frame_bounds(
            key.data_ptr(), target.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), n, int(key.is_floating_point()), int(strict),
            None) == 0
        return out

    def frame_reduce(self, v, valid, lo, hi, op):
        n = v.shape[0]
        out = torch.empty_like(v)
        count = torch.empty(n, dtype=torch.int64)
        scratch = torch.empty(self.lib.srt_frame_reduce_scratch_bytes(n),
                              dtype=torch.uint8)
        assert self.lib.srt_frame_reduce(
            v.data_ptr(), valid.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
            int(v.is_floating_point()), wk.OPS[op], scratch.data_ptr(),
            out.data_ptr(), count.data_ptr(), None) == 0
        return out, count


def _build(tmp: Path, small_tile: bool) -> _Model:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "window.cpp").write_text(_emulated_source(small_tile))
    so = tmp / "libwindowmodel.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                          "-fPIC", "-o", str(so), str(tmp / "window.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return _Model(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("window_model"), False)


@pytest.fixture(scope="module")
def small_tile_model(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("window_model_small"), True)


def _scan_check(scan, label, values, flags, op, full_tile=True):
    """A float sum within the kernel's tree-height bound
    (``_scan_sum_tolerance``) at the source's tile, else within the bound
    of any order."""
    v = torch.from_numpy(values)
    f = torch.from_numpy(flags)
    want = wk.seg_scan_reference(v, f, op)
    tol = None
    if op == "add" and v.is_floating_point():
        abs_sum = wk.seg_scan_reference(v.abs().double(), f, "add")
        tol = cs._scan_sum_tolerance(abs_sum, f, v.dtype) if full_tile \
            else cs._float_sum_tolerance(abs_sum, cs._scan_lengths(f),
                                         v.dtype)
    cs._window_equal(label, scan(v, f, op), want, tol)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_model_seg_scan_equals_plain(model, dtype):
    """Two tiles and 77 rows, every op and flag pattern."""
    rng = np.random.default_rng(7)
    for label, values, flags, op in cs.window_scan_cases(
            rng, 2 * cs.WINDOW_TILE + 77):
        if values.dtype == np.dtype(dtype):
            _scan_check(model.seg_scan, label, values, flags, op)


def test_model_seg_scan_carries_past_one_pass(small_tile_model):
    """Tiles of 64 rows: 71 tiles pass the carries kernel's 64 a pass, so
    the carry crosses between its passes."""
    rng = np.random.default_rng(8)
    for label, values, flags, op in cs.window_scan_cases(
            rng, 64 * 70 + 33, flag_sets=("random", "one segment")):
        if values.dtype in (np.int64, np.float64) and op != "min":
            _scan_check(small_tile_model.seg_scan, label, values, flags, op,
                        full_tile=False)


def test_model_frame_bounds_equals_plain(model):
    rng = np.random.default_rng(9)
    for label, key, target, lo, hi, strict in cs.window_bounds_cases(
            rng, 3000):
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (key, target, lo, hi)]
        cs._window_equal(label, model.frame_bounds(*args, strict),
                         wk.frame_bounds_reference(*args, strict))


def _reduce_check(label, values, valid, lo, hi, op, model):
    v, ok, tlo, thi = (torch.from_numpy(a) for a in (values, valid, lo, hi))
    want, wcount = wk.frame_reduce_reference(v, ok, tlo, thi, op)
    got, count = model.frame_reduce(v, ok, tlo, thi, op)
    cs._window_equal(f"{label} counts", count, wcount)
    tol = None
    if op == "add" and v.is_floating_point():
        tol = cs._float_sum_tolerance(
            wk.frame_reduce_reference(v.abs(), ok, tlo, thi, "add")[0],
            thi - tlo, v.dtype)
    cs._window_equal(label, got, want, tol)


@pytest.mark.parametrize("frames", ["short", "long"])
def test_model_frame_reduce_equals_plain(model, frames):
    """Short frames (ROWS -3..1, the running frame) at 3000 rows; frames up
    to 50,000 rows either side at 40,000 rows, which walk the 32-, 1024-
    and 32768-row block aggregates up and down."""
    rng = np.random.default_rng(10)
    n = 3000 if frames == "short" else 40_000
    names = ("rows -3..1", "running") if frames == "short" \
        else ("random long",)
    for label, *args in cs.window_reduce_cases(rng, n):
        if any(label.endswith(name) for name in names):
            if frames == "long" and label.startswith("int64 add"):
                continue   # the int64 long add is the same walk as float's
            _reduce_check(label, *args, model)


# ---------------------------------------------------------------------------
# 3. the wrappers
# ---------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(11)
    for label, values, flags, op in cs.window_scan_cases(
            rng, 1000, flag_sets=("random",)):
        v, f = torch.from_numpy(values), torch.from_numpy(flags)
        cs._window_equal(label, wk.seg_scan(v, f, op),
                         wk.seg_scan_reference(v, f, op))
    _, key, target, lo, hi, strict = cs.window_bounds_cases(rng, 500)[0]
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (key, target, lo, hi)]
    assert torch.equal(wk.frame_bounds(*args, strict),
                       wk.frame_bounds_reference(*args, strict))
    _, values, valid, lo, hi, op = cs.window_reduce_cases(rng, 500)[0]
    a = [torch.from_numpy(x) for x in (values, valid, lo, hi)]
    for got, want in zip(wk.frame_reduce(*a, op),
                         wk.frame_reduce_reference(*a, op)):
        assert torch.equal(got, want)
    for fn in (wk.seg_scan, wk.frame_bounds, wk.frame_reduce):
        assert fn.launches == 0
        assert fn.launch_rows == set()


def test_wrappers_check_their_inputs():
    v = torch.zeros(8, dtype=torch.int64)
    f = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        wk.seg_scan(v.to(torch.int16), f, "add")
    with pytest.raises(TypeError):
        wk.seg_scan(torch.zeros(16, dtype=torch.int64)[::2], f, "add")
    with pytest.raises(ValueError):
        wk.seg_scan(v, f[:4], "add")
    with pytest.raises(ValueError):
        wk.seg_scan(v, f, "mul")
    with pytest.raises(TypeError):
        wk.frame_bounds(v, v.double(), v, v, False)
    with pytest.raises(TypeError):
        wk.frame_reduce(v.to(torch.float32), f, v, v, "add")
    with pytest.raises(TypeError):
        wk.frame_reduce(v, f.to(torch.uint8), v, v, "add")
    with pytest.raises(TypeError):
        wk.seg_scan(torch.zeros((4, 2), dtype=torch.int64), f, "add")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


_CARD_N = (1 << 16) + 123


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["seg_scan", "frame_bounds",
                                  "frame_reduce"])
def test_kernels_equal_plain_on_the_card(cuda_device, kind):
    rng = np.random.default_rng(13)
    fn = getattr(wk, kind)
    before = fn.launches
    if kind == "seg_scan":
        for label, values, flags, op in cs.window_scan_cases(rng, _CARD_N):
            cs.check_window_scan(label, values, flags, op, cuda_device, 3)
    elif kind == "frame_bounds":
        for label, *args in cs.window_bounds_cases(rng, _CARD_N):
            cs.check_window_bounds(label, *args, cuda_device)
    else:
        for label, *args in cs.window_reduce_cases(rng, _CARD_N):
            cs.check_window_reduce(label, *args, cuda_device, 3)
    torch.cuda.synchronize()
    assert fn.launches > before
    assert _CARD_N in fn.launch_rows
