"""The window kernels (``spark_rapids_tpu_torch/csrc/window.cu``) and their
plain versions (``exec/window_kernels.py``).

1. The plain versions against the JAX functions they replace, on numpy
   inputs from a seed: ``seg_scan_reference`` against ``_segmented_scan``
   (in reverse, against it on the rows flipped), the reverse scan's
   segment and peer-group ends against ``_seg_len`` and the reverse
   ``associative_scan`` of the RANGE running frame,
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
   it uses (a block's threads as fibers on one OS thread, each running
   until it waits at a barrier; ``__syncthreads`` and each warp's
   shuffles and ballots as barriers, shared memory as statics, atomics,
   fences, volatile loads and memsets as their C++ counterparts, at most 3
   blocks a grid-stride loop; a grid's blocks one after another, the last
   ``blockIdx`` first, so a scan is right only if its tiles come from its
   counter), held against the plain versions on the smoke run's cases
   (``chip_smoke.py window_scan_cases``, ``window_reverse_cases``,
   ``window_bounds_cases``, ``window_reduce_cases``): segments that start
   exactly on a tile, span many tiles or the whole batch, n not a multiple
   of the tile, and, with the tile cut to 64 rows, look-backs that climb
   two and three levels; with the look-back's status reads reporting "not
   yet published" at random (seeded), float sums the same bits whatever
   the schedule; frames short (without the block aggregates, and with
   them) and long enough to walk every level of the aggregates; one
   launch and one memset a scan. A float scan's sums stay within the
   kernel's tree-height bound (``chip_smoke.py _scan_sum_tolerance``) at
   the source's tile, within the bound of any order at the cut tile.

3. The wrappers' CPU path and input checks; on the card (``cuda``), each
   kernel against its plain version on the same cases (the scan forward
   and in reverse), float sums the same bits over three runs."""
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
    _reference_against_jax_scan(dtype, op, False)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reverse_seg_scan_reference_equals_jax_scan_flipped(dtype, op):
    """In reverse the scan is the forward one of the rows and flags
    flipped, flipped back: a flag restarts it at its row going
    backwards."""
    _reference_against_jax_scan(dtype, op, True)


def _reference_against_jax_scan(dtype, op, reverse):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from spark_rapids_tpu.exec.window import _segmented_scan
    rng = np.random.default_rng(3)
    n = 2 * cs.WINDOW_TILE + 77
    values = _no_signed_zero_or_nan(rng, n, dtype)
    jop = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    scan = jax.jit(lambda v, f: _segmented_scan(v, f, jop))
    for fname, flags in cs._window_flags(rng, n).items():
        if reverse:
            want = np.asarray(scan(jnp.asarray(values[::-1].copy()),
                                   jnp.asarray(flags[::-1].copy())))[::-1]
        else:
            want = np.asarray(scan(jnp.asarray(values), jnp.asarray(flags)))
        v, f = torch.from_numpy(values), torch.from_numpy(flags)
        got = wk.seg_scan_reference(v, f, op, reverse)
        tol = None
        if op == "add" and dtype.startswith("float"):
            lengths = cs._scan_lengths(f.flip(0)).flip(0) if reverse \
                else cs._scan_lengths(f)
            tol = cs._float_sum_tolerance(
                wk.seg_scan_reference(v.abs().double(), f, "add", reverse),
                lengths, v.dtype)
        cs._window_equal(f"{dtype} {op} {fname}", got,
                         torch.from_numpy(want.copy()), tol)


@pytest.mark.parametrize("flag_set", ["random", "dense", "tile edges",
                                      "one segment"])
def test_reverse_scan_gives_jax_segment_and_peer_ends(flag_set):
    """``_next_start`` (a reverse ``seg_scan`` min, one segment) against
    the JAX ``_seg_len`` for segment ends, and against the reverse
    ``associative_scan`` of ``jnp.minimum`` that the JAX package's RANGE
    running frame takes for its peer-group end
    (``spark_rapids_tpu/exec/window.py:341``), exactly."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from spark_rapids_tpu.exec.window import _seg_len
    from spark_rapids_tpu_torch.exec.window import _next_start
    rng = np.random.default_rng(14)
    n = 2 * cs.WINDOW_TILE + 77
    flags = cs._window_flags(rng, n)[flag_set].copy()
    flags[0] = True
    peers = flags | (rng.random(n) < 0.3)
    pos = np.arange(n, dtype=np.int64)
    seg_start = np.maximum.accumulate(np.where(flags, pos, 0))
    seg_len = np.asarray(_seg_len(jnp.asarray(flags), jnp.asarray(seg_start),
                                  jnp.asarray(pos), n))
    end = _next_start(torch.from_numpy(flags), torch.from_numpy(pos))
    assert np.array_equal(end.numpy() - seg_start, seg_len)
    nxt = jnp.where(jnp.asarray(peers), jnp.asarray(pos), n)
    rev_min = jnp.flip(jax.lax.associative_scan(jnp.minimum, jnp.flip(nxt)))
    after = jnp.concatenate([rev_min[1:], jnp.asarray([n], rev_min.dtype)])
    want = np.minimum(np.asarray(after), seg_start + seg_len)
    got = torch.minimum(_next_start(torch.from_numpy(peers),
                                    torch.from_numpy(pos)), end)
    assert np.array_equal(got.numpy(), want)


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
    for label, values, valid, lo, hi, cop, _ in cs.window_reduce_cases(rng,
                                                                       n):
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
    for label, values, valid, lo, hi, op, _ in cs.window_reduce_cases(
            rng, 2000):
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
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
struct emu_dim3 { unsigned x = 0; };
struct uint4 { unsigned x, y, z, w; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };
inline ulonglong2 make_ulonglong2(unsigned long long x,
                                  unsigned long long y) {
  return {x, y};
}
// set by the scheduler each time it resumes a thread of the block
inline emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
#if defined(__x86_64__)
// saves the callee-saved registers on this stack, stores its top in
// *save_sp, and resumes the stack at load_sp
extern "C" void emu_switch(void** save_sp, void* load_sp);
asm(".text\n.globl emu_switch\n.hidden emu_switch\n"
    ".type emu_switch,@function\nemu_switch:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n"
    "  pushq %r14\n  pushq %r15\n  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n"
    "  popq %rbp\n  ret\n.size emu_switch, .-emu_switch\n");
#else
#error "the fibers switch stacks on x86-64 only"
#endif
namespace emu {
// A block's threads as fibers on one OS thread: each runs until it waits
// at a barrier; the last to arrive releases the others and runs on.
struct Sched {
  void* main_sp = nullptr;
  std::vector<void*> sp;
  std::vector<std::unique_ptr<char[]>> stacks;
  std::vector<int> ready;
  int current = -1;
  std::function<void()> body;
};
inline Sched sched;
inline void to_scheduler() {
  emu_switch(&sched.sp[sched.current], sched.main_sp);
}
struct Barrier {
  int expected = 0, arrived = 0;
  std::vector<int> parked;
};
inline void wait(Barrier& b) {
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    for (int f : b.parked) sched.ready.push_back(f);
    b.parked.clear();
    return;
  }
  b.parked.push_back(sched.current);
  to_scheduler();
}
inline Barrier block_bar;
struct Warp { Barrier bar; unsigned long long val[32]; };
inline Warp warps[32];
inline Warp& warp() { return warps[threadIdx.x / 32]; }
inline int lane() { return threadIdx.x % 32; }
inline unsigned long long exchange(unsigned long long v, int src) {
  Warp& w = warp();
  w.val[lane()] = v;
  wait(w.bar);
  unsigned long long r = w.val[src];
  wait(w.bar);
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
inline std::atomic<long long> launches{0}, memsets{0};
// a status word read as "not yet published" at random, permille of reads
inline std::atomic<unsigned long long> flaky_reads{0};
inline unsigned long long flaky_seed = 0;
inline unsigned flaky_permille = 0;
// a look-back slot read as not yet published (status 0)
inline ulonglong2 flaky(ulonglong2 w) {
  if (flaky_permille == 0) return w;
  unsigned long long z = flaky_seed + 0x9E3779B97F4A7C15ULL * ++flaky_reads;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  z ^= z >> 31;
  if (z % 1000 < flaky_permille) w.x = 0;
  return w;
}
}  // namespace emu
extern "C" long long emu_launches() { return emu::launches; }
extern "C" long long emu_memsets() { return emu::memsets; }
extern "C" void emu_set_flaky(unsigned long long seed, unsigned permille) {
  emu::flaky_seed = seed;
  emu::flaky_permille = permille;
}
inline void __syncthreads() { emu::wait(emu::block_bar); }
inline void __syncwarp() { emu::wait(emu::warp().bar); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T> T __ldcg(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}
inline ulonglong2 __ldcv(const ulonglong2* p) {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  ulonglong2 w;
  std::memcpy(&w, p, sizeof w);
  return w;
}
inline void __stcg(ulonglong2* p, ulonglong2 w) {
  std::memcpy(p, &w, sizeof w);
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline unsigned __float_as_uint(float x) {
  return emu::from<unsigned>(emu::bits(x));
}
inline float __uint_as_float(unsigned x) {
  return emu::from<float>(emu::bits(x));
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  ++emu::memsets;
  std::memset(p, v, n);
  return 0;
}
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
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::Warp& w = emu::warp();
  w.val[emu::lane()] = pred != 0;
  emu::wait(w.bar);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(w.val[i]) << i;
  emu::wait(w.bar);
  return r;
}
// the grid's blocks one after another, the last blockIdx first: a fiber a
// block's thread, each running its part of every block in turn
namespace emu {
inline unsigned ended = 0;
[[noreturn]] inline void fiber_main() {
  sched.body();
  ++ended;
  to_scheduler();
  __builtin_unreachable();
}
}  // namespace emu
template <class K, class... A>
void emu_launch(K kernel, unsigned grid, unsigned block, A... args) {
  using namespace emu;
  ++launches;
  gridDim.x = grid;
  blockDim.x = block;
  block_bar = Barrier{static_cast<int>(block)};
  for (unsigned w = 0; w < block / 32; ++w) warps[w].bar = Barrier{32};
  sched.body = [=] {
    for (unsigned b = grid; b-- > 0;) {
      blockIdx.x = b;
      kernel(args...);
      wait(block_bar);  // the block ends before the next begins
    }
  };
  constexpr size_t kStack = 1 << 18;
  while (sched.stacks.size() < block)
    sched.stacks.emplace_back(new char[kStack]);
  sched.sp.assign(block, nullptr);
  sched.ready.clear();
  for (unsigned t = 0; t < block; ++t) {
    // a fresh stack that "returns" into fiber_main with the registers 0
    uintptr_t top = reinterpret_cast<uintptr_t>(sched.stacks[t].get()) +
                    kStack;
    auto* p = reinterpret_cast<uintptr_t*>(top & ~uintptr_t{15});
    *--p = 0;
    *--p = reinterpret_cast<uintptr_t>(&fiber_main);
    for (int r = 0; r < 6; ++r) *--p = 0;
    sched.sp[t] = p;
    sched.ready.push_back(t);
  }
  ended = 0;
  // a queue: a fiber runs until it waits at a barrier (parked there until
  // the last arrives, who queues it again) or ends
  for (size_t i = 0; i < sched.ready.size(); ++i) {
    const int t = sched.ready[i];
    sched.current = t;
    threadIdx.x = t;
    emu_switch(&sched.main_sp, sched.sp[t]);
  }
  if (ended != block) {
    std::fprintf(stderr, "emu_launch: %u of %u threads wait forever\n",
                 block - ended, block);
    std::abort();
  }
}
"""

_SLOT_LOAD = "return __ldcv(p);"


def _emulated_source(small_tile: bool) -> str:
    """window.cu for g++: the emulation header for the runtime's, every
    ``<<<grid, block, 0, stream>>>`` launch a call, at most 3 blocks a
    grid-stride loop, each slot of the look-back read through
    ``emu::flaky``; with ``small_tile`` a tile of two warps x 1 row, so a
    few thousand rows make the look-back climb a level (the two warps poll
    levels 0 and 1 together) and 70,000 two (level 2 falls to the first
    warp again)."""
    src = _SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emul.h"')
    subs = [(r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;"),
            (re.escape(_SLOT_LOAD), "return emu::flaky(__ldcv(p));")]
    if small_tile:
        subs += [(r"constexpr int kThreads = 256;",
                  "constexpr int kThreads = 64;"),
                 (r"constexpr int kItems = 16;",
                  "constexpr int kItems = 1;")]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    src, n = re.subn(r"(\w+(?:<[\w, ]*>)?)<<<(.*?),\s*(\w+),\s*0,\s*"
                     r"(.*?)>>>\(", r"emu_launch(\1, \2, \3, ", src,
                     flags=re.S)
    # seg_scan one, frame_bounds two, frame_reduce's levels and frames
    assert n == 5, "every launch of window.cu is rewritten"
    return src


class _Model:
    """The emulated library, called like the wrappers on CPU tensors."""

    def __init__(self, lib):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.srt_seg_scan.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr, ptr,
                                     ptr]
        lib.srt_frame_bounds.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32,
                                         i32, ptr]
        lib.srt_frame_reduce.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                         i64, ptr, ptr, ptr, ptr]
        lib.srt_seg_scan_scratch_bytes.argtypes = [i64]
        lib.srt_frame_reduce_scratch_bytes.argtypes = [i64, i64]
        for fn in (lib.srt_seg_scan_scratch_bytes,
                   lib.srt_frame_reduce_scratch_bytes, lib.emu_launches,
                   lib.emu_memsets):
            fn.restype = i64
        lib.emu_set_flaky.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
        self.lib = lib

    def counts(self) -> tuple:
        """(kernel launches, memsets) so far."""
        return self.lib.emu_launches(), self.lib.emu_memsets()

    def flaky(self, seed: int, permille: int) -> None:
        """From now on ``permille`` of the look-back's status reads report
        "not yet published" (0: none)."""
        self.lib.emu_set_flaky(seed, permille)

    def seg_scan(self, v, f, op, reverse=False):
        n = v.shape[0]
        out = torch.empty_like(v)
        scratch = torch.empty(self.lib.srt_seg_scan_scratch_bytes(n),
                              dtype=torch.uint8)
        assert self.lib.srt_seg_scan(
            v.data_ptr(), None if f is None else f.data_ptr(), n,
            wk._SCAN_DTYPES[v.dtype], wk.OPS[op], int(reverse),
            scratch.data_ptr(), out.data_ptr(), None) == 0
        return out

    def frame_bounds(self, key, target, lo, hi, strict):
        n = key.shape[0]
        out = torch.empty(n, dtype=torch.int64)
        assert self.lib.srt_frame_bounds(
            key.data_ptr(), target.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), n, int(key.is_floating_point()), int(strict),
            None) == 0
        return out

    def frame_reduce(self, v, valid, lo, hi, op, max_len=None):
        n = v.shape[0]
        limit = -1 if max_len is None else max_len
        out = torch.empty_like(v)
        count = torch.empty(n, dtype=torch.int64)
        scratch = torch.empty(
            self.lib.srt_frame_reduce_scratch_bytes(n, limit),
            dtype=torch.uint8)
        assert self.lib.srt_frame_reduce(
            v.data_ptr(), valid.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
            int(v.is_floating_point()), wk.OPS[op], limit,
            scratch.data_ptr(), out.data_ptr(), count.data_ptr(), None) == 0
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


def _scan_check(scan, label, values, flags, op, full_tile=True,
                reverse=False):
    """A float sum within the kernel's tree-height bound
    (``_scan_sum_tolerance``) at the source's tile, else within the bound
    of any order; ``flags`` None: one segment."""
    v = torch.from_numpy(values)
    f = None if flags is None else torch.from_numpy(flags)
    want = wk.seg_scan_reference(v, f, op, reverse)
    tol = None
    if op == "add" and v.is_floating_point():
        abs_sum = wk.seg_scan_reference(v.abs().double(), f, "add", reverse)
        if full_tile:
            tol = cs._scan_sum_tolerance(abs_sum, f, v.dtype, reverse)
        else:
            ff = torch.zeros(len(v), dtype=torch.bool) if f is None else f
            lengths = cs._scan_lengths(ff.flip(0)).flip(0) if reverse \
                else cs._scan_lengths(ff)
            tol = cs._float_sum_tolerance(abs_sum, lengths, v.dtype)
    got = scan(v, f, op, reverse)
    cs._window_equal(label, got, want, tol)
    return got


_DTYPES = ("int32", "int64", "float32", "float64")


@pytest.mark.parametrize(
    "dtype,reverse", [(d, r) for r in (False, True) for d in _DTYPES],
    ids=[d + (" reverse" if r else "") for r in (False, True)
         for d in _DTYPES])
def test_model_seg_scan_equals_plain(model, dtype, reverse):
    """Two tiles and 77 rows, every op; forward every flag pattern, in
    reverse random flags, none, and the next segment starts
    (``window_reverse_cases``)."""
    rng = np.random.default_rng(7)
    n = 2 * cs.WINDOW_TILE + 77
    cases = cs.window_reverse_cases(rng, n) if reverse \
        else cs.window_scan_cases(rng, n)
    for label, values, flags, op in cases:
        if values.dtype == np.dtype(dtype):
            _scan_check(model.seg_scan, label, values, flags, op,
                        reverse=reverse)


def test_model_seg_scan_carries_past_one_pass(small_tile_model):
    """Tiles of 64 rows: 71 tiles, so a tile's carry-in climbs to the
    second level of the look-back (the pairs of 32 tiles), forward and in
    reverse."""
    rng = np.random.default_rng(8)
    for label, values, flags, op in cs.window_scan_cases(
            rng, 64 * 70 + 33, flag_sets=("random", "one segment")):
        if values.dtype in (np.int64, np.float64) and op != "min":
            for reverse in (False, True):
                _scan_check(small_tile_model.seg_scan, label, values, flags,
                            op, full_tile=False, reverse=reverse)


def test_model_seg_scan_climbs_three_levels(small_tile_model):
    """1101 tiles of 64 rows: the look-back reads tiles' pairs, pairs of 32
    tiles and pairs of 1024, forward and in reverse, over sparse flags and
    over one segment."""
    rng = np.random.default_rng(15)
    n = 64 * 1100 + 5
    flags = rng.random(n) < 0.0005
    x = cs._window_values(rng, n, "float64", finite=True)
    i = cs._window_values(rng, n, "int64")
    for label, values, f, op, reverse in (
            ("float64 add, sparse flags", x, flags, "add", False),
            ("float64 add, no flags, reverse", x, None, "add", True),
            ("int64 max, sparse flags", i, flags, "max", False)):
        _scan_check(small_tile_model.seg_scan, label, values, f, op,
                    full_tile=False, reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_model_seg_scan_same_bits_when_the_look_back_waits(small_tile_model,
                                                           reverse):
    """101 tiles of 64 rows, float sums: with half the look-back's slot
    reads reporting "not yet published" (two seeds), each tile waits
    through other orders of arrival, and its carry-in keeps the bits of
    the run where every read sees the slot."""
    rng = np.random.default_rng(16)
    n = 64 * 100 + 7
    flags = rng.random(n) < 0.002
    cases = [(f"{dtype} add, {fname}",
              cs._window_values(rng, n, dtype, finite=True), f, "add")
             for dtype in ("float32", "float64")
             for fname, f in (("random flags", flags), ("no flags", None))]
    try:
        for label, values, flags, op in cases:
            small_tile_model.flaky(0, 0)
            want = _scan_check(small_tile_model.seg_scan, label, values,
                               flags, op, full_tile=False, reverse=reverse)
            for seed in (1, 2):
                small_tile_model.flaky(seed, 500)
                got = _scan_check(small_tile_model.seg_scan,
                                  f"{label}, seed {seed}", values, flags, op,
                                  full_tile=False, reverse=reverse)
                cs._window_equal(f"{label}, seed {seed}: the same bits", got,
                                 want)
    finally:
        small_tile_model.flaky(0, 0)


@pytest.mark.parametrize("call", ["seg_scan", "seg_scan reverse",
                                  "frame_reduce short", "frame_reduce"])
def test_model_launches_a_call(model, call):
    """A scan is one memset and one launch, either way; ``frame_reduce`` one
    launch where no frame is longer than 64 rows by the caller's word,
    else a memset and two launches (the block aggregates, the frames)."""
    rng = np.random.default_rng(17)
    n = 3 * cs.WINDOW_TILE + 5
    v = torch.from_numpy(rng.standard_normal(n))
    f = torch.from_numpy(rng.random(n) < 0.01)
    lo = torch.clamp(torch.arange(n) - 3, min=0)
    hi = torch.clamp(torch.arange(n) + 2, max=n)
    ok = torch.ones(n, dtype=torch.bool)
    before = model.counts()
    if call.startswith("seg_scan"):
        model.seg_scan(v, f, "add", call.endswith("reverse"))
        want = (1, 1)
    else:
        model.frame_reduce(v, ok, lo, hi, "add",
                           5 if call.endswith("short") else None)
        want = (1, 0) if call.endswith("short") else (2, 1)
    after = model.counts()
    assert (after[0] - before[0], after[1] - before[1]) == want


def test_model_frame_bounds_equals_plain(model):
    rng = np.random.default_rng(9)
    for label, key, target, lo, hi, strict in cs.window_bounds_cases(
            rng, 3000):
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (key, target, lo, hi)]
        cs._window_equal(label, model.frame_bounds(*args, strict),
                         wk.frame_bounds_reference(*args, strict))


def _reduce_check(label, values, valid, lo, hi, op, max_len, model):
    """Against the plain version; a float sum the same bits over three
    runs."""
    v, ok, tlo, thi = (torch.from_numpy(a) for a in (values, valid, lo, hi))
    want, wcount = wk.frame_reduce_reference(v, ok, tlo, thi, op)
    got, count = model.frame_reduce(v, ok, tlo, thi, op, max_len)
    cs._window_equal(f"{label} counts", count, wcount)
    tol = None
    if op == "add" and v.is_floating_point():
        for _ in range(2):
            cs._window_equal(f"{label} (repeat)", model.frame_reduce(
                v, ok, tlo, thi, op, max_len)[0], got)
        tol = cs._float_sum_tolerance(
            wk.frame_reduce_reference(v.abs(), ok, tlo, thi, "add")[0],
            thi - tlo, v.dtype)
    cs._window_equal(label, got, want, tol)


@pytest.mark.parametrize("frames", ["short", "short, with the aggregates",
                                    "long", "long, read row by row"])
def test_model_frame_reduce_equals_plain(model, frames):
    """Short frames (ROWS -3..1 and -2..0 with their lengths given, so no
    block aggregates; then the same without, and the running frame) at
    3000 rows; frames up to 50,000 rows either side at 40,000 rows, which
    walk the 32-, 1024- and 32768-row block aggregates up and down (the
    32768-row ones built by the last of four blocks); the running frames
    with a length of 64 given, though longer: read row by row, still
    right."""
    rng = np.random.default_rng(10)
    n = 40_000 if frames == "long" else 3000
    names = {"short": ("rows -3..1", "rows -2..0"),
             "short, with the aggregates": ("rows -3..1", "running"),
             "long": ("random long",),
             "long, read row by row": ("running",)}[frames]
    for label, *args, max_len in cs.window_reduce_cases(rng, n):
        if any(label.endswith(name) for name in names):
            if frames == "long" and label.startswith("int64 add"):
                continue   # the int64 long add is the same walk as float's
            if frames == "short, with the aggregates":
                max_len = None
            elif frames == "long, read row by row":
                max_len = 64
            _reduce_check(label, *args, max_len, model)


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
    for label, values, flags, op in cs.window_reverse_cases(rng, 1000):
        v = torch.from_numpy(values)
        f = None if flags is None else torch.from_numpy(flags)
        cs._window_equal(label, wk.seg_scan(v, f, op, reverse=True),
                         wk.seg_scan_reference(v, f, op, reverse=True))
    _, key, target, lo, hi, strict = cs.window_bounds_cases(rng, 500)[0]
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (key, target, lo, hi)]
    assert torch.equal(wk.frame_bounds(*args, strict),
                       wk.frame_bounds_reference(*args, strict))
    _, values, valid, lo, hi, op, max_len = cs.window_reduce_cases(rng,
                                                                   500)[0]
    a = [torch.from_numpy(x) for x in (values, valid, lo, hi)]
    for got, want in zip(wk.frame_reduce(*a, op, max_len),
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
    with pytest.raises(ValueError):
        wk.seg_scan(v, None, "mul", reverse=True)
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
        for label, values, flags, op in cs.window_reverse_cases(rng,
                                                                _CARD_N):
            cs.check_window_scan(label, values, flags, op, cuda_device, 3,
                                 reverse=True)
    elif kind == "frame_bounds":
        for label, *args in cs.window_bounds_cases(rng, _CARD_N):
            cs.check_window_bounds(label, *args, cuda_device)
    else:
        for label, *args in cs.window_reduce_cases(rng, _CARD_N):
            cs.check_window_reduce(label, *args, cuda_device, 3)
    torch.cuda.synchronize()
    assert fn.launches > before
    assert _CARD_N in fn.launch_rows
