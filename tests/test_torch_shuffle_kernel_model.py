"""``csrc/shuffle.cu`` on the CPU: the CUDA source compiled by ``g++``
against a header that emulates the runtime (a block's threads as fibers
on one OS thread, each running until it waits at a barrier; one block
after another, the last ``blockIdx`` first; warp shuffles, ballots and
``__match_any_sync`` through a warp's barrier; shared
memory as the blocks' common static storage; the look-back's relaxed loads
and release stores as atomics), then held bit for bit against the plain
versions the wrappers use on the CPU (``device_partition_ids``,
``counting_order_reference``) and against ``torch.argsort(stable=True)``.

The source's constants are cut for the model (3 blocks a grid-stride loop,
64-thread scans; the first design's tiles of at least 64 rows and at most
8 tiles; the one-pass path's tiles of 2 warps x 2 rows and look-back
windows of 2 words a lane), so a few thousand rows walk many tiles, every
scan chunk and the ragged last warp step; the launch syntax becomes a
call. Run the last ``blockIdx`` first, every one-pass tile's look-back
sums the aggregates of all the tiles before it; ``emu_set_forward(1)``
runs the blocks in order, and ``emu_set_flaky(seed, permille)`` makes that
share of the look-back's reads of a word published in the running launch
return the word as it was before (its aggregate), so a tile sums past
predecessors whose inclusive words it cannot see yet. Tolerance: exact."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.shuffle.manager import (
    _KeyDesc, _key_desc, counting_order_reference, device_partition_ids)
from test_torch_shuffle_kernels import _KEY_SETS, _id_sets, _table

_SRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc" / "shuffle.cu"

_EMULATION = r"""
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline int cudaGetLastError() { return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
struct emu_dim3 { unsigned x = 0; };
struct alignas(16) int4 { int x, y, z, w; };
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
inline Warp warps[64];
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
inline std::atomic<long long> launches{0}, memsets{0}, stale_reads{0};
// the look-back's words published in the running launch: their values
// before, which a flaky read returns
inline std::mutex words_mu;
inline std::unordered_map<const void*, unsigned> before;
inline unsigned long long flaky_seed = 0, flaky_reads = 0;
inline unsigned flaky_permille = 0;
inline bool flaky() {
  if (flaky_permille == 0) return false;
  unsigned long long z = flaky_seed + 0x9E3779B97F4A7C15ULL * ++flaky_reads;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  z ^= z >> 31;
  return z % 1000 < flaky_permille;
}
inline unsigned load_word(const unsigned* p) {
  unsigned w = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  std::lock_guard<std::mutex> g(words_mu);
  auto it = before.find(p);
  if (it != before.end() && flaky()) {
    ++stale_reads;
    return it->second;
  }
  return w;
}
inline void publish_word(unsigned* p, unsigned w) {
  {
    std::lock_guard<std::mutex> g(words_mu);
    before.emplace(p, __atomic_load_n(p, __ATOMIC_SEQ_CST));
  }
  __atomic_store_n(p, w, __ATOMIC_SEQ_CST);
}
}  // namespace emu
extern "C" long long emu_launches() { return emu::launches; }
extern "C" long long emu_memsets() { return emu::memsets; }
extern "C" long long emu_stale_reads() { return emu::stale_reads; }
extern "C" void emu_set_flaky(unsigned long long seed, unsigned permille) {
  emu::flaky_seed = seed;
  emu::flaky_reads = 0;
  emu::flaky_permille = permille;
}
namespace emu {
inline bool forward = false;  // blocks in blockIdx order, else the last first
}
extern "C" void emu_set_forward(int on) { emu::forward = on != 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  ++emu::memsets;
  std::memset(p, v, n);
  return 0;
}
inline void __syncthreads() { emu::wait(emu::block_bar); }
inline void __syncwarp() { emu::wait(emu::warp().bar); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned __float_as_uint(float x) {
  return emu::from<unsigned>(emu::bits(x));
}
inline long long __double_as_longlong(double x) {
  return emu::from<long long>(emu::bits(x));
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::Warp& w = emu::warp();
  w.val[emu::lane()] = pred != 0;
  emu::wait(w.bar);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(w.val[i]) << i;
  emu::wait(w.bar);
  return r;
}
inline int __any_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) != 0;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return emu::from<T>(emu::exchange(emu::bits(v), emu::lane() ^ o));
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  int l = emu::lane();
  return emu::from<T>(emu::exchange(emu::bits(v), l >= d ? l - d : l));
}
// over segments of `width` lanes, as the hardware's
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  int l = emu::lane();
  return emu::from<T>(emu::exchange(emu::bits(v),
                                    (l & ~(width - 1)) + (src & (width - 1))));
}
inline unsigned __match_any_sync(unsigned, int v) {
  emu::Warp& w = emu::warp();
  w.val[emu::lane()] = static_cast<unsigned long long>(
      static_cast<unsigned>(v));
  emu::wait(w.bar);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (w.val[i] == w.val[emu::lane()]) m |= 1u << i;
  emu::wait(w.bar);
  return m;
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
  before.clear();
  gridDim.x = grid;
  blockDim.x = block;
  block_bar = Barrier{static_cast<int>(block)};
  for (unsigned w = 0; w < block / 32; ++w) warps[w].bar = Barrier{32};
  const bool fwd = forward;
  sched.body = [=] {
    for (unsigned i = 0; i < grid; ++i) {
      blockIdx.x = fwd ? i : grid - 1 - i;
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


#: the look-back's word accesses, each replaced by the emulation's
_WORD_ACCESS = {
    r"__device__ __forceinline__ uint32_t load_word\(const uint32_t\* p\) "
    r"\{.*?\n\}": "inline uint32_t load_word(const uint32_t* p) {\n"
                   "  return emu::load_word(p);\n}",
    r"__device__ __forceinline__ void publish_word\(uint32_t\* p, "
    r"uint32_t w\) \{.*?\n\}": "inline void publish_word(uint32_t* p, "
                                  "uint32_t w) {\n"
                                  "  emu::publish_word(p, w);\n}"}
#: csrc/shuffle.cu kOnePassBins: past it, the first design's four launches
_ONE_PASS_BINS = 1024


def _emulated_source(small_tile: bool = True) -> str:
    """shuffle.cu for g++: the emulation header for the runtime's, every
    launch a call, the first design's constants cut; with ``small_tile``
    the one-pass path's too (tiles of 2 warps x 2 rows, counted by one warp
    of 4 rows a thread, windows of 2 words a lane), else its own (16 warps
    x 8 rows, counted by 8 warps x 16, windows of 4 words)."""
    src = _SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emul.h"')
    subs = [(r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;"),
            (r"constexpr int kScanThreads = 1024;",
             "constexpr int kScanThreads = 64;"),
            (r"constexpr int64_t kMinTile = 2048;",
             "constexpr int64_t kMinTile = 64;"),
            (r"constexpr int64_t kMaxTiles = 4096;",
             "constexpr int64_t kMaxTiles = 8;"),
            (r"constexpr int kOnePassBins = (\d+);",
             f"constexpr int kOnePassBins = {_ONE_PASS_BINS};"),
            *_WORD_ACCESS.items()]
    if small_tile:
        subs += [(r"constexpr int kCoWarps = 16;",
                  "constexpr int kCoWarps = 2;"),
                 (r"constexpr int kCountWarps = 8;",
                  "constexpr int kCountWarps = 1;"),
                 (r"constexpr int kCoItems = 8;",
                  "constexpr int kCoItems = 2;"),
                 (r"constexpr int kCoWindow = 4;",
                  "constexpr int kCoWindow = 2;")]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src, flags=re.S)
        assert n == 1, pat
    # dynamic shared memory: the block's common static storage
    src, n = re.subn(r"extern __shared__ int32_t (\w+)\[\];",
                     r"static int32_t \1[1 << 15];", src)
    assert n == 4, "every dynamic shared array is rewritten"
    src, n = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*(.*?),\s*(.*?)>>>\(",
                     r"emu_launch(\1, \2, \3, ", src, flags=re.S)
    assert n == 7, "every launch of shuffle.cu is rewritten"
    return src


def _build(tmp: Path, small_tile: bool) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "shuffle.cpp").write_text(_emulated_source(small_tile))
    so = tmp / "libshufflemodel.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                          # each model keeps its own inline variables: as
                          # GNU unique symbols, every model in the process
                          # would share the first one loaded
                          "-fno-gnu-unique",
                          "-fPIC", "-o", str(so), str(tmp / "shuffle.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_partition_ids.argtypes = [ptr, i32, i64, ctypes.c_uint32, i32,
                                      i32, ptr, ptr, ptr]
    lib.srt_counting_order.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr]
    lib.srt_counting_order_scratch.argtypes = [i64, i32]
    lib.srt_counting_order_scratch.restype = i64
    for fn in (lib.emu_launches, lib.emu_memsets, lib.emu_stale_reads):
        fn.restype = i64
    lib.emu_set_flaky.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
    lib.emu_set_forward.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("shuffle_model"), True)


@pytest.fixture(scope="module")
def own_tile_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("shuffle_model_own_tile"), False)


def _model_partition_ids(lib, table, keys, p, seed, normalize, mask):
    keep = []
    descs = (_KeyDesc * max(len(keys), 1))(
        *[_key_desc(table.column(k), keep) for k in keys])
    out = torch.empty(table.capacity, dtype=torch.int32)
    m = None if mask is None else mask.contiguous()
    assert lib.srt_partition_ids(descs, len(keys), table.capacity, seed, p,
                                 int(normalize),
                                 None if m is None else m.data_ptr(),
                                 out.data_ptr(), None) == 0
    return out


@pytest.mark.parametrize("keys", _KEY_SETS, ids="+".join)
def test_partition_ids_source_equals_the_plain_version(lib, keys):
    for n in (1, 77, 1500):
        t = _table(n, n + 5)
        for p, seed in ((1, 42), (4, 42), (7, 9001), (256, 42)):
            for norm, mask in ((False, None), (True, t.row_mask)):
                want = device_partition_ids(t, keys, p, seed, norm)
                got = _model_partition_ids(lib, t, keys, p, seed, norm, mask)
                exp = want if mask is None else torch.where(mask, want, p)
                assert torch.equal(got, exp), (n, p, norm, mask is None)


def _model_counting_order(lib, ids: torch.Tensor, nv: int) -> tuple:
    """-> (order, counts, launches, memsets) of one call of the model."""
    n = ids.shape[0]
    order = torch.empty(n, dtype=torch.int32)
    counts = torch.full((nv,), -7, dtype=torch.int32)  # written, not added to
    scratch = torch.full((lib.srt_counting_order_scratch(n, nv),), -7,
                         dtype=torch.int32)
    before = lib.emu_launches(), lib.emu_memsets()
    assert lib.srt_counting_order(ids.data_ptr(), n, nv, scratch.data_ptr(),
                                  order.data_ptr(), counts.data_ptr(),
                                  None) == 0
    return (order, counts, lib.emu_launches() - before[0],
            lib.emu_memsets() - before[1])


def _check_counting_order(lib, n: int, nv: int, tile: int) -> None:
    """Every id set of ``_id_sets`` (the random one also as a view one id
    into its storage) through the model, against the plain version and
    ``torch.argsort(stable=True)``, the blocks the last first
    (every tile's look-back then sums the aggregates of all the tiles
    before it); with 8 tiles or more, the random and parked sets again
    with the blocks in order and half, then 95 %, of the reads of a word
    published in the launch returning its aggregate."""
    rng = np.random.default_rng(n * 31 + nv)
    one_pass = nv <= _ONE_PASS_BINS
    tiles = -(-n // tile)
    sets = {label: torch.from_numpy(ids_np.astype(np.int32))
            for label, ids_np in _id_sets(rng, n, nv).items()}
    # a view one id into its storage: no 16-byte loads
    sets["random, unaligned"] = torch.cat([sets["random"][:1],
                                           sets["random"]])[1:]
    for label, ids in sets.items():
        r_order, r_counts = counting_order_reference(ids, nv)
        runs = [(0, 0)]
        if one_pass and tiles >= 8 and label in ("random",
                                                 "parked at nv - 1"):
            runs += [(n + 1, 500), (n + 2, 950)]
        for seed, permille in runs:
            lib.emu_set_flaky(seed, permille)
            lib.emu_set_forward(permille > 0)
            stale = lib.emu_stale_reads()
            try:
                order, counts, launches, memsets = _model_counting_order(
                    lib, ids, nv)
            finally:
                lib.emu_set_flaky(0, 0)
                lib.emu_set_forward(0)
            what = (n, nv, label, permille)
            assert (launches, memsets) == ((2, 1) if one_pass else (4, 0)), \
                what
            assert (lib.emu_stale_reads() > stale) == (permille > 0), what
            assert torch.equal(order, r_order), what
            assert torch.equal(counts, r_counts), what
            assert torch.equal(order.long(), torch.argsort(ids, stable=True))


@pytest.mark.parametrize("n,nv", [(1, 1), (31, 3), (32, 5), (33, 2),
                                  (1000, 5), (2047, 33), (5000, 300),
                                  (700, 8192), (4099, 1), (3000, 65),
                                  (2000, _ONE_PASS_BINS),
                                  (600, _ONE_PASS_BINS + 1)])
def test_counting_order_source_equals_the_plain_version(lib, n, nv):
    """Up to kOnePassBins ids one memset and two launches a call, past it
    four; tiles of 128 rows (4099 rows are 33 tiles, the last of 3 rows),
    so 5 ids get 8 lanes a look-back, 33 and more one; the permutation and
    counts exactly on every id set, and with the look-back summing several
    predecessors (a window of them and past it) before it meets an
    inclusive word."""
    _check_counting_order(lib, n, nv, 128)


@pytest.mark.parametrize("n,nv", [(4096 * 12 + 77, 5), (4096 * 9 + 1, 65),
                                  (4096 * 8, _ONE_PASS_BINS)])
def test_counting_order_source_at_its_own_tile(own_tile_lib, n, nv):
    """The one-pass path at the source's own tile (16 warps x 8 rows,
    4096 rows, windows of 4 words a lane): 32 lanes a look-back at 5 ids,
    4 at 65, one lane two ids at 1024."""
    _check_counting_order(own_tile_lib, n, nv, 4096)


def test_the_entries_refuse_what_the_kernels_do_not_take(lib):
    ids = torch.zeros(4, dtype=torch.int32)
    buf = torch.empty(64, dtype=torch.int32)
    assert lib.srt_counting_order(ids.data_ptr(), 4, 8193, buf.data_ptr(),
                                  buf.data_ptr(), buf.data_ptr(), None) != 0
    assert lib.srt_counting_order(ids.data_ptr(), 0, 4, buf.data_ptr(),
                                  buf.data_ptr(), buf.data_ptr(), None) != 0
    assert lib.srt_partition_ids(None, 17, 4, 42, 4, 0, None,
                                 buf.data_ptr(), None) != 0
    assert lib.srt_partition_ids(None, 0, 4, 42, 0, 0, None,
                                 buf.data_ptr(), None) != 0
