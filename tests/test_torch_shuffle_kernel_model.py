"""``csrc/shuffle.cu`` on the CPU: the CUDA source compiled by ``g++``
against a header that emulates the runtime (a block as ``std::thread``s,
one block after another; warp shuffles, ``__match_any_sync`` and barriers
as ``std::barrier``s; shared memory as the blocks' common static
storage), then held bit for bit against the plain versions the wrappers
use on the CPU (``device_partition_ids``, ``counting_order_reference``)
and against ``torch.argsort(stable=True)``.

The source's constants are cut for the model (3 blocks a grid-stride loop,
64-thread scans, tiles of at least 64 rows and at most 8 tiles), so a few
thousand rows walk many tiles, every scan chunk and the ragged last warp
step; the launch syntax becomes a call. Tolerance: exact."""
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
from test_torch_shuffle_kernels import _KEY_SETS, _table

_SRC = Path(__file__).resolve().parent.parent / "spark_rapids_tpu_torch" \
    / "csrc" / "shuffle.cu"

_EMULATION = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
struct emu_dim3 { unsigned x = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
namespace emu {
inline std::barrier<>* block_bar = nullptr;
struct Warp { std::barrier<>* bar = nullptr; unsigned long long val[32]; };
inline Warp warps[64];
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
inline std::atomic<long long> launches{0};
}  // namespace emu
extern "C" long long emu_launches() { return emu::launches; }
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warp().bar->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) {
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
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  int l = emu::lane();
  return emu::from<T>(emu::exchange(emu::bits(v), l >= d ? l - d : l));
}
inline unsigned __match_any_sync(unsigned, int v) {
  emu::Warp& w = emu::warp();
  w.val[emu::lane()] = static_cast<unsigned long long>(
      static_cast<unsigned>(v));
  w.bar->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (w.val[i] == w.val[emu::lane()]) m |= 1u << i;
  w.bar->arrive_and_wait();
  return m;
}
// the grid's blocks one after another, the last blockIdx first: a thread
// a block's thread, each running its part of every block in turn
template <class K, class... A>
void emu_launch(K kernel, unsigned grid, unsigned block, A... args) {
  ++emu::launches;
  gridDim.x = grid;
  blockDim.x = block;
  std::barrier<> bar(block);
  emu::block_bar = &bar;
  std::vector<std::barrier<>*> wb;
  for (unsigned w = 0; w < block / 32; ++w) {
    wb.push_back(new std::barrier<>(32));
    emu::warps[w].bar = wb.back();
  }
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < block; ++t)
    ts.emplace_back([=, &bar] {
      threadIdx.x = t;
      for (unsigned b = grid; b-- > 0;) {
        blockIdx.x = b;
        kernel(args...);
        bar.arrive_and_wait();  // the block ends before the next begins
      }
    });
  for (auto& t : ts) t.join();
  for (auto* p : wb) delete p;
}
"""


def _emulated_source() -> str:
    src = _SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emul.h"')
    for pat, rep in (
            (r"constexpr int64_t kMaxBlocks = [^;]+;",
             "constexpr int64_t kMaxBlocks = 3;"),
            (r"constexpr int kScanThreads = 1024;",
             "constexpr int kScanThreads = 64;"),
            (r"constexpr int64_t kMinTile = 2048;",
             "constexpr int64_t kMinTile = 64;"),
            (r"constexpr int64_t kMaxTiles = 4096;",
             "constexpr int64_t kMaxTiles = 8;")):
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    # dynamic shared memory: the block's common static storage
    src, n = re.subn(r"extern __shared__ int32_t (\w+)\[\];",
                     r"static int32_t \1[kMaxBins];", src)
    assert n == 2, "both dynamic shared arrays are rewritten"
    src, n = re.subn(r"(\w+)<<<(.*?),\s*(\w+),\s*(\w+),\s*(.*?)>>>\(",
                     r"emu_launch(\1, \2, \3, ", src, flags=re.S)
    assert n == 5, "every launch of shuffle.cu is rewritten"
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    tmp = tmp_path_factory.mktemp("shuffle_model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "shuffle.cpp").write_text(_emulated_source())
    so = tmp / "libshufflemodel.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
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
    lib.emu_launches.restype = i64
    return lib


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


@pytest.mark.parametrize("n,nv", [(1, 1), (31, 3), (32, 5), (33, 2),
                                  (1000, 5), (2047, 33), (5000, 300),
                                  (700, 8192)])
def test_counting_order_source_equals_the_plain_version(lib, n, nv):
    """Four launches a call; the permutation and counts exactly."""
    rng = np.random.default_rng(n * 31 + nv)
    for ids_np in (rng.integers(0, nv, n),
                   np.sort(rng.integers(0, nv, n)),      # long runs of one id
                   np.full(n, nv - 1)):                   # one id
        ids = torch.from_numpy(ids_np.astype(np.int32))
        order = torch.empty(n, dtype=torch.int32)
        counts = torch.empty(nv, dtype=torch.int32)
        scratch = torch.empty(lib.srt_counting_order_scratch(n, nv),
                              dtype=torch.int32)
        before = lib.emu_launches()
        assert lib.srt_counting_order(ids.data_ptr(), n, nv,
                                      scratch.data_ptr(), order.data_ptr(),
                                      counts.data_ptr(), None) == 0
        assert lib.emu_launches() - before == 4
        r_order, r_counts = counting_order_reference(ids, nv)
        assert torch.equal(order, r_order), (n, nv)
        assert torch.equal(counts, r_counts), (n, nv)
        assert torch.equal(order.long(), torch.argsort(ids, stable=True))


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
