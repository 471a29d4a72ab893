"""The decimal128 kernels (``spark_rapids_tpu_torch/csrc/decimal128.cu``)
against their plain versions, without the JAX package, so the file also
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decimal_kernels.py

Here, without a card or ``nvcc``, the CUDA source is compiled by ``g++``
against a small header that emulates what it uses (a block as 256
``std::thread``s, ``__syncthreads`` and each warp's shuffles, ballots and
matches as barriers, shared memory as statics, at most 3 blocks so the
grid-stride loops turn), and the 256-bit products, the HALF_UP division
chains and the 192-bit carry-propagating accumulation are held bit for bit
against the plain versions on the kernel phase's cases (``chip_smoke.py``).
The wrappers' CPU path and input checks are tested too. On the card the
``cuda`` cases hold each kernel against its plain version, the segment sum
three times by bits, and Q1 and Q6 over DECIMAL(12,2) against the CPU."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_tpu_torch.expr import decimal128 as d

_SRC = Path(__file__).resolve().parents[1] / "spark_rapids_tpu_torch" \
    / "csrc" / "decimal128.cu"

#: what decimal128.cu needs of CUDA, on the CPU
_EMULATION = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
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
inline unsigned mask_of(unsigned long long v, bool by_value) {
  Warp& w = warp();
  w.val[lane()] = v;
  w.bar->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (by_value ? w.val[i] == v : w.val[i] != 0) m |= 1u << i;
  w.bar->arrive_and_wait();
  return m;
}
}  // namespace emu
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __ballot_sync(unsigned, bool p) {
  return emu::mask_of(p, false);
}
inline unsigned __match_any_sync(unsigned, unsigned long long v) {
  return emu::mask_of(v, true);
}
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  emu::Warp& w = emu::warp();
  w.val[emu::lane()] = v;
  w.bar->arrive_and_wait();
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i)
    if (mask >> i & 1u) sum += (unsigned)w.val[i];
  w.bar->arrive_and_wait();
  return sum;
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return (T)emu::exchange((unsigned long long)v, src);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  return (T)emu::exchange((unsigned long long)v, emu::lane() ^ m);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int atomicCAS(int* p, int cmp, int val) {
  std::atomic_ref<int>(*p).compare_exchange_strong(cmp, val);
  return cmp;
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

_N = 300


def _emulated_source() -> str:
    """decimal128.cu for g++: the emulation header for the runtime's, every
    ``<<<grid, kThreads, 0, stream>>>`` launch a call, and at most 3 blocks
    a grid."""
    src = _SRC.read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emul.h"')
    src, n = re.subn(r"constexpr int64_t kMaxBlocks = [^;]+;",
                     "constexpr int64_t kMaxBlocks = 3;", src)
    assert n == 1
    src, n = re.subn(r"(\w+)<<<(.*?),\s*kThreads,\s*0,\s*(.*?)>>>\(",
                     r"emu_launch(\1, \2, kThreads, ", src, flags=re.S)
    assert n == 4, "every launch of decimal128.cu is rewritten"
    return src


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The kernels' source compiled by g++ against the emulation, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels' CPU model")
    tmp = tmp_path_factory.mktemp("d128_model")
    (tmp / "emul.h").write_text(_EMULATION)
    (tmp / "decimal128.cpp").write_text(_emulated_source())
    so = tmp / "libd128model.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                          "-fPIC", "-o", str(so), str(tmp / "decimal128.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_d128_mul_rescaled.argtypes = [ptr, i32, ptr, i32, i64, i32, i32,
                                          ptr, ptr, ptr]
    lib.srt_d128_rescale.argtypes = [ptr, i32, i64, i32, i32, ptr, ptr, ptr]
    lib.srt_d128_segment_sum.argtypes = [ptr, i32, ptr, ptr, i32, i64, i64,
                                         i32, ptr, ptr, ptr, ptr]
    return lib


def _outs(n: int):
    return (torch.empty((n, 2), dtype=torch.int64),
            torch.empty(n, dtype=torch.bool))


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g[(g != w).reshape(len(g), -1).any(1)],
                                   w[(g != w).reshape(len(w), -1).any(1)])


def _cases(builder):
    return builder(np.random.default_rng(4), _N)


@pytest.mark.parametrize("case", range(len(_cases(cs.d128_mul_cases))))
def test_model_mul_rescaled_equals_plain(model, case):
    _, a, b, wa, wb, drop, p = _cases(cs.d128_mul_cases)[case]
    ta, tb = cs.d128_tensor(a, wa, "cpu"), cs.d128_tensor(b, wb, "cpu")
    out, over = _outs(len(a))
    assert model.srt_d128_mul_rescaled(
        ta.data_ptr(), int(wa), tb.data_ptr(), int(wb), len(a), drop, p,
        out.data_ptr(), over.data_ptr(), None) == 0
    _equal((out, over), d.d128_mul_rescaled_reference(ta, tb, drop, p))


@pytest.mark.parametrize("case", range(len(_cases(cs.d128_rescale_cases))))
def test_model_rescale_equals_plain(model, case):
    _, v, wide, fs, ts, p = _cases(cs.d128_rescale_cases)[case]
    tv = cs.d128_tensor(v, wide, "cpu")
    out, over = _outs(len(v))
    assert model.srt_d128_rescale(tv.data_ptr(), int(wide), len(v), ts - fs,
                                  p, out.data_ptr(), over.data_ptr(),
                                  None) == 0
    _equal((out, over), d.d128_rescale_reference(tv, fs, ts, p))


@pytest.mark.parametrize("case",
                         range(len(_cases(cs.d128_segment_sum_cases))))
def test_model_segment_sum_equals_plain(model, case):
    """Groups spread over the 3 blocks' slots and warps: cap 65536 is cut
    to 1024 (the model's finalise runs a thread a group)."""
    label, v, wide, c, g, cap, p = _cases(cs.d128_segment_sum_cases)[case]
    if cap > 1024:
        cap, g = 1024, g % 1024
    tv = cs.d128_tensor(v, wide, "cpu")
    tc, tg = torch.from_numpy(c), torch.from_numpy(g)
    out, over = _outs(cap)
    acc = torch.zeros((cap, 3), dtype=torch.int64)
    assert model.srt_d128_segment_sum(
        tv.data_ptr(), int(wide), tc.data_ptr(), tg.data_ptr(),
        int(tg.dtype == torch.int64), len(v), cap, p, acc.data_ptr(),
        out.data_ptr(), over.data_ptr(), None) == 0
    _equal((out, over), d.d128_segment_sum_reference(tv, tc, tg, cap, p))


def test_model_segment_sum_of_many_groups_a_warp(model):
    """More than 8 groups in a warp takes the per-row global atomics; a
    group id past cap and a negative one are dropped."""
    rng = np.random.default_rng(9)
    n, cap = 2000, 40
    tv = cs.d128_tensor(cs.d128_random(rng, n), True, "cpu")
    tg = torch.from_numpy(rng.integers(-3, cap + 3, n).astype(np.int32))
    tc = torch.from_numpy(rng.random(n) < 0.7)
    out, over = _outs(cap)
    acc = torch.zeros((cap, 3), dtype=torch.int64)
    assert model.srt_d128_segment_sum(
        tv.data_ptr(), 1, tc.data_ptr(), tg.data_ptr(), 0, n, cap, 38,
        acc.data_ptr(), out.data_ptr(), over.data_ptr(), None) == 0
    _equal((out, over), d.d128_segment_sum_reference(tv, tc, tg, cap, 38))


# ---------------------------------------------------------------------------
# the wrappers on the CPU: the plain versions, and their input checks
# ---------------------------------------------------------------------------
def _limbs(n=8, seed=1):
    return cs.d128_tensor(cs.d128_random(np.random.default_rng(seed), n),
                          True, "cpu")


def test_wrappers_on_cpu_are_the_plain_versions():
    a, b = _limbs(), _limbs(seed=2)
    i = torch.arange(8, dtype=torch.int64) * 1000 - 3000
    before = {f: f.launches for f in (d.d128_mul_rescaled, d.d128_rescale,
                                      d.d128_segment_sum)}
    _equal(d.d128_mul_rescaled(a, i, 3, 38),
           d.d128_mul_rescaled_reference(a, i, 3, 38))
    _equal(d.d128_rescale(i, 2, 5, 20), d.d128_rescale_reference(i, 2, 5, 20))
    c = torch.ones(8, dtype=torch.bool)
    g = torch.tensor([0, 1, 0, 1, 2, 2, 0, 1], dtype=torch.int32)
    _equal(d.d128_segment_sum(a, c, g, 3, 38),
           d.d128_segment_sum_reference(a, c, g, 3, 38))
    assert all(f.launches == n for f, n in before.items())


@pytest.mark.parametrize("bad", ["int32", "3 limbs", "strided", "rows",
                                 "drop", "precision", "scale", "contrib",
                                 "gid", "cap"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    a = _limbs()
    c = torch.ones(8, dtype=torch.bool)
    g = torch.zeros(8, dtype=torch.int32)
    calls = {
        "int32": lambda: d.d128_mul_rescaled(a.to(torch.int32), a, 0, 38),
        "3 limbs": lambda: d.d128_rescale(
            torch.zeros((8, 3), dtype=torch.int64), 0, 1, 38),
        "strided": lambda: d.d128_segment_sum(a.t().contiguous().t(), c, g, 1,
                                              38),
        "rows": lambda: d.d128_mul_rescaled(a, a[:4], 0, 38),
        "drop": lambda: d.d128_mul_rescaled(a, a, d.MAX_MUL_SCALE_DROP + 1,
                                            38),
        "precision": lambda: d.d128_rescale(a, 0, 1, 39),
        "scale": lambda: d.d128_rescale(a, 0, 39, 38),
        "contrib": lambda: d.d128_segment_sum(a, c.to(torch.uint8), g, 1, 38),
        "gid": lambda: d.d128_segment_sum(a, c, g.to(torch.int16), 1, 38),
        "cap": lambda: d.d128_segment_sum(a, c, g, 0, 38),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[bad]()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


_CARD_N = 4096


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mul", "rescale", "segment_sum"])
def test_kernels_equal_plain_on_the_card(cuda_device, kind):
    rng = np.random.default_rng(11)
    launches = {f: f.launches for f in (d.d128_mul_rescaled, d.d128_rescale,
                                        d.d128_segment_sum)}
    if kind == "mul":
        for _, a, b, wa, wb, drop, p in cs.d128_mul_cases(rng, _CARD_N):
            ta = cs.d128_tensor(a, wa, cuda_device)
            tb = cs.d128_tensor(b, wb, cuda_device)
            _equal(d.d128_mul_rescaled(ta, tb, drop, p),
                   d.d128_mul_rescaled_reference(ta, tb, drop, p))
        fn = d.d128_mul_rescaled
    elif kind == "rescale":
        for _, v, wide, fs, ts, p in cs.d128_rescale_cases(rng, _CARD_N):
            tv = cs.d128_tensor(v, wide, cuda_device)
            _equal(d.d128_rescale(tv, fs, ts, p),
                   d.d128_rescale_reference(tv, fs, ts, p))
        fn = d.d128_rescale
    else:
        for _, v, wide, c, g, cap, p in cs.d128_segment_sum_cases(rng,
                                                                   _CARD_N):
            tv = cs.d128_tensor(v, wide, cuda_device)
            tc = torch.from_numpy(c).to(cuda_device)
            tg = torch.from_numpy(g).to(cuda_device)
            want = d.d128_segment_sum_reference(tv, tc, tg, cap, p)
            for _ in range(3):  # the same bits every run
                _equal(d.d128_segment_sum(tv, tc, tg, cap, p), want)
        fn = d.d128_segment_sum
    torch.cuda.synchronize()
    assert fn.launches > launches[fn]


@pytest.mark.cuda
@pytest.mark.parametrize("aqe", [False, True])
def test_decimal_q1_q6_on_the_card_equal_the_cpu(cuda_device, aqe):
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools import tpch
    li = tpch.decimal_lineitem(tpch.gen_lineitem(0, seed=11, rows=20000))
    outs = []
    for device in ("cpu", "cuda"):
        sess = TorchSession({"spark.rapids.sql.test.enabled": True,
                             "spark.rapids.tpu.aqe.enabled": aqe},
                            device=device)
        t = {"lineitem": sess.create_dataframe(li, num_partitions=2)}
        outs.append([tpch.q1_decimal(t).collect(),
                     tpch.q6_decimal(t).collect()])
    for cpu, card in zip(*outs):
        assert cpu.equals(card)
    cs.check_q1_decimal(outs[1][0], cs.d128_q1_reference(li), "Q1 decimal")
    cs.check_q6_decimal(outs[1][1], cs.d128_q6_reference(li), "Q6 decimal")
