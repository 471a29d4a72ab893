"""The decimal128 kernels (``spark_rapids_tpu_torch/csrc/decimal128.cu``)
against their plain versions, without the JAX package, so the file also
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decimal_kernels.py

Here, without a card or ``nvcc``, the CUDA source is compiled by ``g++``
against a small header that emulates what it uses (a block as 256
``std::thread``s, ``__syncthreads`` and each warp's shuffles, ballots and
matches as barriers, shared memory as statics, at most 3 blocks so the
grid-stride loops turn), and the 256-bit products, the HALF_UP division
chains and both segment-sum paths (the small-cap one's digit sums in
registers and its blocks' partials; the 192-bit carry-propagating atomics
past it) are held bit for bit against the plain versions on the kernel
phase's cases (``chip_smoke.py``).
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
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
// a card of 2 SMs, one block each: the small-cap sum's grid is the least
// of those 2 and the 3 blocks its rows take
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return 0;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = 1;
  return 0;
}
struct longlong2 { long long x, y; };
struct int4 { int x, y, z, w; };
template <class T> T __ldg(const T* p) { return *p; }
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
    src, n = re.subn(r"(\w+(?:<[\w, ]*>)?)<<<(.*?),\s*kThreads,\s*0,\s*"
                     r"(.*?)>>>\(", r"emu_launch(\1, \2, kThreads, ", src,
                     flags=re.S)
    assert n == 6, "every launch of decimal128.cu is rewritten"
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
                          # each model keeps its own inline variables: as
                          # GNU unique symbols, every model in the process
                          # would share the first one loaded
                          "-fno-gnu-unique",
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
    lib.srt_d128_segment_sum_scratch.argtypes = [i64, i64]
    lib.srt_d128_segment_sum_scratch.restype = i64
    lib.srt_d128_segment_sum_small_cap.restype = i32
    return lib


def _outs(n: int):
    return (torch.empty((n, 2), dtype=torch.int64),
            torch.empty(n, dtype=torch.bool))


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g[(g != w).reshape(len(g), -1).any(1)],
                                   w[(g != w).reshape(len(w), -1).any(1)])


def _cases(builder, n: int = _N):
    return builder(np.random.default_rng(4), n)


#: rows of the segment-sum cases: 750 whole steps of 4 rows over 2 blocks
#: of 256 threads (the grid-stride loop turns) and a ragged last row
_SUM_N = 3001


def _model_sum(model, tv, wide, tc, tg, cap, p):
    """The model's segment sum over scratch of the size it asks for, the
    scratch filled with junk first (nothing may rely on it being zero)."""
    n = tv.shape[0]
    for t in (tv, tc, tg):
        assert t.data_ptr() % 16 == 0, "the kernel reads 16-byte words"
    scratch = torch.full((model.srt_d128_segment_sum_scratch(n, cap),),
                         0x5A5A5A5A5A5A5A5A, dtype=torch.int64)
    out, over = _outs(cap)
    assert model.srt_d128_segment_sum(
        tv.data_ptr(), int(wide), tc.data_ptr(), tg.data_ptr(),
        int(tg.dtype == torch.int64), n, cap, p, scratch.data_ptr(),
        out.data_ptr(), over.data_ptr(), None) == 0
    return out, over


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


@pytest.mark.parametrize("case", range(len(_cases(cs.d128_segment_sum_cases,
                                                 _SUM_N))))
def test_model_segment_sum_equals_plain(model, case):
    """Both paths (cap 1 and up to the small cap in registers, past it
    through the atomics), groups spread over the blocks' slots and warps:
    cap 65536 is cut to 1024 (the model's finalise runs a thread a
    group)."""
    label, v, wide, c, g, cap, p = _cases(cs.d128_segment_sum_cases,
                                          _SUM_N)[case]
    if cap > 1024:
        cap, g = 1024, g % 1024
    tv = cs.d128_tensor(v, wide, "cpu")
    tc, tg = torch.from_numpy(c), torch.from_numpy(g)
    _equal(_model_sum(model, tv, wide, tc, tg, cap, p),
           d.d128_segment_sum_reference(tv, tc, tg, cap, p))


def test_model_segment_sum_of_many_groups_a_warp(model):
    """More than 8 groups in a warp takes the per-row global atomics; a
    group id past cap and a negative one are dropped."""
    rng = np.random.default_rng(9)
    n, cap = 2000, 40
    tv = cs.d128_tensor(cs.d128_random(rng, n), True, "cpu")
    tg = torch.from_numpy(rng.integers(-3, cap + 3, n).astype(np.int32))
    tc = torch.from_numpy(rng.random(n) < 0.7)
    _equal(_model_sum(model, tv, True, tc, tg, cap, 38),
           d.d128_segment_sum_reference(tv, tc, tg, cap, 38))


@pytest.mark.parametrize("n", [0, 5, 1029])
@pytest.mark.parametrize("cap", [1, 3, d.SEGMENT_SUM_SMALL_CAP])
def test_model_small_cap_sum_of_few_rows(model, n, cap):
    """The small-cap path where the rows do not fill a step, a block or
    the grid (the rows past the last whole step go to block 0), and group
    ids outside ``[0, cap)``, including those between cap and the
    registers' bound, dropped."""
    rng = np.random.default_rng(n + 10 * cap)
    tv = cs.d128_tensor(cs.d128_random(rng, n), True, "cpu")
    tg = torch.from_numpy(rng.integers(-2, d.SEGMENT_SUM_SMALL_CAP + 2,
                                       n).astype(np.int64))
    tc = torch.from_numpy(rng.random(n) < 0.8)
    _equal(_model_sum(model, tv, True, tc, tg, cap, 38),
           d.d128_segment_sum_reference(tv, tc, tg, cap, 38))


def test_model_small_cap_is_the_wrappers(model):
    """The source's register bound is the one the wrapper and the cases
    name, and its scratch is a (cap, 4) block of digit sums a block on
    that path (3 blocks at most in the model)."""
    k = d.SEGMENT_SUM_SMALL_CAP
    assert model.srt_d128_segment_sum_small_cap() == k
    assert model.srt_d128_segment_sum_scratch(1 << 20, k + 1) == 3 * (k + 1)
    assert model.srt_d128_segment_sum_scratch(1 << 20, k) == 4 * k * 3
    assert model.srt_d128_segment_sum_scratch(0, 1) == 4


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


def test_decimal_sum_copies_no_host_list_to_the_device_each_call(
        monkeypatch):
    """``_d128_sum`` makes its overflow mark once a device: a tensor built
    from a Python list is a copy from pageable host memory, which makes the
    host wait for the stream on every decimal sum."""
    from spark_rapids_tpu_torch.exec import aggregate
    a = _limbs(16)
    c = torch.ones(16, dtype=torch.bool)
    g = torch.tensor([0, 1] * 8, dtype=torch.int32)
    out_dt = aggregate.dt.DecimalType(38, 2)
    has = torch.ones(2, dtype=torch.bool)
    aggregate._d128_sum(a, c, g, 2, out_dt, has, None)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor",
                        lambda *args, **kw: made.append(args) or real(
                            *args, **kw))
    for merge in (None, c):
        limbs, valid = aggregate._d128_sum(a, c, g, 2, out_dt, has, merge)
    assert made == []
    assert torch.equal(limbs, d.d128_segment_sum_reference(a, c, g, 2,
                                                           38)[0])


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
            # views one row in: off 16 bytes, which the wrapper copies
            views = (tv[1:], tc[1:], tg[1:])
            _equal(d.d128_segment_sum(*views, cap, p),
                   d.d128_segment_sum_reference(*views, cap, p))
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
