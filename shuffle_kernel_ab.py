#!/usr/bin/env python3
"""The ``counting_order`` kernel of ``csrc/shuffle.cu`` beside another
version of the source, on one NVIDIA card.

    python3 shuffle_kernel_ab.py [--variant NAME=OTHER.cu ...] [--limits]
                                 [--ptxas] [--profile] [--phases]
                                 [--check-only] [--split OTHER_ROOT]

Times ``counting_order`` at the sizes ``chip_smoke.py
shuffle_kernel_phase`` times it (``SHUFFLE_SIZES`` x ``SHUFFLE_PARTS``:
2^20 and 2^23 ids in [0, P + 1), P partitions and the masked rows' id),
in CUDA graphs over input sets larger than L2, each beside its byte bound
(the ids read once, the order written once) and ``torch.argsort(stable=
True)``:

- the kernel as built from ``spark_rapids_tpu_torch/csrc``, through its
  wrapper;
- ``--variant NAME=PATH`` (repeatable): the same entry point built from
  another copy of ``shuffle.cu`` (for example the version before the
  redesign, written out of git into a directory that ``.gitignore``
  lists);
- ``--limits``: the committed source with one thing changed, each named
  by what it shows: the look-back's words read with acquire loads, or
  published with release stores; ``__match_any_sync`` (or the ballot a
  bit) at every id count; the words id-major (or tile-major) at every id
  count; one look-back word a lane a round; 8 warps of 16 rows a tile in
  place of 16 of 8.

Every version is first held against the plain version and ``torch.argsort``
bit for bit on two input sets at each size, then timed in turns (the list,
then the list reversed). ``--ptxas`` prints each counting-order kernel's
registers, shared memory and spills as ``ptxas -v`` reports them;
``--profile`` each version's device time by kernel (``torch.profiler``);
``--phases`` the committed ``co_rank_scatter``'s steps timed inside each
block (a copy of the source with ``%globaltimer`` stamps); ``--check-only``
stops after the checks. ``--split OTHER_ROOT`` then runs
``chip_smoke.py exchange_chunk_split`` (one warm Q3 at SF1 over a virtual
mesh of 4 shards, AQE and the pipelined collect off) in a process of its
own a run, with the package
of OTHER_ROOT (a directory holding another ``spark_rapids_tpu_torch``),
then this checkout's twice, then OTHER_ROOT's again. The card's name and
power limit are printed beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

# variant name -> [(text, replacement)], each text occurring once in the
# committed source; every variant computes the same order
_MATCH = "  if (nv <= kMatchBins) return __match_any_sync(kFull, label);"
_LAYOUT = ("      : id_stride(look_back_lanes(nv) >= 8 ? tiles : 1),\n"
           "        tile_stride(look_back_lanes(nv) >= 8 ? 1 : nv) {}")
LIMITS = {
    "acquire loads": [("ld.relaxed.gpu.global.u32",
                       "ld.acquire.gpu.global.u32")],
    "release stores": [("st.relaxed.gpu.global.u32",
                        "st.release.gpu.global.u32")],
    "__match_any_sync at every id count": [(
        _MATCH, _MATCH.replace("nv <= kMatchBins", "nv > 0"))],
    "ballots at every id count": [(
        _MATCH, _MATCH.replace("nv <= kMatchBins", "nv < 0"))],
    "id-major words at every id count": [(
        _LAYOUT, _LAYOUT.replace(">= 8", ">= 0"))],
    "tile-major words at every id count": [(
        _LAYOUT, _LAYOUT.replace(">= 8", ">= 64"))],
    "1 look-back word a lane": [(
        "constexpr int kCoWindow = 4;", "constexpr int kCoWindow = 1;")],
    "8 warps x 16 rows": [
        ("constexpr int kCoWarps = 16;", "constexpr int kCoWarps = 8;"),
        ("constexpr int kCoItems = 8;", "constexpr int kCoItems = 16;")],
}

# the committed source with a timestamp (%globaltimer) of thread 0 at each
# step of every co_rank_scatter block, kept in a device array
_STAMP = ("  const unsigned long long T{i} = srt_stamp();\n")
PHASES = ("start", "prologue", "rank", "look-back finish", "sync",
          "prefix and scan", "stage", "write")
_PHASE_EDITS = [
    ("namespace {\n\nusing KeyDesc = SrtKeyDesc;",
     "__device__ unsigned long long srt_phase_stamps[65536 * 8];\n"
     "__device__ __forceinline__ unsigned long long srt_stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "namespace {\n\nusing KeyDesc = SrtKeyDesc;"),
    ("  const int64_t tile = blockIdx.x;\n  const int lane",
     _STAMP.format(i=0) + "  const int64_t tile = blockIdx.x;\n"
     "  const int lane"),
    ("  LookBack back(words, tile, tiles, nv);\n",
     _STAMP.format(i=1) + "  LookBack back(words, tile, tiles, nv);\n"),
    ("  if (tile > 0) {\n    back.finish(delta);",
     _STAMP.format(i=2) + "  if (tile > 0) {\n    back.finish(delta);"),
    ("  __syncthreads();\n  // each id's warps before",
     _STAMP.format(i=3) + "  __syncthreads();\n" + _STAMP.format(i=4)
     + "  // each id's warps before"),
    ("      carry += total;\n    }\n  }\n  __syncthreads();\n",
     "      carry += total;\n    }\n  }\n" + _STAMP.format(i=5)
     + "  __syncthreads();\n"),
    ("  __syncthreads();\n  const int64_t left = n - tile * kCoTile;\n",
     "  __syncthreads();\n" + _STAMP.format(i=6)
     + "  const int64_t left = n - tile * kCoTile;\n"),
    ("    order[delta[st >> 16] + slot] = row0 + (st & 0xFFFF);\n  }\n}\n",
     "    order[delta[st >> 16] + slot] = row0 + (st & 0xFFFF);\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 65536) {\n"
     "    unsigned long long* g = srt_phase_stamps + 8ull * blockIdx.x;\n"
     "    g[0] = T0; g[1] = T1; g[2] = T2; g[3] = T3; g[4] = T4;\n"
     "    g[5] = T5; g[6] = T6; g[7] = srt_stamp();\n  }\n}\n"),
]
_PHASE_ENTRY = (
    '\nextern "C" int srt_phase_stamps_read(unsigned long long* out,\n'
    "                                     int64_t count) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
    "      out, srt_phase_stamps, sizeof(unsigned long long) * count));\n}\n")


def _phase_source(text: str) -> str:
    for old, new in _PHASE_EDITS:
        if text.count(old) != 1:
            raise AssertionError("--phases: the source changed; update "
                                 "the timestamps' places")
        text = text.replace(old, new)
    return text + _PHASE_ENTRY


def _phases(so: Path, card: str) -> None:
    """Each co_rank_scatter block's steps (thread 0's clock, %globaltimer)
    at each size, averaged over the blocks of the third call; a step ends
    where the next begins, so the barriers' waits fall in the step
    before."""
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_counting_order.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr]
    lib.srt_counting_order_scratch.argtypes = [i64, i32]
    lib.srt_counting_order_scratch.restype = i64
    lib.srt_phase_stamps_read.argtypes = [ptr, i64]
    run = _launcher(lib)
    rng = np.random.default_rng(17)
    tile = 4096
    for n in cs.SHUFFLE_SIZES:
        for p in cs.SHUFFLE_PARTS:
            ids = torch.from_numpy(rng.integers(0, p + 1, n).astype(
                np.int32)).cuda()
            for _ in range(3):
                run(ids, p + 1)
            torch.cuda.synchronize()
            tiles = -(-n // tile)
            stamps = np.zeros(8 * tiles, dtype=np.uint64)
            if lib.srt_phase_stamps_read(stamps.ctypes.data, 8 * tiles):
                raise RuntimeError("--phases: reading the stamps failed")
            t = stamps.reshape(tiles, 8).astype(np.int64)
            steps = np.diff(t, axis=1).mean(axis=0) / 1e3
            life = (t[:, 7] - t[:, 0]) / 1e3
            span = (t[:, 7].max() - t[:, 0].min()) / 1e3
            print(f"# phases counting_order n={n} P={p}: co_rank_scatter "
                  f"span {span:.2f} us, block life {life.mean():.2f} us "
                  "(mean; " + ", ".join(
                      f"{name} {us:.2f}" for name, us in
                      zip(PHASES[1:], steps)) + f"); {card}", flush=True)


_HERE = Path(__file__).resolve().parent


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab_shuffle"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _build_all(texts: dict) -> dict:
    """Each source of ``texts`` (name -> text) as a shared library, one
    ``nvcc`` each, all started together -> {name: library}."""
    from spark_rapids_tpu_torch import native
    sos = {}
    for name, text in texts.items():
        src = _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")
        src.write_text(text)
        sos[name] = src.with_suffix(".so")
    native._run_all([[native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                      str(so), str(so.with_suffix(".cu"))]
                     for so in sos.values()])
    out = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.srt_counting_order.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr]
        lib.srt_counting_order.restype = ctypes.c_int
        lib.srt_counting_order_scratch.argtypes = [i64, i32]
        lib.srt_counting_order_scratch.restype = i64
        out[name] = _launcher(lib)
    return out


def _launcher(lib: ctypes.CDLL):
    """A library's ``srt_counting_order`` behind the wrapper's signature
    (every version writes every count)."""
    def counting_order(ids: torch.Tensor, nv: int):
        n = ids.shape[0]
        order = torch.empty(n, dtype=torch.int32, device=ids.device)
        counts = torch.empty(nv, dtype=torch.int32, device=ids.device)
        scratch = torch.empty(lib.srt_counting_order_scratch(n, nv),
                              dtype=torch.int32, device=ids.device)
        rc = lib.srt_counting_order(
            ids.data_ptr(), n, nv, scratch.data_ptr(), order.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"counting_order launch failed: CUDA error "
                               f"{rc}")
        return order, counts
    return counting_order


def _ptxas(paths: dict) -> None:
    """Each source of ``paths`` (name -> path) compiled with ``ptxas -v``,
    all together; prints the counting-order kernels' lines."""
    from spark_rapids_tpu_torch import native
    procs = {name: subprocess.Popen(
        [native._nvcc(), *native._NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_out_dir() / f"ptxas_{i}.o"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, path) in enumerate(paths.items())}
    for name, proc in procs.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(out)
        entry = ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "co_" in entry and re.search(r"Used \d+ registers|spill",
                                              line):
                print(f"# ptxas {name} {entry}: {line.strip()}", flush=True)


def _profile_kernels(label: str, fn, sets: list, nv: int,
                     card: str) -> None:
    """Each device kernel and memset of one call of ``fn``, averaged over
    a call on each input set under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*sets[0], nv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for (ids,) in sets:
            fn(ids, nv)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            m = re.search(r"co_[a-z_]+|[Mm]emset\w*", e.key)
            parts.append((e.self_device_time_total / 1e3 / len(sets),
                          m.group(0) if m else e.key[:40]))
    print(f"# profile {label}: " + "; ".join(
        f"{name} {ms:.6f} ms" for ms, name in sorted(parts, reverse=True))
        + f"; {card}", flush=True)


_SPLIT = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import spark_rapids_tpu_torch
from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.parallel.mesh import virtual_mesh
from spark_rapids_tpu_torch.tools import tpch
print(f"# split with {spark_rapids_tpu_torch.__file__}", flush=True)
native.load_kernels()
tables = {"customer": tpch.gen_customer(1.0, seed=2),
          "orders": tpch.gen_orders(1.0, seed=1),
          "lineitem": tpch.gen_lineitem(1.0, seed=0)}
mesh = virtual_mesh(cs.MX_SHARDS, "cuda:0")
out = cs.exchange_chunk_split(tables, 2, mesh, sys.argv[3])
print("SPLIT " + json.dumps({"chunk": out["chunk"], "total": out["total"],
                             "device": out["device"]}), flush=True)
"""


def _split(other_root: str, card: str) -> dict:
    """The exchange chunk split with OTHER_ROOT's package, this checkout's
    twice, OTHER_ROOT's again: a process each."""
    runs = {}
    for name, root in (("other", other_root), ("committed", str(_HERE)),
                       ("committed", str(_HERE)), ("other", other_root)):
        label = f"{name} ({root})"
        proc = subprocess.run(
            [sys.executable, "-c", _SPLIT, str(Path(root).resolve()),
             str(_HERE / "chip_smoke.py"), label],
            capture_output=True, text=True, timeout=1200)
        for line in proc.stdout.splitlines():
            if line.startswith("SPLIT "):
                runs.setdefault(name, []).append(json.loads(line[6:]))
            else:
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            raise RuntimeError(f"the split with {root} failed")
        print(f"# split {label} done; {card}", flush=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another shuffle.cu to time (repeatable)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--split", metavar="OTHER_ROOT")
    ap.add_argument("--profile", action="store_true",
                    help="each version's device time by kernel "
                    "(torch.profiler) at each size")
    ap.add_argument("--phases", action="store_true",
                    help="the committed co_rank_scatter's steps, timed "
                    "inside each block")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shuffle_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.shuffle.manager import (
        counting_order, counting_order_reference)
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "shuffle.cu"
    variants = dict(v.split("=", 1) for v in args.variant)
    ptxas = {"committed": committed, **variants}
    texts = {name: Path(path).read_text() for name, path in variants.items()}
    if args.limits:
        base = committed.read_text()
        for limit, edits in LIMITS.items():
            text = base
            for old, new in edits:
                if text.count(old) != 1:
                    raise AssertionError(f"{limit}: the source changed; "
                                         "update the variant")
                text = text.replace(old, new)
            texts[limit] = text
            ptxas[limit] = _out_dir() / (re.sub(r"\W+", "_", limit) + ".cu")
            ptxas[limit].write_text(text)
    if args.ptxas:
        _ptxas(ptxas)
    if args.phases:
        texts["phases"] = _phase_source(committed.read_text())
    versions = {"committed": counting_order, **_build_all(texts)}
    if args.phases:
        versions.pop("phases")
        _phases(_out_dir() / "phases.so", card)
    rng = np.random.default_rng(16)
    result = {"card": card, "times": {}}
    for n in cs.SHUFFLE_SIZES:
        for p in cs.SHUFFLE_PARTS:
            reps = max(2, min(12, -(-4 * cs.L2_BYTES // (4 * n))))
            sets = [(torch.from_numpy(rng.integers(0, p + 1, n).astype(
                np.int32)).cuda(),) for _ in range(reps)]
            label = f"counting_order n={n} P={p}"
            for name, fn in versions.items():
                for (ids,) in sets[:2]:
                    order, counts = fn(ids, p + 1)
                    r_order, r_counts = counting_order_reference(ids, p + 1)
                    torch.cuda.synchronize()
                    if not (torch.equal(order, r_order)
                            and torch.equal(counts, r_counts)
                            and torch.equal(order.long(), torch.argsort(
                                ids, stable=True))):
                        raise AssertionError(f"{label}, {name}: not the "
                                             "plain version's order")
            print(f"# {label}: {', '.join(versions)} equal the plain "
                  "version and argsort", flush=True)
            if args.profile:
                for name, fn in versions.items():
                    _profile_kernels(f"{label} {name}", fn, sets, p + 1,
                                     card)
            if args.check_only:
                continue
            fns = {name: (lambda f: lambda i: f(i, p + 1))(fn)
                   for name, fn in versions.items()}
            fns["torch.argsort(stable=True)"] = \
                lambda i: torch.argsort(i, stable=True)
            order = list(fns) + list(fns)[::-1]
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(cs._graph_ms(fns[name], sets))
            bound = (8 * n + 4 * (p + 1)) / cs.MEM_BYTES_PER_S * 1e3
            result["times"][label] = {"bound_ms": bound, "ms": times}
            for name, ts in times.items():
                mean_ms = sum(ts) / len(ts)
                print(f"# {label} {name}: {ts[0]:.6f} / {ts[1]:.6f} ms "
                      f"(mean {mean_ms:.6f} ms), bound {bound:.6f} ms "
                      f"(bytes), {100 * bound / mean_ms:.1f} % of the "
                      f"bound; {card}", flush=True)
            del sets
            torch.cuda.empty_cache()
    if args.split:
        result["split"] = _split(args.split, card)
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
