#!/usr/bin/env python3
"""The window kernels of ``csrc/window.cu`` beside an earlier version of the
source, on one NVIDIA card.

    python3 window_kernel_ab.py [--variant NAME=OTHER.cu ...] [--limits]
                                [--ptxas] [--check-only]

Times ``seg_scan`` and ``frame_reduce`` on ``chip_smoke.py
_window_timed_sets`` inputs (CUDA graphs over inputs larger than L2) at the
row counts the window queries launch them at on one card: W2's 2^23 rows
(lineitem in 4 segments), W1's 2^21 (orders by customer, segments of about
15 rows) and W3's 2^18 (part by brand). At each: the float64 running sum
of ``seg_scan``, its reverse int64 min of the next segment starts (beside
the reverse ``torch.cummin`` it replaced), and at 2^21 ``frame_reduce``'s
float64 sums over ROWS -3..1 (its length given, so no block aggregates)
and over RANGE -90..0 days (the block aggregates built), each beside the
bound ``chip_smoke.py`` states for it:

- the kernels as built from ``spark_rapids_tpu_torch/csrc``, through their
  wrappers;
- ``--variant NAME=PATH`` (repeatable): the same entry points built from
  another copy of ``window.cu`` (for example the version before the
  redesign, written out of git into a directory that ``.gitignore``
  lists). A source whose ``srt_seg_scan`` takes no direction is timed on
  the forward scan only, and one whose ``srt_frame_reduce`` takes no
  frame length builds its block aggregates on every call;
- ``--limits``: the committed source built with one thing of ``seg_scan``
  changed, each named by what it shows: without its look-back (every
  carry-in the identity: wrong by design, not checked), with every level
  of the look-back polled by one warp in turn, with tiles taken by
  ``blockIdx`` instead of the counter, and with 8 rows a thread at the
  registers that allow (63: four blocks an SM).

Every version is first held against the plain version on each input set
(integers and min/max by bits, float sums within ``chip_smoke.py``'s
bounds and the same bits over three runs), then timed in turns (the list,
then the list reversed); the card's name and power limit are printed
beside the times. ``--ptxas`` prints each window kernel's registers,
shared memory and spills as ``ptxas -v`` reports them; ``--check-only``
stops after the checks.
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

# variant name -> ([(text, replacement)], checked), each text occurring
# once in the committed source
LIMITS = {
    "no look-back": ([(
        "  look_back<T, OP>(tile, tiles, tf, tv, slots + 1, &s_cf, &s_cv);",
        "  if (threadIdx.x == 0) {\n    s_cf = false;\n"
        "    s_cv = identity<T, OP>();\n  }\n  __syncthreads();")], False),
    "levels by one warp": ([(
        "    if (levels % kWarps == warp) {", "    if (warp == 0) {")], True),
    "tiles by blockIdx": ([(
        "s_tile = atomicAdd(reinterpret_cast<unsigned*>(slots), 1u);",
        "s_tile = blockIdx.x;")], True),
    "8 rows a thread, 4 blocks an SM": ([
        ("constexpr int kItems = 16;", "constexpr int kItems = 8;"),
        ("__global__ void __launch_bounds__(kThreads, 3)\n"
         "    seg_scan_kernel(",
         "__global__ void __launch_bounds__(kThreads)\n"
         "    seg_scan_kernel(")], True),
}

#: the window queries' row counts on one card and their segments: (input
#: rows, mean segment rows or minus their number)
SHAPES = {"W2": (1 << 23, 6_000_000, -4), "W1": (1 << 21, 1_500_000, 15),
          "W3": (1 << 18, 200_000, 8000)}


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab_window"
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
    return {name: _bind(ctypes.CDLL(str(so)), texts[name])
            for name, so in sos.items()}


def _bind(lib: ctypes.CDLL, text: str) -> ctypes.CDLL:
    """The entry points' argument types (``reverse`` and ``max_len`` where
    the source takes them)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.has_reverse = "int reverse" in text
    lib.has_max_len = "int64_t max_len" in text
    lib.srt_seg_scan.argtypes = [ptr, ptr, i64, i32, i32] + (
        [i32] if lib.has_reverse else []) + [ptr, ptr, ptr]
    lib.srt_frame_reduce.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32] + (
        [i64] if lib.has_max_len else []) + [ptr, ptr, ptr, ptr]
    lib.srt_seg_scan_scratch_bytes.argtypes = [i64]
    lib.srt_frame_reduce_scratch_bytes.argtypes = [i64] + (
        [i64] if lib.has_max_len else [])
    for fn in (lib.srt_seg_scan, lib.srt_frame_reduce):
        fn.restype = ctypes.c_int
    for fn in (lib.srt_seg_scan_scratch_bytes,
               lib.srt_frame_reduce_scratch_bytes):
        fn.restype = ctypes.c_int64
    return lib


def _ptxas(paths: dict) -> None:
    """Each source of ``paths`` (name -> path) compiled with ``ptxas -v``,
    all together; prints the window kernels' lines."""
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
            elif re.search(r"seg_scan|frame_tables|frame_reduce", entry) \
                    and re.search(r"Used \d+ registers|spill", line):
                print(f"# ptxas {name} {entry}: {line.strip()}", flush=True)


def _launchers(lib: ctypes.CDLL) -> dict:
    """A library's two kernels behind the wrappers' signatures."""
    from spark_rapids_tpu_torch.exec import window_kernels as wk

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def seg_scan(values, flags, op, reverse=False):
        n = values.shape[0]
        out = torch.empty_like(values)
        scratch = torch.empty(lib.srt_seg_scan_scratch_bytes(n),
                              dtype=torch.uint8, device=values.device)
        direction = [int(reverse)] if lib.has_reverse else []
        rc = lib.srt_seg_scan(
            values.data_ptr(), None if flags is None else flags.data_ptr(),
            n, wk._SCAN_DTYPES[values.dtype], wk.OPS[op], *direction,
            scratch.data_ptr(), out.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"seg_scan launch failed: CUDA error {rc}")
        return out

    def frame_reduce(values, valid, lo, hi, op, max_len=None):
        n = values.shape[0]
        limit = [-1 if max_len is None else max_len] if lib.has_max_len \
            else []
        out = torch.empty_like(values)
        count = torch.empty(n, dtype=torch.int64, device=values.device)
        scratch = torch.empty(lib.srt_frame_reduce_scratch_bytes(n, *limit),
                              dtype=torch.uint8, device=values.device)
        rc = lib.srt_frame_reduce(
            values.data_ptr(), valid.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            n, int(values.is_floating_point()), wk.OPS[op], *limit,
            scratch.data_ptr(), out.data_ptr(), count.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"frame_reduce launch failed: CUDA error {rc}")
        return out, count

    return {"seg_scan": seg_scan, "frame_reduce": frame_reduce,
            "reverse": lib.has_reverse}


def _check(label: str, case: str, fn, args) -> None:
    """One version on one input set against the plain version, a float
    sum three times by bits."""
    from spark_rapids_tpu_torch.exec import window_kernels as wk
    if case.startswith("seg_scan"):
        v, f, op = args[:3]
        reverse = len(args) > 3 and args[3]
        got = fn(*args)
        for _ in range(2):
            cs._window_equal(f"{label} (repeat)", fn(*args), got)
        tol = cs._scan_sum_tolerance(
            wk.seg_scan_reference(v.abs().double(), f, "add", reverse), f,
            v.dtype, reverse) if op == "add" else None
        cs._window_equal(label, got, wk.seg_scan_reference(*args), tol)
        return
    v, ok, lo, hi, op, _ = args
    got, count = fn(*args)
    for _ in range(2):
        cs._window_equal(f"{label} (repeat)", fn(*args)[0], got)
    want, wcount = wk.frame_reduce_reference(*args)
    cs._window_equal(f"{label} counts", count, wcount)
    tol = cs._float_sum_tolerance(
        wk.frame_reduce_reference(v.abs(), ok, lo, hi, "add")[0], hi - lo,
        v.dtype)
    cs._window_equal(label, got, want, tol)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another window.cu to time (repeatable)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec import window_kernels as wk
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "window.cu"
    variants = dict(v.split("=", 1) for v in args.variant)
    ptxas = {"committed": committed, **variants}
    versions = {"committed": {"seg_scan": wk.seg_scan,
                              "frame_reduce": wk.frame_reduce,
                              "reverse": True}}
    texts = {name: Path(path).read_text() for name, path in variants.items()}
    checked = {name: True for name in ["committed", *texts]}
    if args.limits:
        base = committed.read_text()
        for limit, (edits, exact) in LIMITS.items():
            text = base
            for old, new in edits:
                if text.count(old) != 1:
                    raise AssertionError(f"{limit}: the source changed; "
                                         "update the variant")
                text = text.replace(old, new)
            texts[limit] = text
            checked[limit] = exact
            ptxas[limit] = _out_dir() / (re.sub(r"\W+", "_", limit) + ".cu")
            ptxas[limit].write_text(text)
    if args.ptxas:
        _ptxas(ptxas)
    for name, lib in _build_all(texts).items():
        versions[name] = _launchers(lib)
    rng = np.random.default_rng(13)
    result = {"card": card, "times": {}}
    for query, (n, rows, mean) in SHAPES.items():
        flags = cs._main_flags(rng, n, rows, mean)
        names = ("seg_scan", "frame_reduce") if query == "W1" \
            else ("seg_scan",)
        sets, per_set = cs._window_timed_sets(rng, n, "cuda", names, flags)
        for case, arg_sets in sets.items():
            label = f"{case} at {n} rows ({query}'s shape)"
            kernel = case.split()[0]
            fns = {name: v[kernel] for name, v in versions.items()
                   if (case != "seg_scan reverse" or v["reverse"])
                   and (kernel == "seg_scan" or name not in LIMITS)}
            for name, fn in fns.items():
                for a in arg_sets[:2]:
                    if checked[name]:
                        _check(f"{label}, {name}", case, fn, a)
            torch.cuda.synchronize()
            print(f"# {label}: "
                  f"{', '.join(n for n in fns if checked[n])} equal the "
                  "plain version", flush=True)
            if args.check_only:
                continue
            if case == "seg_scan reverse":
                fns["reverse torch.cummin"] = cs._reverse_cummin
            order = list(fns) + list(fns)[::-1]
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(cs._graph_ms(fns[name], arg_sets))
            bound = per_set[case] / cs.MEM_BYTES_PER_S * 1e3
            result["times"][label] = {"bound_ms": bound, "ms": times}
            for name, ts in times.items():
                mean_ms = sum(ts) / len(ts)
                print(f"# {label} {name}: {ts[0]:.6f} / {ts[1]:.6f} ms "
                      f"(mean {mean_ms:.6f} ms), bound {bound:.6f} ms "
                      f"(bytes), {100 * bound / mean_ms:.1f} % of the bound",
                      flush=True)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
