#!/usr/bin/env python3
"""The segment-sum kernel of ``csrc/decimal128.cu`` beside an earlier
version of the source and beside variants with part of their work taken
out or changed, on one NVIDIA card.

    python3 decimal_kernel_ab.py [--variant NAME=OTHER.cu ...] [--limits]
                                 [--ptxas] [--check-only]

Times ``d128_segment_sum`` at 2^20 rows on ``chip_smoke.py``'s timed inputs
(CUDA graphs over inputs larger than L2): limbs at cap 1 (Q6's grand
total), 6 (Q1's groups), 16, 2^16 and 2^20 with 4 groups used (Q1's
partial sums, whose cap is the batch's capacity), and scaled int64 at cap
6, each beside the bound ``chip_smoke.py`` states for it (21 bytes a row
of limbs, 13 of int64, and 17 a group):

- the kernel as built from ``spark_rapids_tpu_torch/csrc``, through its
  wrapper, held exactly against the plain version on every input;
- ``--variant NAME=PATH`` (repeatable): the same entry point built from
  another copy of ``decimal128.cu`` (for example the version before the
  redesign, written out of git into a directory that ``.gitignore``
  lists), held against the plain version too. A source without
  ``srt_d128_segment_sum_scratch`` takes a zeroed ``(cap, 3)`` accumulator,
  as its wrapper gave it;
- ``--limits``: variants built with one thing changed, each named by what
  it shows: of every ``--variant`` source, without its shared-memory
  atomics, without its blocks' flush to global memory, and with its
  accumulator left unzeroed; of the committed source, with 8 groups in
  registers at most (so cap 16 takes the atomics), with 8 rows a thread a
  step, with a grid of a step a thread instead of the blocks that fit at
  once, with 4 blocks an SM forced (registers capped), without its second
  launch, and with its row loop's adds taken out (its loads kept). The
  last two and the first three give wrong results by design and are not
  checked; the others are held exactly against the plain version.

Each version is timed in turns (the list, then the list reversed), and the
card's name and power limit are printed beside the times. ``--ptxas``
prints each kernel's registers, shared memory and spills as ``ptxas -v``
reports them; ``--check-only`` stops after the exactness checks.
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

# variant name -> (source: "variant" or "committed", [(text, replacement)],
# checked), each text occurring once in its source
LIMITS = {
    "no shared atomics": ("variant", [(
        "        atomic_add192(&slot_acc[3 * slot], v0, v1, v2);",
        "        slot_acc[3 * slot] += v0;\n"
        "        slot_acc[3 * slot + 1] += v1;\n"
        "        slot_acc[3 * slot + 2] += v2;")], False),
    "no block flush": ("variant", [(
        "    if (key >= 0) {\n      atomic_add192(",
        "    if (key >= 0 && n < 0) {\n      atomic_add192(")], False),
    "8 in registers": ("committed", [(
        "constexpr int kSmallCap = 16;", "constexpr int kSmallCap = 8;")],
        True),
    "8 rows a step": ("committed", [(
        "constexpr int kRows = 4;", "constexpr int kRows = 8;")], True),
    "a step a thread": ("committed", [(
        "  if (blocks > resident) blocks = resident;\n", "")], True),
    "4 blocks an SM": ("committed", [(
        "__global__ void __launch_bounds__(kThreads)\n"
        "d128_segsum_small_kernel(",
        "__global__ void __launch_bounds__(kThreads, 4)\n"
        "d128_segsum_small_kernel(")], True),
    "no second launch": ("committed", [(
        "  d128_segsum_partials_kernel<<<",
        "  if (n < 0) d128_segsum_partials_kernel<<<")], False),
    "no row adds": ("committed", [(
        "    for (int j = 0; j < kRows; ++j) add_row<K>(acc, g[j], lo[j], "
        "hi[j]);",
        "    for (int j = 0; j < kRows; ++j)\n"
        "      acc[0][0] ^= lo[j] ^ hi[j] ^ static_cast<u64>(g[j]);")],
        False),
}
#: the variants' entry points timed with the accumulator not zeroed
UNZEROED = "acc not zeroed"


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab_decimal"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _build(name: str, text: str) -> ctypes.CDLL:
    """``text`` as a shared library with its segment sum's argument
    types."""
    from spark_rapids_tpu_torch import native
    src = _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")
    so = src.with_suffix(".so")
    src.write_text(text)
    subprocess.run([native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, timeout=900)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_d128_segment_sum.argtypes = [ptr, i32, ptr, ptr, i32, i64, i64,
                                         i32, ptr, ptr, ptr, ptr]
    lib.srt_d128_segment_sum.restype = ctypes.c_int
    lib.scratch_api = "srt_d128_segment_sum_scratch" in text
    if lib.scratch_api:
        lib.srt_d128_segment_sum_scratch.argtypes = [i64, i64]
        lib.srt_d128_segment_sum_scratch.restype = i64
    return lib


def _ptxas(name: str, path: Path) -> None:
    from spark_rapids_tpu_torch import native
    out = subprocess.run(
        [native._nvcc(), *native._NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_out_dir() / "ptxas.o"), str(path)], capture_output=True,
        text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    entry = ""
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "segsum" in entry and re.search(r"Used \d+ registers|spill",
                                             line):
            print(f"# ptxas {name} {entry}: {line.strip()}", flush=True)


def _launcher(lib: ctypes.CDLL, zero: bool = True):
    """A library's segment sum behind the wrapper's signature."""

    def segsum(a, contrib, gid, cap, precision):
        n = a.shape[0]
        out = torch.empty((cap, 2), dtype=torch.int64, device=a.device)
        over = torch.empty(cap, dtype=torch.bool, device=a.device)
        if lib.scratch_api:
            scratch = torch.empty(lib.srt_d128_segment_sum_scratch(n, cap),
                                  dtype=torch.int64, device=a.device)
        else:
            scratch = (torch.zeros if zero else torch.empty)(
                (cap, 3), dtype=torch.int64, device=a.device)
        rc = lib.srt_d128_segment_sum(
            a.data_ptr(), int(a.dim() == 2), contrib.data_ptr(),
            gid.data_ptr(), int(gid.dtype == torch.int64), n, cap,
            precision, scratch.data_ptr(), out.data_ptr(), over.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out, over

    return segsum


def _shapes(rng, n: int) -> list:
    """(label, argument sets, (cap, precision), bytes) of each timed
    shape: ``chip_smoke.py``'s segment-sum shapes, and cap 16."""
    shapes = [(label, sets, extra, nbytes) for _, label, kind, sets, extra,
              nbytes in cs.d128_timed_shapes(rng, n, "cuda")
              if kind == "segment_sum"]
    gid = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).cuda()
    sets16 = [(a, c, gid) for a, c, _ in shapes[0][1]]
    shapes.append(("d128_segment_sum n=2^20 limbs, cap 16", sets16,
                   (16, 38), (16 + 1 + 4) * n + 17 * 16))
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another decimal128.cu to time (repeatable)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decimal_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.expr import decimal128 as d
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "decimal128.cu"
    variants = dict(v.split("=", 1) for v in args.variant)
    if args.ptxas:
        _ptxas("committed", committed)
        for name, path in variants.items():
            _ptxas(name, Path(path))
    versions = {"kernel": d.d128_segment_sum}
    sources = {"committed": committed.read_text()}
    for name, path in variants.items():
        sources[name] = Path(path).read_text()
        lib = _build(name, sources[name])
        versions[name] = _launcher(lib)
        if args.limits and not lib.scratch_api:
            versions[f"{name}: {UNZEROED}"] = _launcher(lib, zero=False)
    checked = {n: True for n in versions}
    checked.update({n: False for n in versions if n.endswith(UNZEROED)})
    if args.limits:
        for limit, (which, edits, exact) in LIMITS.items():
            for src in (["committed"] if which == "committed"
                        else list(variants)):
                text = sources[src]
                for old, new in edits:
                    if text.count(old) != 1:
                        raise AssertionError(f"{limit}: the source changed; "
                                             "update the variant")
                    text = text.replace(old, new)
                name = f"{src}: {limit}"
                if args.ptxas:
                    path = _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")
                    path.write_text(text)
                    _ptxas(name, path)
                versions[name] = _launcher(_build(name, text))
                checked[name] = exact
    rng = np.random.default_rng(11)
    result = {"card": card, "times": {}}
    for label, sets, extra, nbytes in _shapes(rng, cs.D128_ROWS):
        for args_ in sets:
            want = d.d128_segment_sum_reference(*args_, *extra)
            for name, fn in versions.items():
                if checked[name] and not all(
                        torch.equal(g, w)
                        for g, w in zip(fn(*args_, *extra), want)):
                    raise AssertionError(f"{label}: {name} != plain")
            torch.cuda.synchronize()
        print(f"# {label}: " + ", ".join(n for n in versions if checked[n])
              + f" equal to the plain version (exact) on {len(sets)} input "
              "sets", flush=True)
        if args.check_only:
            continue
        order = list(versions) + list(versions)[::-1]
        times = {n: [] for n in versions}
        for name in order:
            times[name].append(cs._graph_ms(
                lambda *a, fn=versions[name]: fn(*a, *extra), sets))
        bound = nbytes / cs.MEM_BYTES_PER_S * 1e3
        result["times"][label] = {"bound_ms": bound, "ms": times}
        for name, ts in times.items():
            mean = sum(ts) / len(ts)
            print(f"# {label} {name}: {ts[0]:.6f} / {ts[1]:.6f} ms (mean "
                  f"{mean:.6f} ms), bound {bound:.6f} ms (bytes), "
                  f"{100 * bound / mean:.1f} % of the bound", flush=True)
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
