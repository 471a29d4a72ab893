#!/usr/bin/env python3
"""The two redesigned Parquet decode kernels beside an earlier version and
beside variants with part of their work taken out, on one NVIDIA card.

    python3 parquet_kernel_ab.py [--variant NAME=OTHER.cu ...] [--limits]
                                 [--ptxas] [--check-only]

Times ``pq_expand_hybrid`` (2^20 outputs at widths 1 and 4) and
``pq_gather_byte_array`` (2^20 rows of width 8 from 3 dictionary values,
and of width 64 with 70 % plain values) on ``chip_smoke.py``'s timed
inputs (CUDA graphs over inputs larger than L2), beside the bound
``chip_smoke.py`` states for them:

- the kernels as built from ``spark_rapids_tpu_torch/csrc``, through their
  wrappers, each held exactly against its plain version on every input;
- ``--variant NAME=PATH`` (repeatable): the same two entry points built
  from another copy of ``parquet_decode.cu`` (for example the version
  before the redesign, written out of git into a directory that
  ``.gitignore`` lists), held against the plain versions too;
- ``--limits``: variants of the committed source built with one part of a
  kernel's work taken out (its word or byte reads, its stores, its search,
  all of it); their results are wrong by design and are not checked.

Each version is timed in turns (the list, then the list reversed), and the
card's name and power limit are printed beside the times. ``--ptxas``
prints each kernel's registers and shared memory as ``ptxas -v`` reports
them; ``--check-only`` stops after the exactness checks.
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

# variant name -> [(source text, replacement)], each text occurring once
LIMITS = {
    "expand: no word reads": [(
        "    field = __funnelshift_r(__ldg(words + k), __ldg(words + k + 1),\n"
        "                            (uint32_t)(bit & 31)) & "
        "(0xFFFFFFFFu >> shift);",
        "    field = ((uint32_t)k ^ (uint32_t)(uintptr_t)words) & "
        "(0xFFFFFFFFu >> shift);"), (
        "      vals[j] = (int32_t)(__funnelshift_r(__ldg(words + k),\n"
        "                                          __ldg(words + k + 1), o)",
        "      vals[j] = (int32_t)((k ^ (uint32_t)(uintptr_t)words) + o")],
    "expand: no search": [(
        "  int64_t lo = 0, span = R;\n",
        "  int64_t lo = t0 / 512 < R ? t0 / 512 : R - 1, span = 0;\n")],
    "expand: no stores": [(
        "  if (i0 + kPerThread <= cap) {\n    int4* dst",
        "  if (vals[0] == 0x13572468 && i0 + kPerThread <= cap) {\n"
        "    int4* dst"), (
        "  } else {\n#pragma unroll\n    for (int j = 0; j < kPerThread; ++j)"
        "\n      if (i0 + j < cap) out[i0 + j] = vals[j];",
        "  } else if (vals[1] == 0x13572468) {\n#pragma unroll\n"
        "    for (int j = 0; j < kPerThread; ++j)\n"
        "      if (i0 + j < cap) out[i0 + j] = vals[j];")],
    "expand: empty": [(
        "  __shared__ RunSlice s;\n",
        "  __shared__ RunSlice s;\n  if (cap > 0) return;\n")],
    "gather: no blob reads": [(
        "    const uint4 lo = inside[j] ? __ldg(piece) : zero;",
        "    const uint4 lo = make_uint4((uint32_t)src, 1u, 2u, 3u);"), (
        "                         ? __ldg(piece + 1) : zero;",
        "                         ? make_uint4(4u, 5u, 6u, 7u) : zero;")],
    "gather: no stores": [(
        "  if (c0 == 0) {\n    if (whole) {",
        "  if (c0 == 0 && len[0] == 0x13572468) {\n    if (whole) {"), (
        "  if (width == 8 && whole) {",
        "  if (len[1] == 0x13572468) return;\n  if (width == 8 && whole) {")],
    "gather: empty": [(
        "  if (t >= groups * granules) return;",
        "  if (t >= 0) return;")],
}


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _build(name: str, text: str) -> ctypes.CDLL:
    """``text`` as a shared library with the argument types of the entry
    points it declares (with or without ``n_blob``)."""
    from spark_rapids_tpu_torch import native
    src = _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")
    so = src.with_suffix(".so")
    src.write_text(text)
    subprocess.run([native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_pq_expand_hybrid.argtypes = [ptr, i32, ptr, i64, i64, ptr, ptr]
    lib.n_blob = "int64_t n_blob" in text
    lib.srt_pq_gather_byte_array.argtypes = [
        ptr, ptr, ptr, i64, ptr, ptr, ptr] + [i64] * (7 + lib.n_blob) + [
        ptr, ptr, ptr]
    for fn in (lib.srt_pq_expand_hybrid, lib.srt_pq_gather_byte_array):
        fn.restype = ctypes.c_int
    return lib


def _ptxas(name: str, path: Path) -> None:
    from spark_rapids_tpu_torch import native
    out = subprocess.run(
        [native._nvcc(), *native._NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_out_dir() / "ptxas.o"), str(path)], capture_output=True,
        text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    for line in (out.stdout + out.stderr).splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print(f"# ptxas {name}: {line.strip()}", flush=True)


def _launchers(lib: ctypes.CDLL) -> dict:
    """A library's two entry points behind the wrappers' signatures."""
    from spark_rapids_tpu_torch.io.parquet_kernels import pow2_ceil

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def expand(runs, packed, n_packed, cap):
        out = torch.empty(cap, dtype=torch.int32, device=runs.device)
        rc = lib.srt_pq_expand_hybrid(runs.data_ptr(), runs.shape[1],
                                      packed.data_ptr(), n_packed, cap,
                                      out.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    def gather(valid, pos, idx, starts, lens, blob, n_blob, n_dict, d,
               width):
        cap = valid.numel()
        data = torch.empty((cap, width), dtype=torch.uint8,
                           device=valid.device)
        lengths = torch.empty(cap, dtype=torch.int32, device=valid.device)
        p = starts.numel() - d
        rc = lib.srt_pq_gather_byte_array(
            valid.data_ptr(), pos.data_ptr(), idx.data_ptr(), idx.numel(),
            starts.data_ptr(), lens.data_ptr(), blob.data_ptr(),
            *([n_blob] if lib.n_blob else []), n_dict, d, pow2_ceil(d), p,
            pow2_ceil(p), cap, width, data.data_ptr(), lengths.data_ptr(),
            stream())
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return data, lengths

    return {"expand": expand, "gather": gather}


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another parquet_decode.cu to time (repeatable)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parquet_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io.parquet_kernels import (
        pq_expand_hybrid, pq_expand_hybrid_reference, pq_gather_byte_array)
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "parquet_decode.cu"
    variants = dict(v.split("=", 1) for v in args.variant)
    if args.ptxas:
        _ptxas("committed", committed)
        for name, path in variants.items():
            _ptxas(name, Path(path))
    versions = {"kernel": {"expand": pq_expand_hybrid,
                           "gather": pq_gather_byte_array}}
    for name, path in variants.items():
        versions[name] = _launchers(_build(name, Path(path).read_text()))
    limits = {}
    if args.limits:
        source = committed.read_text()
        for name, edits in LIMITS.items():
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise AssertionError(f"{name}: the source changed; "
                                         "update the variant")
                text = text.replace(old, new)
            limits[name] = _launchers(_build(name, text))
    rng = np.random.default_rng(11)
    shapes = {f"pq_expand_hybrid w{w}": (
        "expand", pq_expand_hybrid_reference,
        lambda w=w: cs._pq_expand_set(rng, w)) for w in (1, 4)}
    for w, d, share in ((8, 3, 1.0), (64, 1000, 0.3)):
        shapes[f"pq_gather_byte_array w{w}"] = (
            "gather", cs._pq_ba_reference,
            lambda w=w, d=d, s=share: cs._pq_ba_set(rng, w, d, s))
    result = {"card": card, "times": {}}
    for label, (kind, ref, make) in shapes.items():
        sets, nbytes = cs._pq_sets(make)
        for args_ in sets:
            want = ref(*args_)
            for name, fns in versions.items():
                if not _same(fns[kind](*args_), want):
                    raise AssertionError(f"{label}: {name} != plain")
            torch.cuda.synchronize()
        print(f"# {label}: " + ", ".join(versions)
              + f" equal to the plain version (exact) on {len(sets)} input "
              "sets", flush=True)
        if args.check_only:
            continue
        runs = dict(versions)
        runs.update({n: f for n, f in limits.items()
                     if n.startswith(kind)})
        order = list(runs) + list(runs)[::-1]
        times = {n: [] for n in runs}
        for name in order:
            times[name].append(cs._graph_ms(runs[name][kind], sets))
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
