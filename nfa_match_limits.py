#!/usr/bin/env python3
"""Where the ``nfa_match`` kernel's time goes, on one NVIDIA card.

    python3 nfa_match_limits.py

Times, on the inputs ``chip_smoke.py`` times it on (1 << 20 rows of width
128 under Q13's and Q16's LIKE patterns, CUDA graphs over inputs larger
than L2), the kernel as built from ``spark_rapids_tpu_torch/csrc`` and two
variants compiled from the same source with one half of its work taken
out: "no walk" stages every row through shared memory and steps no byte;
"no copy" issues no row copy and walks whatever the buffers hold, with the
rows' own lengths. Their results are wrong by design and are not checked;
the kernel's are held against its plain version. Each is timed in turns
(kernel, no walk, no copy, then the reverse), and the card's name and power
limit are printed beside them.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

# source text -> the variant's text (each must occur exactly once)
VARIANTS = {
    "no walk": ("    if (active && len > lo) {",
                "    if (active && len > lo && p.n < 0) {"),
    "no copy": ("      cp_async16(buf + r * Chunk<C>::kSlot + 16 * q, "
                "src + 16 * q);",
                "      if (p.n < 0) cp_async16(buf + r * Chunk<C>::kSlot + "
                "16 * q, src + 16 * q);"),
}


def _build(name: str, text: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "limits"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name.replace(' ', '_')}.cu"
    so = src.with_suffix(".so")
    src.write_text(text)
    subprocess.run([native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, timeout=600)
    variant = ctypes.CDLL(str(so))
    variant.srt_nfa_match.argtypes = lib.srt_nfa_match.argtypes
    variant.srt_nfa_match.restype = ctypes.c_int
    return variant


def main() -> int:
    if not torch.cuda.is_available():
        print("nfa_match_limits: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.udf.kernels import nfa_match
    print(cs._card_line(), flush=True)
    lib = native.load_kernels()
    source = (native._SRC_DIR / "nfa_match.cu").read_text()
    libs = {"kernel": lib}
    for name, (old, new) in VARIANTS.items():
        if source.count(old) != 1:
            raise AssertionError(f"{name}: the source changed; update the "
                                 "variant")
        libs[name] = _build(name, source.replace(old, new), lib)
    rng = np.random.default_rng(7)
    pats = cs._nfa_patterns()
    n, w = 1 << 20, 128
    base_v, base_ln = cs._nfa_rows(1 << 14, w, rng)
    try:
        for label in ("Q13 LIKE", "Q16 LIKE"):
            nfa = pats[label]
            sets = []
            for _ in range(max(1, math.ceil(2 * cs.L2_BYTES / (n * w)))):
                pick = torch.from_numpy(
                    rng.integers(0, len(base_ln), n)).cuda()
                sets.append(cs._nfa_args(
                    nfa, torch.from_numpy(base_v).cuda()[pick].contiguous(),
                    torch.from_numpy(base_ln).cuda()[pick].contiguous()))
            native._LIB = lib
            cs._check_nfa(sets[0], f"{label} timing set 0")
            ms = {k: [] for k in libs}
            for order in (list(libs), list(reversed(libs))):
                for k in order:
                    native._LIB = libs[k]
                    ms[k].append(cs._graph_ms(nfa_match, sets))
            print(f"# nfa_match limits, {label}, {n} rows of width {w}: "
                  + ", ".join(f"{k} {' / '.join(f'{t:.6f}' for t in v)} ms"
                              for k, v in ms.items()), flush=True)
    finally:
        native._LIB = lib
    print(cs._card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
