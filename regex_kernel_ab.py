#!/usr/bin/env python3
"""The ``regex_replace`` and ``regex_extract`` kernels of ``csrc/regex.cu``
beside other versions of the source, on one NVIDIA card.

    python3 regex_kernel_ab.py [--variant NAME=OTHER.cu ...]
                               [--thread-a-row PATH] [--limits] [--ptxas]
                               [--check-only]

Times the kernels, in CUDA graphs over input sets larger than L2, each
beside its byte bound (the whole 32-byte sectors holding the bytes within
the rows' lengths, ``chip_smoke.py _parse_bound_bytes``, the lengths, the
output rows and lengths), at these shapes:

- ST1's four timed cases (``chip_smoke.py ST1_TIMED``) at 2^20 rows of
  width 128 (``_st1_rows``: letters, digits, '-' and spaces, lengths
  uniform over 1..128);
- the same patterns at the widths ST1's queries launch them at
  (``ST1_WIDTHS``, as ``chip_smoke.py st1_phase`` prints them: o_comment
  and p_name 64, c_phone 16);
- the four at 2^23 rows of width 128;
- a match as long as the row: '[a-z0-9 -]+' -> '#' (its class holds the
  whole alphabet) at 2^20 x 128.

The versions: the kernels as built from ``spark_rapids_tpu_torch/csrc``,
through their wrappers; ``--variant NAME=PATH`` (repeatable), the same
entry points built from another copy of ``regex.cu``; ``--thread-a-row
PATH``, the first port's source (one thread a row for both kernels,
stepping the NFA's successor sets; written out of git, ``git show
7cd351c:spark_rapids_tpu_torch/csrc/regex.cu``, into ``.scratch/``, which
``.gitignore`` lists), as a variant named ``thread a row``. ``--limits``
adds the committed source with one thing changed, each named by what it
shows: without its output rows' stores; without its matcher (every start
a non-match: reads, copies and, in regex_extract, staging and the
ballots alone); and, with ``--thread-a-row``, the first port's kernels
reading rows that each block first stages coalesced through shared
memory (how much of their time was their reads, and how much their
divergence).

Every version that computes the same function is first held against the
plain version bit for bit (at 2^23 rows on the first 2^20 of them, and
against the committed kernel on all), then all are timed in turns (the
list, then the list reversed). ``--ptxas`` prints each span kernel's
registers, stack frame and spills as ``ptxas -v`` reports them;
``--check-only`` stops after the checks. The card's name and power limit
are printed beside every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

#: the widths of the matrices ST1's queries launch each timed case's
#: kernel on (chip_smoke.py st1_phase prints them): o_comment and p_name
#: 64, c_phone 16; regex_extract at both (4 and 16 lanes a row)
ST1_WIDTHS = [("regex_replace", 64), ("regex_replace template", 16),
              ("regex_extract", 16), ("regex_extract", 64),
              ("delim_select", 64)]
#: a pattern whose matches run to the row's end on ST1's alphabet
LONG_MATCH = ("[a-z0-9 -]+", "#")
SIZES = (1 << 20, 1 << 23)
# the variants that compute another function: timed, not checked
_INEXACT = ("without",)

_STORE = ("  __device__ __forceinline__ void store(int chunk, uint64_t a,\n"
          "                                        uint64_t b) {\n")
_NO_STORES = [
    (_STORE, _STORE + "    if (row != nullptr) return;\n"),
    ("        store_row<G, W>(st.out,",
     "        if (out == nullptr) store_row<G, W>(st.out,"),
    ("        store_row<G, 1>(row + gs,",
     "        if (out == nullptr) store_row<G, 1>(row + gs,")]
_LONGEST = ("  template <class Row>\n  __device__ int longest_from(Row& row, "
            "int j, int len, int alt) const {\n")
_NO_MATCHER = [(_LONGEST, _LONGEST + "    if (j >= 0) return -1;\n")]
#: the thread-a-row source with each block's rows staged through shared
#: memory, neighbouring threads on neighbouring 16-byte pieces, before one
#: thread a row walks its row from there
_STAGE_BLOCK = """  return len < 0 ? 0 : (len > width ? width : len);
}

// a row of up to 144 bytes at any offset within a piece
constexpr int kSlot = 160;

__device__ void stage_block(uint8_t* staged, const uint8_t* data,
                            int64_t stride, int width,
                            const int32_t* lengths, int64_t n, int64_t r0) {
  constexpr int P = kSlot / 16;
  for (int i = threadIdx.x; i < kThreads * P; i += blockDim.x) {
    const int row = i / P, q = i % P;
    const int64_t r = r0 + row;
    if (r >= n) continue;
    const uintptr_t a = reinterpret_cast<uintptr_t>(data + r * stride);
    const int len = row_length(lengths, r, width);
    if (16 * q < static_cast<int>(a & 15) + len)
      *reinterpret_cast<uint4*>(staged + row * kSlot + 16 * q) =
          load16((a & ~uintptr_t{15}) + 16 * q);
  }
}
"""
_ROW_LOOP = """  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int len = row_length(lengths, r, width);
    Reader rd(data + r * stride);
    Writer<W>"""
_STAGED_LOOP = """  __shared__ __align__(16) uint8_t staged[kThreads * kSlot];
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x; r0 < n;
       r0 += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    __syncthreads();
    stage_block(staged, data, stride, width, lengths, n, r0);
    __syncthreads();
    const int64_t r = r0 + threadIdx.x;
    if (r >= n) continue;
    const int len = row_length(lengths, r, width);
    Reader rd(staged + threadIdx.x * kSlot +
              (reinterpret_cast<uintptr_t>(data + r * stride) & 15));
    Writer<W>"""
_ROW = "thread a row"
_STAGED = "thread a row, rows staged through shared memory"
LIMITS = {"without its output stores": _NO_STORES,
          "without its matcher (every start a non-match)": _NO_MATCHER}


def _patched(text: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{name}: the source changed; update the "
                                 "variant")
        text = text.replace(old, new)
    return text


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab_regex"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _source_path(name: str) -> Path:
    return _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")


def _build_all(texts: dict) -> dict:
    """Each source of ``texts`` (name -> text) as a shared library, one
    ``nvcc`` each, all started together -> {name: (replace, extract,
    delim)}."""
    from spark_rapids_tpu_torch import native
    sos = {}
    for name, text in texts.items():
        src = _source_path(name)
        src.write_text(text)
        sos[name] = src.with_suffix(".so")
    native._run_all([[native._nvcc(), *native._NVCC_FLAGS, "-shared", "-o",
                      str(so), str(so.with_suffix(".cu"))]
                     for so in sos.values()])
    return {name: _launchers(ctypes.CDLL(str(so)))
            for name, so in sos.items()}


def _launchers(lib: ctypes.CDLL):
    """A library's three entry points behind the wrappers' signatures."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    for fn in (lib.srt_regex_replace, lib.srt_regex_extract):
        fn.argtypes = [ptr, i64, i32, ptr, i64, ptr, i32, i32, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.srt_delim_select.argtypes = [ptr, i64, i32, ptr, i64, ptr, i32, i32,
                                     ptr, ptr]
    lib.srt_delim_select.restype = ctypes.c_int

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def spans(entry, out_w):
        def run(values, lengths, program, arg):
            n, width = values.shape
            w = out_w(program, width, arg)
            out = torch.empty((n, w), dtype=torch.uint8, device=values.device)
            out_len = torch.empty(n, dtype=torch.int32, device=values.device)
            prog = program.on(values.device)
            rc = entry(values.data_ptr(), values.stride(0), width,
                       lengths.data_ptr(), n, prog.data_ptr(), prog.numel(),
                       arg, out.data_ptr(), out_len.data_ptr(), stream())
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out, out_len
        return run

    delims = {}       # copied once: a capture copies nothing from the host

    def delim(values, lengths, d, count):
        n, width = values.shape
        if d not in delims:
            delims[d] = torch.frombuffer(bytearray(d), dtype=torch.uint8).to(
                values.device)
        db = delims[d]
        cut = torch.empty(n, dtype=torch.int32, device=values.device)
        rc = lib.srt_delim_select(values.data_ptr(), values.stride(0), width,
                                  lengths.data_ptr(), n, db.data_ptr(),
                                  len(d), count, cut.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"delim_select launch failed: CUDA error {rc}")
        return (cut,)
    return (spans(lib.srt_regex_replace, lambda p, w, out_w: out_w),
            spans(lib.srt_regex_extract, lambda p, w, g: w), delim)


def _ptxas(paths: dict) -> None:
    """Each source of ``paths`` (name -> path) compiled with ``ptxas -v``,
    all together; prints the span kernels' lines."""
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
            elif re.search(r"regex_(replace|extract)_kernel", entry) and \
                    re.search(r"Used \d+ registers|stack frame", line):
                k = re.search(r"regex_(replace|extract)_kernelI"
                              r"((?:L[ib]\d+E)+)E", entry)
                args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
                label = (f"regex_{k.group(1)}_kernel<{', '.join(args)}>"
                         if k else entry)
                print(f"# ptxas {name} {label}: {line.strip()}", flush=True)


def _cases() -> list:
    """(label, kind, program or delimiter, argument, n, w, out bytes a
    row) for every shape."""
    from spark_rapids_tpu_torch.expr import regex_kernels as rk

    def case(key, pat, arg, n, w, label):
        if key.startswith("regex_replace"):
            prog = rk.replace_program(pat, arg)
            out_w = rk.replace_width(prog, w)
            return (label, "replace", prog, out_w, n, w, out_w + 4)
        if key == "regex_extract":
            return (label, "extract", rk.extract_program(pat, arg), arg, n,
                    w, w + 4)
        return (label, "delim", pat.encode(), arg, n, w, 4)

    out = []
    for n in SIZES:
        for key, (pat, arg) in cs.ST1_TIMED.items():
            out.append(case(key, pat, arg, n, 128,
                            f"{key} {pat!r} n=2^{n.bit_length() - 1} w128"))
    for key, w in ST1_WIDTHS:
        if w != 128:
            pat, arg = cs.ST1_TIMED[key]
            out.append(case(key, pat, arg, SIZES[0], w,
                            f"{key} {pat!r} n=2^20 w{w} (ST1's width)"))
    out.append(case("regex_replace", *LONG_MATCH, SIZES[0], 128,
                    f"regex_replace {LONG_MATCH[0]!r} (whole rows) n=2^20 "
                    "w128"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another regex.cu to time (repeatable)")
    ap.add_argument("--thread-a-row", metavar="PATH",
                    help="the thread-a-row regex.cu (a variant, and the base "
                    "of the staged-rows limit)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("regex_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.expr import regex_kernels as rk
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "regex.cu"
    variants = dict(v.split("=", 1) for v in args.variant)
    if args.thread_a_row:
        variants[_ROW] = args.thread_a_row
    texts = {name: Path(path).read_text() for name, path in variants.items()}
    ptxas = {"committed": committed, **variants}
    if args.limits:
        base = committed.read_text()
        limits = {name: _patched(base, edits, name)
                  for name, edits in LIMITS.items()}
        if args.thread_a_row:
            limits[_STAGED] = _patched(texts[_ROW], [
                ("  return len < 0 ? 0 : (len > width ? width : len);\n}\n",
                 _STAGE_BLOCK), (_ROW_LOOP, _STAGED_LOOP)], _STAGED)
        for name, text in limits.items():
            texts[name] = text
            ptxas[name] = _source_path(name)
            ptxas[name].write_text(text)
    if args.ptxas:
        _ptxas(ptxas)
    wrappers = (lambda d, ln, p, a: rk.regex_replace(d, ln, p, a),
                lambda d, ln, p, a: rk.regex_extract(d, ln, p, a),
                lambda d, ln, p, a: (rk.delim_select(d, ln, p, a),))
    versions = {"committed": wrappers, **_build_all(texts)}
    index = {"replace": 0, "extract": 1, "delim": 2}
    gen = torch.Generator(device="cuda").manual_seed(21)
    result = {"card": card, "times": {}}
    for label, kind, prog, arg, n, w, out_b in _cases():
        sets = cs._br1_sets(lambda: cs._st1_rows(n, w, gen), w, n)
        fns = {name: (lambda f: lambda d, ln: f(d, ln, prog, arg))(
            v[index[kind]]) for name, v in versions.items()}
        d, ln = sets[0]
        k = min(n, 1 << 20)
        want = cs.run_regex_case(kind, prog, arg, d[:k], ln[:k], True,
                                 arg if kind == "replace" else None)
        ref = None
        for name, fn in fns.items():
            if any(x in name for x in _INEXACT) or (
                    name == _STAGED and w + 15 > 160):
                continue
            got = fn(d, ln)
            torch.cuda.synchronize()
            cs._br1_equal(f"{label}, {name}", [g[:k] for g in got], want)
            if ref is None:
                ref = got
            else:
                cs._br1_equal(f"{label}, {name} (every row)", got, ref)
        del ref, want
        exact = [v for v in fns if not any(x in v for x in _INEXACT)]
        print(f"# {label}: {', '.join(exact)} equal the plain version",
              flush=True)
        if args.check_only:
            continue
        order = list(fns) + list(fns)[::-1]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs._graph_ms(fns[name], sets))
        nbytes = cs._parse_bound_bytes(d, ln, out_b)
        bound = nbytes / cs.MEM_BYTES_PER_S * 1e3
        result["times"][label] = {"bound_ms": bound, "ms": times}
        for name, ts in times.items():
            mean_ms = sum(ts) / len(ts)
            print(f"# {label} {name}: {ts[0]:.6f} / {ts[1]:.6f} ms "
                  f"(mean {mean_ms:.6f} ms), bound {bound:.6f} ms (bytes "
                  f"{nbytes}), {100 * bound / mean_ms:.1f} % of the bound; "
                  f"{card}", flush=True)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
