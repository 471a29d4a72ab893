#!/usr/bin/env python3
"""The ``str_format`` and ``str_parse`` kernels of ``csrc/strings_cast.cu``
beside other versions of the source, on one NVIDIA card.

    python3 strings_kernel_ab.py [--variant NAME=OTHER.cu ...] [--limits]
                                 [--ptxas] [--profile] [--check-only]

Times both kernels at the sizes and inputs ``chip_smoke.py
br1_kernel_phase`` times them (``BR1_SIZES``: 2^20 and 2^23 rows;
``str_format`` of int64, dates and DECIMAL scale 2; ``str_parse`` of int64
and double text in width-16 and width-32 matrices), in CUDA graphs over
input sets larger than L2, each beside its byte bound (``str_parse``'s
sector-exact one, ``chip_smoke.py _parse_bound_bytes``, and the bytes
within the rows' lengths beside it):

- the kernels as built from ``spark_rapids_tpu_torch/csrc``, through their
  wrappers;
- ``--variant NAME=PATH`` (repeatable): the same entry points built from
  another copy of ``strings_cast.cu`` (for example the version before the
  redesign, written out of git into a directory that ``.gitignore``
  lists);
- ``--limits``: the committed source with one thing changed, each named
  by what it shows: without the row stores (the format) or the value and
  flag stores (the parse), which only a value no input makes would take;
  without the digit work (the format's divisions and SWAR digits become
  shifts and ors, the parse's chains adds); the double's shape fixed (no
  class mask, no search for its point and exponent: every token digits
  alone, the chain's selects at the point folded away), with and without
  its digit work, and without its shape decision but its positions kept
  opaque to the compiler (the selects stay); the parse's rows loaded byte
  by byte in place of its vectors; a row a thread (the grid not capped);
  the format's streaming stores; the format's rows staged in shared
  memory and written as the block's contiguous bytes; the parse's pow10
  table in shared memory.

Every version that computes the same function is first held against the
plain version bit for bit on two input sets at each size (the variants
without their stores, digit work or shape compute another one, and are
only timed), then all are timed in turns (the list, then the list reversed). ``--ptxas``
prints each kernel's registers, stack frame and spills as ``ptxas -v``
reports them; ``--profile`` each version's device time by kernel
(``torch.profiler``); ``--check-only`` stops after the checks. The card's
name and power limit are printed beside every time.
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

_NO_DIGITS = "no digit work"
_FIXED_SHAPE = "a fixed shape"
# the variants that compute another function: timed, not checked
_INEXACT = (_NO_DIGITS, _FIXED_SHAPE, "without")
_FORMAT_LOOP = """\
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    uint32_t w[8];
    lengths[i] = format_row(vals, i, kind, scale, w);
    store_row(out + i * width, width, w);
  }
"""
# a block's rows side by side in shared memory as in the output, then
# copied out 16 (or 8) bytes a thread, neighbouring threads on neighbouring
# addresses
_STAGED_LOOP = """\
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += step) {
    const int64_t i = base + threadIdx.x;
    __shared__ uint4 stage[kThreads * kMaxWidth / 16];
    if (i < n) {
      uint32_t w[8];
      lengths[i] = format_row(vals, i, kind, scale, w);
      store_row(reinterpret_cast<uint8_t*>(stage) + threadIdx.x * width,
                width, w);
    }
    __syncthreads();
    const int rows = static_cast<int>(min(static_cast<int64_t>(blockDim.x),
                                          n - base));
    uint8_t* dst = out + base * width;
    if ((width & 15) == 0) {
      for (int k = threadIdx.x; k < rows * width / 16; k += blockDim.x) {
        reinterpret_cast<uint4*>(dst)[k] = stage[k];
      }
    } else {
      for (int k = threadIdx.x; k < rows * width / 8; k += blockDim.x) {
        reinterpret_cast<uint2*>(dst)[k] =
            reinterpret_cast<const uint2*>(stage)[k];
      }
    }
    __syncthreads();
  }
"""
# the double's shape decision (its class mask, its first non-digits and
# what they decide), replaced below by a token of digits alone: no point,
# no exponent
_DOUBLE_SHAPE = """\
  Bits<M> other = Bits<M>::range(ds, tl) & ~digits_of<N, M>(w, tl);
  int o[3];
  uint32_t b[3] = {0u, 0u, 0u};
  o[0] = other.first(tl);
  b[0] = byte_at(w, o[0]);
  other = other & ~Bits<M>::one(o[0]);
  // the point (else the 'e'), the 'e' (else the end), the exponent's sign
  int p = tl, e_pos = tl;
  bool e_sign = false, e_neg = false, shape = true;
  if (!other.any()) {
    // at most one non-digit (a warp of such rows skips the rest): a point,
    // or an 'e'
    if (o[0] < tl) {
      if (b[0] == '.') p = o[0];
      else e_pos = o[0];
      shape = b[0] == '.' || is_e(b[0]);
    }
  } else {
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      o[k] = other.first(tl);
      b[k] = byte_at(w, o[k]);
      other = other & ~Bits<M>::one(o[k]);
    }
    shape = !other.any();
    int k = 0;
    if (b[0] == '.') {
      p = o[0];
      k = 1;
    }
    if (k == 1 ? (o[1] < tl) : (o[0] < tl)) {
      const int at = k == 1 ? o[1] : o[0];
      const uint32_t c = k == 1 ? b[1] : b[0];
      const int next = k == 1 ? o[2] : o[1];
      const uint32_t cn = k == 1 ? b[2] : b[1];
      const int after = k == 1 ? tl : o[2];
      e_pos = at;
      e_sign = next == at + 1 && next < tl && is_sign(cn);
      e_neg = e_sign && cn == '-';
      shape = shape && is_e(c) && (e_sign ? after == tl : next == tl);
    }
  }
  if (p == tl) p = e_pos;
"""
_FIXED = """\
  const int p = tl, e_pos = tl;
  const bool e_sign = false, e_neg = false, shape = true;
"""
# the same positions hidden from the compiler (no timed row ends in "ZZZZ"),
# so the chain keeps its selects at the point
_OPAQUE = """\
  const int o1 = w[N - 1] == 0x5A5A5A5Au ? 1 : 0;
  const int o2 = w[N - 2] == 0x5A5A5A5Au ? 1 : 0;
  const int p = tl + o1, e_pos = tl + o2;
  const bool e_sign = (o1 & o2) != 0, e_neg = e_sign, shape = true;
"""
_PARSE_NO_DIGITS = [
    ("            acc = acc * 10u + d;\n"
     "            facc = __fma_rn(facc, 10.0, small_double(d));",
     "            acc += d;\n            facc += 1.0;"),
    ("          const double next =\n              __fma_rn(acc, 10.0, "
     "small_double(byte_of(w, j) - '0'));",
     "          const double next = acc + 1.0;"),
    ("          acc = __fma_rn(acc, 10.0, "
     "small_double(byte_of(w, j) - '0'));",
     "          acc += 1.0;")]
# variant name -> [(text, replacement)], each text occurring once in the
# committed source
LIMITS = {
    "format without its row stores": [(
        "    store_row(out + i * width, width, w);",
        "    if (w[0] == 0x5A5A5A5Au && out == nullptr)\n"
        "      store_row(out + i * width, width, w);")],
    f"format with {_NO_DIGITS}": [
        ("  const uint64_t hi8 = mag / 100000000ull;",
         "  const uint64_t hi8 = mag >> 27;"),
        ("  const uint32_t a = static_cast<uint32_t>(hi8 / 100000000ull);",
         "  const uint32_t a = static_cast<uint32_t>(hi8 >> 27);"),
        ("  const uint64_t d0 = digits8(a), d1 = digits8(b), d2 = digits8(c);",
         "  const uint64_t d0 = kZeros8 | a, d1 = kZeros8 | b,"
         " d2 = kZeros8 | c;")],
    "format with staged rows": [(_FORMAT_LOOP, _STAGED_LOOP)],
    "parse without its stores": [
        ("    ok_out[i] = ok ? 1 : 0;\n  }\n}\n\n// Rows wider",
         "    if (ok && out == nullptr) ok_out[i] = 1;\n  }\n}\n\n"
         "// Rows wider"),
        ("__device__ __forceinline__ void put_value(void* out, int64_t i, "
         "T v) {\n  static_cast<T*>(out)[i] = v;",
         "__device__ __forceinline__ void put_value(void* out, int64_t i, "
         "T v) {\n  if (v == T(7) && out == nullptr) "
         "static_cast<T*>(out)[i] = v;")],
    f"parse with {_NO_DIGITS}": _PARSE_NO_DIGITS,
    f"parse with {_FIXED_SHAPE}": [(_DOUBLE_SHAPE, _FIXED)],
    "parse without the double's shape decision (positions kept opaque)": [
        (_DOUBLE_SHAPE, _OPAQUE)],
    f"parse with {_FIXED_SHAPE} and {_NO_DIGITS}": [
        (_DOUBLE_SHAPE, _FIXED), *_PARSE_NO_DIGITS],
    "parse with bytes in place of vectors": [(
        "  const int32_t grain = where % 16 == 0 ? 16 : where % 8 == 0 ? 8 "
        ": 1;",
        "  const int32_t grain = 1;")],
    "a row a thread (the grid not capped)": [(
        "  return blocks > kMaxBlocks ? kMaxBlocks : blocks;",
        "  return blocks;")],
    "format with streaming stores": [(
        "        *reinterpret_cast<uint4*>(dst + 16 * k) =\n"
        "            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], "
        "w[4 * k + 3]);",
        "        __stcs(reinterpret_cast<uint4*>(dst + 16 * k),\n"
        "               make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],"
        " w[4 * k + 3]));")],
    "parse with pow10 in shared memory": [
        ("  constexpr int M = (V + 1) / 2;\n  const int64_t step",
         "  constexpr int M = (V + 1) / 2;\n"
         "  __shared__ double p10[kPowHi - kPowLo + 1];\n"
         "  for (int k = threadIdx.x; k <= kPowHi - kPowLo; k += blockDim.x)"
         " {\n    p10[k] = pow10[k];\n  }\n  __syncthreads();\n"
         "  const int64_t step"),
        ("parse_double<N, M>(w, tl, pow10, &ok)",
         "parse_double<N, M>(w, tl, p10, &ok)")],
}

_FORMATS = (("long", 0, 8), ("date", 0, 4), ("decimal", 2, 8))
_PARSES = (("long", 16), ("long", 32), ("double", 16), ("double", 32))


def _out_dir() -> Path:
    from spark_rapids_tpu_torch import native
    out = native._BUILD_DIR / "ab_strings"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _source_path(name: str) -> Path:
    return _out_dir() / (re.sub(r"\W+", "_", name) + ".cu")


def _build_all(texts: dict) -> dict:
    """Each source of ``texts`` (name -> text) as a shared library, one
    ``nvcc`` each, all started together -> {name: (format, parse)}."""
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
    """A library's two entry points behind the wrappers' signatures."""
    from spark_rapids_tpu_torch.expr import cast_kernels as K
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.srt_str_parse.argtypes = [ptr, i64, i32, ptr, i64, i32, ptr, ptr,
                                  ptr, ptr]
    lib.srt_str_format.argtypes = [ptr, i64, i32, i32, i32, ptr, ptr, ptr]
    for fn in (lib.srt_str_parse, lib.srt_str_format):
        fn.restype = ctypes.c_int

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def str_format(values, kind, scale=0):
        v = values.contiguous()
        if kind == "bool":
            v = v.view(torch.uint8)
        n, width = v.shape[0], K.FORMAT_WIDTH[kind]
        out = torch.empty((n, width), dtype=torch.uint8, device=v.device)
        lengths = torch.empty(n, dtype=torch.int32, device=v.device)
        rc = lib.srt_str_format(v.data_ptr(), n, K.FORMAT_KINDS[kind], scale,
                                width, out.data_ptr(), lengths.data_ptr(),
                                stream())
        if rc:
            raise RuntimeError(f"str_format launch failed: CUDA error {rc}")
        return out, lengths

    def str_parse(data, lengths, kind):
        n, width = data.shape
        out = torch.empty(n, dtype=K._PARSE_DTYPE[kind], device=data.device)
        ok = torch.empty(n, dtype=torch.bool, device=data.device)
        rc = lib.srt_str_parse(data.data_ptr(), data.stride(0), width,
                               lengths.data_ptr(), n, K.PARSE_KINDS[kind],
                               K._pow10_table(data.device).data_ptr(),
                               out.data_ptr(), ok.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"str_parse launch failed: CUDA error {rc}")
        return out, ok
    return str_format, str_parse


_KINDS = {"0": "long", "1": "double", "2": "bool", "3": "date"}


def _kernel_label(entry: str) -> str:
    """A mangled entry's kernel name, with str_parse's row vectors and
    kind."""
    m = re.search(r"str_parse_kernelILi(\d+)ELi(\d+)E", entry)
    if m:
        return f"str_parse_kernel<{16 * int(m.group(1))} B, " \
               f"{_KINDS[m.group(2)]}>"
    for name in ("str_parse_wide_kernel", "str_format_kernel"):
        if name in entry:
            return name
    return entry


def _ptxas(paths: dict) -> None:
    """Each source of ``paths`` (name -> path) compiled with ``ptxas -v``,
    all together; prints the str_parse and str_format kernels' lines."""
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
            elif re.search(r"str_(parse|format)", entry) and re.search(
                    r"Used \d+ registers|stack frame", line):
                print(f"# ptxas {name} {_kernel_label(entry)}: "
                      f"{line.strip()}", flush=True)


def _profile_kernels(label: str, fn, sets: list, card: str) -> None:
    """Each device kernel of one call of ``fn``, averaged over a call on
    each input set under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in sets:
            fn(*args)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            m = re.search(r"str_\w+_kernel", e.key)
            parts.append((e.self_device_time_total / 1e3 / len(sets),
                          m.group(0) if m else e.key[:40]))
    print(f"# profile {label}: " + "; ".join(
        f"{name} {ms:.6f} ms" for ms, name in sorted(parts, reverse=True))
        + f"; {card}", flush=True)


def _cases(n: int, gen: torch.Generator) -> list:
    """(label, kernel, call args -> fn args, sets, bound bytes, old bound
    bytes) at n rows, as br1_kernel_phase makes them."""
    from spark_rapids_tpu_torch.expr.cast_kernels import FORMAT_WIDTH
    cases = []
    for kind, scale, in_b in _FORMATS:
        sets = cs._br1_sets(lambda kind=kind: (cs._br1_format_values(
            n, kind, gen),), in_b + FORMAT_WIDTH[kind], n)
        nbytes = (in_b + FORMAT_WIDTH[kind] + 4) * n
        cases.append((f"str_format {kind} n={n}", "format",
                      (kind, scale), sets, nbytes, None))
    for kind, w in _PARSES:
        sets = cs._br1_sets(lambda kind=kind, w=w: cs._br1_numeric_rows(
            n, w, kind, gen), w, n)
        d, ln = sets[0]
        cases.append((f"str_parse {kind} w{w} n={n}", "parse", (kind,),
                      sets, cs._parse_bound_bytes(d, ln, 8 + 1),
                      int(ln.sum()) + (4 + 8 + 1) * n))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another strings_cast.cu to time (repeatable)")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="each version's device time by kernel "
                    "(torch.profiler) at each size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("strings_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.expr.cast_kernels import (
        str_format, str_format_reference, str_parse, str_parse_reference)
    card = cs._card_line()
    print(card, flush=True)
    native.load_kernels()
    committed = native._SRC_DIR / "strings_cast.cu"
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
            ptxas[limit] = _source_path(limit)
            ptxas[limit].write_text(text)
    if args.ptxas:
        _ptxas(ptxas)
    versions = {"committed": (str_format, str_parse), **_build_all(texts)}
    plain = {"format": str_format_reference, "parse": str_parse_reference}
    gen = torch.Generator(device="cuda").manual_seed(19)
    result = {"card": card, "times": {}}
    for n in cs.BR1_SIZES:
        for label, which, extra, sets, nbytes, old_bytes in _cases(n, gen):
            fns = {name: (lambda f, e=extra: lambda *a: f(*a, *e))(
                fmt if which == "format" else parse)
                for name, (fmt, parse) in versions.items()
                if not name.startswith("format" if which == "parse"
                                       else "parse")}
            for name, fn in fns.items():
                if any(w in name for w in _INEXACT):
                    continue
                for s in sets[:2]:
                    got = fn(*s)
                    want = plain[which](*s, *extra)
                    torch.cuda.synchronize()
                    cs._br1_equal(f"{label}, {name}", got, want)
            exact = [v for v in fns if not any(w in v for w in _INEXACT)]
            print(f"# {label}: {', '.join(exact)} equal the plain version",
                  flush=True)
            if args.profile:
                for name, fn in fns.items():
                    _profile_kernels(f"{label} {name}", fn, sets, card)
            if args.check_only:
                continue
            order = list(fns) + list(fns)[::-1]
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(cs._graph_ms(fns[name], sets))
            bound = nbytes / cs.MEM_BYTES_PER_S * 1e3
            old = None if old_bytes is None \
                else old_bytes / cs.MEM_BYTES_PER_S * 1e3
            result["times"][label] = {"bound_ms": bound, "old_bound_ms": old,
                                      "ms": times}
            for name, ts in times.items():
                mean_ms = sum(ts) / len(ts)
                extra_b = "" if old is None else \
                    f"; bytes within the lengths {old:.6f} ms, " \
                    f"{100 * old / mean_ms:.1f} %"
                print(f"# {label} {name}: {ts[0]:.6f} / {ts[1]:.6f} ms "
                      f"(mean {mean_ms:.6f} ms), bound {bound:.6f} ms "
                      f"(bytes), {100 * bound / mean_ms:.1f} % of the "
                      f"bound{extra_b}; {card}", flush=True)
            del sets
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
