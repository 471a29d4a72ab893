"""The Parquet decode kernels' plain versions against the JAX functions they
replace (``spark_rapids_tpu/io/parquet_device.py``), exactly, and the CUDA
kernels against their plain versions on the card.

Run tables come from seeded RLE/bit-packed hybrid streams (widths 1-24,
RLE and bit-packed runs mixed, runs across byte edges, pages of growing
widths in one table, one run, pow2 padding, an empty dictionary) and from
seeded raw tables whose reads past the packed bytes clamp. The row choice
runs for every fixed-width element type and for strings of widths 8, 64
and 256, dictionary-only, plain-only and mixed, with nulls.

numpy models of the two redesigned kernels (``_expand_model``,
``_gather_model``) walk their indexing as ``csrc/parquet_decode.cu`` does
(the tile's search, the run slices, the 8 outputs a thread and their word
reads; 4 rows a thread, the granule from aligned 16-byte pieces) and are
held against the plain versions and the JAX functions, on edge cases:
tiles starting inside runs, tiles spanning more runs than a slice, R a
power of two read past its total, widths 0 to 24, caps 1, 3, 5 and 4097,
reads past the packed bytes, rows at every offset mod 16 and of lengths 0,
15, 16, 17 and the width, entries outside the page bytes.

The JAX comparisons skip where the JAX package is not installed, so on the
card's machine the file runs as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_parquet_kernels.py

and there the ``cuda`` cases hold each kernel against its plain version."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_tpu_torch.io import parquet_device as pdev
from spark_rapids_tpu_torch.io.parquet_kernels import (
    pq_expand_hybrid, pq_expand_hybrid_reference, pq_gather_byte_array,
    pq_gather_byte_array_reference, pq_gather_fixed,
    pq_gather_fixed_reference)


@pytest.fixture
def jax_pdev():
    """The JAX package's parquet_device (x64 on, the CPU backend)."""
    return pytest.importorskip("spark_rapids_tpu.io.parquet_device")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device (the kernel has no CPU "
                    "mode; run on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# seeded hybrid streams
# ---------------------------------------------------------------------------
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _hybrid(rng, n: int, width: int, values=None, rle_share=0.4):
    """A hybrid stream of ``n`` values at ``width`` bits (``values`` if
    given, else random), RLE runs and bit-packed groups mixed; -> (bytes,
    the values)."""
    out = bytearray()
    got: list = []
    hi = 1 << width
    while len(got) < n:
        left = n - len(got)
        if values is not None:
            v = int(values[len(got)])
            run = 1
            while run < left and int(values[len(got) + run]) == v:
                run += 1
            if run >= 8 or rng.random() < rle_share:
                out += _varint(run << 1)
                out += v.to_bytes((width + 7) // 8, "little")
                got += [v] * run
                continue
            groups = min(-(-left // 8), int(rng.integers(1, 5)))
            vals = np.zeros(groups * 8, np.int64)
            take = min(groups * 8, left)
            vals[:take] = values[len(got):len(got) + take]
        elif rng.random() < rle_share:
            run = int(min(left, rng.integers(1, 50)))
            v = int(rng.integers(0, hi))
            out += _varint(run << 1)
            out += v.to_bytes((width + 7) // 8, "little")
            got += [v] * run
            continue
        else:
            groups = int(rng.integers(1, 6))
            vals = rng.integers(0, hi, groups * 8).astype(np.int64)
            take = min(groups * 8, left)
        bits = ((vals[:, None] >> np.arange(width)) & 1).astype(np.uint8)
        out += _varint((groups << 1) | 1)
        out += np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        got += vals[:take].tolist()
    return bytes(out), np.asarray(got[:n], np.int64)


def _tables(J, rng, pages):
    """Port and JAX run tables over the same pages ((n, width) each)."""
    port, jax_rt = pdev._RunTable(), J._RunTable()
    truth = []
    for n, width in pages:
        buf, vals = _hybrid(rng, n, width)
        for rt in (port, jax_rt):
            rt.parse_hybrid(buf, 0, len(buf), width, n)
        truth.append(vals)
    return port, jax_rt, np.concatenate(truth) if truth else np.zeros(0)


_PAGE_SETS = {
    "one run": [(37, 0)],
    "width 1": [(1000, 1)],
    "widths 1-24": [(200 + 13 * w, w) for w in range(1, 25)],
    "growing widths": [(500, 3), (700, 5), (300, 9), (900, 17)],
    "byte edges": [(8 * 7 + 3, 7), (8 * 13 + 1, 13), (24, 24)],
}


def _expand_jax(J, arrays, cap):
    import jax.numpy as jnp
    out = J._expand_hybrid_device(*(jnp.asarray(a) for a in arrays),
                                  jnp.arange(cap, dtype=jnp.int64))
    return np.asarray(out)


@pytest.mark.parametrize("case", sorted(_PAGE_SETS))
def test_expand_hybrid_plain_equals_jax(jax_pdev, case):
    rng = np.random.default_rng(sorted(_PAGE_SETS).index(case))
    port, jrt, truth = _tables(jax_pdev, rng, _PAGE_SETS[case])
    runs, packed = port.arrays()
    jarrays = jrt.arrays()
    # the host half: the same run table, the JAX arrays stacked
    np.testing.assert_array_equal(runs, np.stack(
        [a.astype(np.int64) for a in jarrays[:5]]))
    np.testing.assert_array_equal(packed, jarrays[5])
    for cap in (len(truth), 2 * len(truth) + 5):  # past the end: clamps
        got = pq_expand_hybrid(torch.from_numpy(runs),
                               torch.from_numpy(packed), len(packed), cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      _expand_jax(jax_pdev, jarrays, cap))
    np.testing.assert_array_equal(
        pq_expand_hybrid_reference(torch.from_numpy(runs),
                                   torch.from_numpy(packed), len(packed),
                                   len(truth)).numpy(), truth)


def _raw_table(seed: int):
    """Random runs with unaligned first bits into a short packed blob:
    most bit-packed reads run past its end and clamp."""
    rng = np.random.default_rng(seed)
    r = 16
    counts = rng.integers(1, 40, r)
    out_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    runs = np.stack([out_start, rng.integers(0, 2, r),
                     rng.integers(0, 1 << 24, r), rng.integers(0, 8 * 40, r),
                     rng.integers(1, 25, r)]).astype(np.int64)
    packed = rng.integers(0, 256, 32).astype(np.uint8)
    return runs, packed, int(counts.sum()) + 17


@pytest.mark.parametrize("seed", range(4))
def test_expand_hybrid_plain_equals_jax_where_reads_clamp(jax_pdev, seed):
    runs, packed, cap = _raw_table(seed)
    jarrays = (*runs[:1], runs[1].astype(bool), *runs[2:], packed)
    got = pq_expand_hybrid(torch.from_numpy(runs), torch.from_numpy(packed),
                           len(packed), cap)
    np.testing.assert_array_equal(got.numpy(),
                                  _expand_jax(jax_pdev, jarrays, cap))


def test_expand_hybrid_of_an_empty_table_is_zero(jax_pdev):
    runs, packed = pdev._RunTable().arrays()
    jarrays = jax_pdev._empty_run_tables()
    got = pq_expand_hybrid(torch.from_numpy(runs), torch.from_numpy(packed),
                           len(packed), 8)
    np.testing.assert_array_equal(got.numpy(), _expand_jax(jax_pdev,
                                                           jarrays, 8))
    assert not got.any()


# ---------------------------------------------------------------------------
# chunks: the row choice for every element type, and for strings
# ---------------------------------------------------------------------------
def _levels(rng, n: int, null_share: float):
    return (rng.random(n) >= null_share).astype(np.int64)


def _chunks(J, phys, n, nulls, n_dict_vals, dict_share, seed, values,
            ba=None):
    """A port and a JAX chunk of ``n`` rows filled alike: definition levels
    (``nulls`` share null), the first ``dict_share`` of the non-null values
    dictionary-encoded over pages of growing index widths (``n_dict_vals``
    dictionary entries), the rest plain. ``values(rng, k)`` makes k plain
    values (fixed width) and the dictionary; ``ba`` makes byte-array
    parts instead."""
    rng = np.random.default_rng(seed)
    port, jch = pdev._Chunk(phys), J._Chunk()
    levels = _levels(rng, n, nulls)
    nonnull = int(levels.sum())
    n_dict = int(nonnull * dict_share) if n_dict_vals else 0
    buf, _ = _hybrid(rng, n, 1, values=levels)
    idx = rng.integers(0, max(n_dict_vals, 1), n_dict)
    pages = []
    if n_dict:
        cut = sorted(rng.choice(np.arange(1, n_dict), 2, replace=False)) \
            if n_dict > 3 else [n_dict, n_dict]
        for lo, hi in zip([0, *cut], [*cut, n_dict]):
            part = idx[lo:hi]
            width = max(int(part.max()).bit_length() if len(part) else 0, 1)
            pages.append((_hybrid(rng, len(part), width, values=part)[0],
                          width, len(part)))
    for ch in (port, jch):
        ch.defs.parse_hybrid(buf, 0, len(buf), 1, n)
        for page, width, k in pages:
            ch.idx.parse_hybrid(page, 0, len(page), width, k)
            ch.idx_width = max(ch.idx_width, width)
        ch.num_rows = n
        ch.nullable = True
        ch.uses_dict = bool(n_dict)
        ch.uses_plain = nonnull > n_dict
    port.num_nonnull = nonnull
    k_plain = nonnull - n_dict
    if ba is not None:
        d_part, p_parts = ba(rng, n_dict_vals, k_plain)
        for ch in (port, jch):
            ch.ba_dict = d_part if n_dict_vals else None
            ch.ba_plain = p_parts if k_plain else []
        return port, jch
    dictionary, plain = values(rng, n_dict_vals), values(rng, k_plain)
    for ch in (port, jch):
        ch.dictionary = dictionary if n_dict else None
        if phys == "BOOLEAN":
            ch.bool_plain = [(np.packbits(plain, bitorder="little")
                              .tobytes(), k_plain)] if k_plain else []
        else:
            ch.plain_parts = [plain.tobytes()] if k_plain else []
    return port, jch


_FIXED = {
    "bool": ("BOOLEAN", "BOOLEAN",
             lambda r, k: r.integers(0, 2, k).astype(np.bool_)),
    "int32": ("INT32", "INT",
              lambda r, k: r.integers(-2**31, 2**31, k).astype(np.int32)),
    "date32": ("INT32", "DATE",
               lambda r, k: r.integers(-8000, 30000, k).astype(np.int32)),
    "int64": ("INT64", "LONG",
              lambda r, k: r.integers(-2**62, 2**62, k).astype(np.int64)),
    "timestamp": ("INT64", "TIMESTAMP",
                  lambda r, k: r.integers(0, 2**50, k).astype(np.int64)),
    "float32": ("FLOAT", "FLOAT",
                lambda r, k: r.normal(size=k).astype(np.float32)),
    "float64": ("DOUBLE", "DOUBLE", lambda r, k: r.normal(size=k)),
}
_SHAPES = {"dict only": (0.0, 1.0), "plain only": (0.12, 0.0),
           "mixed with nulls": (0.12, 0.6)}


def _port_dtype(name):
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    return getattr(tdt, name)


def _jax_dtype(name):
    from spark_rapids_tpu.columnar import dtypes as jdt
    return getattr(jdt, name)


def _assert_columns_equal(got, want):
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if want.lengths is not None:
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("etype", sorted(_FIXED))
def test_gather_fixed_plain_equals_jax(jax_pdev, etype, shape):
    phys, tname, values = _FIXED[etype]
    nulls, dict_share = _SHAPES[shape]
    if etype == "bool" and 0 < dict_share < 1:
        dict_share = 0.0  # mixed dict+plain booleans are gated out
    n, n_dict_vals = 3000, 300 if dict_share else 0
    port, jch = _chunks(jax_pdev, phys, n, nulls, n_dict_vals, dict_share,
                        sorted(_FIXED).index(etype), values)
    cap = 4096
    got = pdev._decode_column_device(port, _port_dtype(tname), cap,
                                     torch.device("cpu"))
    want = jax_pdev._decode_column_device(jch, _jax_dtype(tname), cap)
    _assert_columns_equal(got, want)
    assert got.data.dtype == {"bool": torch.bool, "int32": torch.int32,
                              "date32": torch.int32, "int64": torch.int64,
                              "timestamp": torch.int64,
                              "float32": torch.float32,
                              "float64": torch.float64}[etype]


def _ba_parts(max_len: int):
    def make(rng, n_dict_vals, k_plain):
        def stream(k):
            lens = rng.integers(0, max_len + 1, k)
            if k:
                lens[0] = max_len
            buf = b"".join(int(ln).to_bytes(4, "little")
                           + rng.integers(0, 256, ln).astype(np.uint8)
                           .tobytes() for ln in lens)
            return pdev._parse_byte_array_stream(buf, k, native=False)
        half = k_plain // 2
        return stream(n_dict_vals), [stream(half), stream(k_plain - half)]
    return make


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("width", [8, 64, 256])
def test_gather_byte_array_plain_equals_jax(jax_pdev, width, shape):
    nulls, dict_share = _SHAPES[shape]
    n_dict_vals = 50 if dict_share else 0
    port, jch = _chunks(jax_pdev, "BYTE_ARRAY", 700, nulls, n_dict_vals,
                        dict_share, width, None,
                        ba=_ba_parts(width * 3 // 4 + 1))
    cap = 1024
    got = pdev._decode_column_device(port, _port_dtype("STRING"), cap,
                                     torch.device("cpu"))
    want = jax_pdev._decode_column_device(jch, _jax_dtype("STRING"), cap)
    assert got.data.shape == (cap, width)
    _assert_columns_equal(got, want)


def test_byte_array_walk_python_equals_jax(jax_pdev):
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 30, 500)
    buf = b"".join(int(ln).to_bytes(4, "little") + b"x" * int(ln)
                   for ln in lens) + b"tail"
    got = pdev._parse_byte_array_stream(buf, len(lens), native=False)
    want = jax_pdev._parse_byte_array_stream(buf, len(lens))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(pdev.UnsupportedChunk):
        pdev._parse_byte_array_stream(buf[:-10 - 4], len(lens), native=False)


# ---------------------------------------------------------------------------
# numpy models of the kernels' indexing (csrc/parquet_decode.cu), walked as
# the kernels walk them, against the plain versions and the JAX functions
# ---------------------------------------------------------------------------
# expand_hybrid_kernel's constants: threads a block, outputs a thread, runs
# a slice, and the run window at which the tile's search stops
_THREADS, _PER_THREAD, _SLICE, _WINDOW = 256, 8, 256, 32
_TILE = _THREADS * _PER_THREAD
_I64_MAX = 2**63 - 1


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _word(words: np.ndarray, k: int) -> int:
    if not 0 <= k < len(words):
        raise AssertionError(f"word {k} read outside the buffer's "
                             f"{len(words)} words")
    return int(words[k])


def _expand_value(sl, r: int, i: int, packed: np.ndarray, nb: int) -> int:
    """hybrid_value: output ``i`` of slice run ``r``; ``packed`` is the
    whole buffer the kernel is given (its tail included)."""
    start, is_rle, value, bit_base, width = (int(x) for x in sl[:, r])
    if is_rle:
        return _i32(value)
    bit = bit_base + (i - start) * width
    byte0, shift = bit >> 3, bit & 7
    if byte0 >= 0 and byte0 + 3 <= nb - 1:
        words = packed[:len(packed) // 4 * 4].view("<u4")
        k = bit >> 5
        pair = _word(words, k) | (_word(words, k + 1) << 32)
        field = (pair >> (bit & 31)) & 0xFFFFFFFF & (0xFFFFFFFF >> shift)
    else:
        dword = sum(int(packed[min(max(byte0 + k, 0), nb - 1)]) << (8 * k)
                    for k in range(4))
        field = dword >> shift
    return _i32(field & (((1 << (width & 0xFFFFFFFF)) - 1) & 0xFFFFFFFF))


def _expand_group(sl, r: int, i0: int, packed: np.ndarray, nb: int,
                  out: np.ndarray) -> bool:
    """expand_group: a thread's 8 outputs from ``i0``, all in slice run
    ``r``; -> whether they took the words at 32-bit offsets from the
    group's first word (else hybrid_value each)."""
    start, is_rle, value, bit_base, width = (int(x) for x in sl[:, r])
    if is_rle:
        out[i0:i0 + _PER_THREAD] = _i32(value)
        return False
    bit0 = bit_base + (i0 - start) * width
    if not (0 <= width <= 32 and bit0 >= 0
            and ((bit0 + (_PER_THREAD - 1) * width) >> 3) + 3 <= nb - 1):
        for i in range(i0, i0 + _PER_THREAD):
            out[i] = _expand_value(sl, r, i, packed, nb)
        return False
    words = packed[:len(packed) // 4 * 4].view("<u4")
    k0, off = bit0 >> 5, bit0 & 31
    mask = ((1 << width) - 1) & 0xFFFFFFFF
    for j in range(_PER_THREAD):
        o = off + j * width
        pair = _word(words, k0 + (o >> 5)) \
            | (_word(words, k0 + (o >> 5) + 1) << 32)
        out[i0 + j] = _i32((pair >> (o & 31)) & 0xFFFFFFFF
                           & (0xFFFFFFFF >> (o & 7)) & mask)
    return True


def _expand_model(runs: np.ndarray, packed: np.ndarray, n_packed: int,
                  cap: int, trace: list = None) -> np.ndarray:
    """expand_hybrid_kernel in numpy, block by block and thread by thread:
    the tile's search (256 probes a round), the run slices, each thread's
    8 outputs (in one run: expand_group; else a forward walk, output by
    output) and the word reads. ``packed`` holds the kernel's tail;
    ``trace`` gets (search rounds, slices, groups read as words) a
    block."""
    R = runs.shape[1]
    out_start = runs[0]
    out = np.full(cap, -7, np.int64)
    for b in range(-(-cap // _TILE)):
        t0, t1 = b * _TILE, min(b * _TILE + _TILE, cap)
        lo, span, rounds = 0, R, 0
        while span > _WINDOW:
            stride = -(-span // _THREADS)
            p = lo + np.arange(_THREADS) * stride
            p = p[p < lo + span]
            c = int(np.count_nonzero(out_start[p] <= t0))
            rounds += 1
            if c == 0:
                break
            nlo = lo + (c - 1) * stride
            span, lo = min(stride, lo + span - nlo), nlo
        base, frm, slices, groups = lo, t0, 0, 0
        while True:
            sl = runs[:, base:base + _SLICE]
            nxt = int(out_start[base + _SLICE]) if base + _SLICE < R \
                else _I64_MAX
            m = max(int(np.count_nonzero(sl[0] < t1)), 1)
            slices += 1
            for tid in range(_THREADS):
                i0 = t0 + tid * _PER_THREAD
                first = max(i0, frm)
                stop = min(nxt, t1, i0 + _PER_THREAD)
                if first >= stop:
                    continue
                a, z = 0, m
                while a < z:
                    mid = (a + z) >> 1
                    if sl[0, mid] <= first:
                        a = mid + 1
                    else:
                        z = mid
                r = max(a - 1, 0)
                if (out[first:stop] != -7).any():
                    raise AssertionError(f"outputs {first}..{stop} written "
                                         "twice")
                if first == i0 and stop == i0 + _PER_THREAD \
                        and (r + 1 >= m or sl[0, r + 1] >= stop):
                    groups += _expand_group(sl, r, i0, packed, n_packed, out)
                    continue
                for i in range(first, stop):
                    while r + 1 < m and sl[0, r + 1] <= i:
                        r += 1
                    out[i] = _expand_value(sl, r, i, packed, n_packed)
            if nxt >= t1:
                break
            frm, base = nxt, base + _SLICE
        if trace is not None:
            trace.append((rounds, slices, groups))
    return out.astype(np.int32)


#: the expansion's edge cases and the string gather's (chip_smoke.py holds
#: them, for the card's run)
_EDGE_TABLES = cs._pq_edge_tables(np.random.default_rng(12))


def _edge_table(case: str):
    """-> (runs, packed with the kernel's tail, n_packed, caps)."""
    runs, packed, n = _EDGE_TABLES[case]
    return runs, packed, n, cs._pq_edge_caps(runs)


@pytest.mark.parametrize("case", sorted(_EDGE_TABLES))
def test_expand_hybrid_model_equals_plain_and_jax(jax_pdev, case):
    runs, packed, n, caps = _edge_table(case)
    jarrays = (runs[0], runs[1].astype(bool), *runs[2:], packed[:n])
    for cap in caps:
        trace = []
        got = _expand_model(runs, packed, n, cap, trace)
        want = pq_expand_hybrid_reference(torch.from_numpy(runs),
                                          torch.from_numpy(packed), n, cap)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, _expand_jax(jax_pdev, jarrays,
                                                       cap))
        if cap > _TILE:
            rounds, slices, groups = np.max(trace, axis=0)
            if case == "runs of length 1":
                assert slices >= _TILE // _SLICE   # the chunked walk
            if case == "two search rounds":
                assert rounds == 2
            if case == "inside runs":
                assert _TILE % 700 and slices == 1 and groups > 0


@pytest.mark.parametrize("case", sorted(_PAGE_SETS) + ["clamps"])
def test_expand_hybrid_model_equals_plain_on_streams(case):
    """The model on the hybrid streams and clamping tables above."""
    if case == "clamps":
        runs, packed, cap = _raw_table(7)
    else:
        rng = np.random.default_rng(sorted(_PAGE_SETS).index(case))
        rt = pdev._RunTable()
        for n, width in _PAGE_SETS[case]:
            buf, _ = _hybrid(rng, n, width)
            rt.parse_hybrid(buf, 0, len(buf), width, n)
        runs, packed = rt.arrays()
        cap = 2 * rt.total + 5
    want = pq_expand_hybrid_reference(torch.from_numpy(runs),
                                      torch.from_numpy(packed), len(packed),
                                      cap)
    np.testing.assert_array_equal(
        _expand_model(runs, _padded(packed), len(packed), cap), want.numpy())


def _low_bytes(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    n = np.clip(n, 0, 4).astype(np.uint64)
    return v & ((np.uint64(1) << (np.uint64(8) * n)) - np.uint64(1))


def _granules(blob: np.ndarray, n_blob: int, s: np.ndarray,
              keep: np.ndarray) -> np.ndarray:
    """granule() for many rows: bytes [s, s + keep) of the blob as four
    words, from one aligned 16-byte piece and the next one where the bytes
    cross into it, realigned by a word select and a funnel shift; rows
    reaching outside [0, n_blob) byte by byte, clamped. -> uint64 (rows, 4)
    words (each below 2^32)."""
    words = blob[:len(blob) // 4 * 4].view("<u4").astype(np.uint64)
    o = np.zeros((len(s), 4), np.uint64)
    inside = (keep > 0) & (s >= 0) & (s + keep <= n_blob)
    a = np.where(inside, s & ~15, 0)
    off = s - a
    cross = inside & (off + keep > 16)
    for rows, first in ((inside, 0), (cross, 4)):
        k = a[rows] // 4 + first
        if len(k) and k.max() + 3 >= len(words):
            raise AssertionError("a 16-byte piece read past the blob")
    w = np.zeros((len(s), 8), np.uint64)
    for j in range(4):
        w[inside, j] = words[a[inside] // 4 + j]
        w[cross, 4 + j] = words[a[cross] // 4 + 4 + j]
    q = (off >> 2)[:, None]
    sh = (np.uint64(8) * (off & 3).astype(np.uint64))[:, None]
    u = np.take_along_axis(w, np.clip(q + np.arange(5), 0, 7), axis=1)
    pair = u[:, :4] | (u[:, 1:] << np.uint64(32))
    o[inside] = ((pair >> sh) & np.uint64(0xFFFFFFFF))[inside]
    for r in np.nonzero((keep > 0) & ~inside & (n_blob > 0))[0]:
        for j in range(int(keep[r])):
            b = int(blob[min(max(int(s[r]) + j, 0), n_blob - 1)])
            o[r, j >> 2] |= np.uint64(b << (8 * (j & 3)))
    return _low_bytes(o, keep[:, None] - 4 * np.arange(4))


def _gather_model(valid, pos, idx, starts, lens, blob, n_blob, n_dict,
                  d_entries, width):
    """gather_byte_array_kernel in numpy: 4 rows a thread and one 16-byte
    granule column; each row's entry through the chain validity, position,
    dictionary index, start and length; the granule from aligned pieces;
    the store of its first min(16, width - c0) bytes."""
    from spark_rapids_tpu_torch.io.parquet_kernels import pow2_ceil
    cap = len(valid)
    p_entries = len(starts) - d_entries
    d_rows, p_rows = pow2_ceil(d_entries), pow2_ceil(p_entries)
    v, p = valid.astype(bool), pos.astype(np.int64)
    k = np.zeros(cap, np.int64)
    dict_row = v & (p < n_dict)
    if dict_row.any():
        k[dict_row] = idx[np.clip(p[dict_row], 0, len(idx) - 1)]
    kk = np.clip(k, 0, d_rows - 1)
    qq = np.clip(p - n_dict, 0, p_rows - 1)
    e = np.where(p < n_dict, np.where(kk < d_entries, kk, -1),
                 np.where(qq < p_entries, d_entries + qq, -1))
    e = np.where(v, e, -1)
    has = e >= 0
    length = np.zeros(cap, np.int64)
    start = np.zeros(cap, np.int64)
    length[has], start[has] = lens[e[has]], starts[e[has]]
    data = np.full((cap, width), 0xAB, np.uint8)   # every byte is stored
    for c0 in range(0, width, 16):
        keep = np.clip(np.minimum(length, width) - c0, 0, 16)
        g = _granules(blob, n_blob, start + c0, keep)
        nbytes = min(16, width - c0)
        data[:, c0:c0 + nbytes] = g.astype("<u4").view(np.uint8) \
            .reshape(cap, 16)[:, :nbytes]
    return data, length.astype(np.int32)


_BA_WIDTHS = (8, 24, 64, 4100)
_CAPS = (1, 3, 5, 4097)


@pytest.mark.parametrize("cap", _CAPS)
@pytest.mark.parametrize("width", _BA_WIDTHS)
def test_gather_byte_array_model_equals_plain(width, cap):
    rng = np.random.default_rng(width + cap)
    for clamped in (False, True):
        arrays, n_blob, d_entries = cs._pq_edge_byte_arrays(rng, width, cap,
                                                            clamped)
        for n_dict in (0, 3000, cap):
            got = _gather_model(*arrays, n_blob, n_dict, d_entries, width)
            want = pq_gather_byte_array_reference(
                *(torch.from_numpy(a) for a in arrays[:5]),
                torch.from_numpy(arrays[5][:n_blob]), n_dict, d_entries,
                width)
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("width", [8, 64, 256])
def test_kernel_models_equal_jax_on_chunks(jax_pdev, monkeypatch, width,
                                           shape):
    """The decode of a string chunk on the CPU with each kernel call's
    inputs (as staged, tails included) run through the models: the
    expansions equal their plain results, and the gather the JAX planes."""
    calls = []

    def record(fn):
        def run(*args):
            out = fn(*args)
            calls.append((fn, args, out))
            return out
        return run

    monkeypatch.setattr(pdev, "pq_expand_hybrid", record(pq_expand_hybrid))
    monkeypatch.setattr(pdev, "pq_gather_byte_array",
                        record(pq_gather_byte_array))
    nulls, dict_share = _SHAPES[shape]
    n_dict_vals = 50 if dict_share else 0
    port, jch = _chunks(jax_pdev, "BYTE_ARRAY", 700, nulls, n_dict_vals,
                        dict_share, width, None,
                        ba=_ba_parts(width * 3 // 4 + 1))
    cap = 1024
    pdev._decode_column_device(port, _port_dtype("STRING"), cap,
                               torch.device("cpu"))
    want = jax_pdev._decode_column_device(jch, _jax_dtype("STRING"), cap)
    assert [c[0] for c in calls][-1] is pq_gather_byte_array
    for fn, args, out in calls:
        arrays = [a.numpy() if isinstance(a, torch.Tensor) else a
                  for a in args]
        if fn is pq_expand_hybrid:
            np.testing.assert_array_equal(_expand_model(*arrays), out.numpy())
        else:
            data, lengths = _gather_model(*arrays)
            np.testing.assert_array_equal(data, np.asarray(want.data))
            np.testing.assert_array_equal(lengths, np.asarray(want.lengths))


# ---------------------------------------------------------------------------
# the wrappers on the CPU, and the kernels on the card
# ---------------------------------------------------------------------------
def test_wrappers_on_cpu_launch_nothing_and_check_inputs():
    runs, packed = pdev._RunTable().arrays()
    before = (pq_expand_hybrid.launches, pq_gather_fixed.launches,
              pq_gather_byte_array.launches)
    pq_expand_hybrid(torch.from_numpy(runs), torch.from_numpy(packed), 1, 4)
    v = torch.ones(4, dtype=torch.bool)
    p = torch.arange(4, dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    pq_gather_fixed(v, p, none, torch.zeros(1), torch.arange(4.0), 0)
    pq_gather_byte_array(v, p, none, torch.tensor([0, 1, 2, 3]),
                         torch.ones(4, dtype=torch.int32),
                         torch.arange(20, dtype=torch.uint8), 4, 0, 0, 8)
    assert (pq_expand_hybrid.launches, pq_gather_fixed.launches,
            pq_gather_byte_array.launches) == before
    with pytest.raises(TypeError):
        pq_expand_hybrid(torch.from_numpy(runs).int(),
                         torch.from_numpy(packed), 1, 4)
    with pytest.raises(ValueError):
        pq_expand_hybrid(torch.from_numpy(runs), torch.from_numpy(packed),
                         5, 4)
    with pytest.raises(ValueError):
        pq_gather_fixed(v, p, none, torch.zeros(0), torch.arange(4.0), 0)


def test_gather_byte_array_refuses_a_misaligned_or_short_blob():
    """The kernel reads ``blob`` in aligned 16-byte pieces: the wrapper
    takes only a 16-byte aligned blob with 16 bytes past its ``n_blob``."""
    v = torch.ones(4, dtype=torch.bool)
    p = torch.arange(4, dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    starts, lens = torch.tensor([0, 1, 2, 3]), torch.ones(4, dtype=torch.int32)
    blob = torch.arange(64, dtype=torch.uint8)
    assert blob.data_ptr() % 16 == 0
    data, _ = pq_gather_byte_array(v, p, none, starts, lens, blob[:20], 4, 0,
                                   0, 8)
    assert data[:, 0].tolist() == [0, 1, 2, 3]
    for bad, n_blob in ((blob[:19], 4), (blob[1:30], 4), (blob[8:40], 4),
                        (blob[:20], 5), (blob[:20], -1)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pq_gather_byte_array(v, p, none, starts, lens, bad, n_blob, 0, 0,
                                 8)


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _padded(packed: np.ndarray) -> np.ndarray:
    return np.pad(packed, (0, -(-len(packed) // 4) * 4 + 4 - len(packed)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PAGE_SETS) + ["clamps"]
                         + sorted(_EDGE_TABLES))
def test_expand_hybrid_kernel_equals_plain(cuda_device, case):
    if case in _EDGE_TABLES:
        runs, packed, n, caps = _edge_table(case)
        r, p = _on(cuda_device, runs, packed)
        for cap in caps:
            got = pq_expand_hybrid(r, p, n, cap)
            want = pq_expand_hybrid_reference(r, p, n, cap)
            torch.cuda.synchronize()
            assert torch.equal(got, want), cap
        return
    if case == "clamps":
        runs, packed, cap = _raw_table(7)
    else:
        rng = np.random.default_rng(sorted(_PAGE_SETS).index(case))
        rt = pdev._RunTable()
        for n, width in _PAGE_SETS[case]:
            buf, _ = _hybrid(rng, n, width)
            rt.parse_hybrid(buf, 0, len(buf), width, n)
        runs, packed = rt.arrays()
        cap = 2 * rt.total + 5
    r, p = _on(cuda_device, runs, _padded(packed))
    got = pq_expand_hybrid(r, p, len(packed), cap)
    want = pq_expand_hybrid_reference(r, p, len(packed), cap)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert pq_expand_hybrid.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int16,
                                   torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_gather_fixed_kernel_equals_plain(cuda_device, dtype):
    rng = np.random.default_rng(5)
    cap, n_dict = 1 << 16, 20000
    valid = rng.random(cap) < 0.9
    pos = (np.cumsum(valid) - 1).astype(np.int32)
    idx = rng.integers(-3, 70, 1 << 15).astype(np.int32)  # some clamp
    d = rng.integers(-100, 100, 64)
    p = rng.integers(-100, 100, 1 << 16)
    v, ps, ix = _on(cuda_device, valid, pos, idx)
    dv, pv = (torch.from_numpy(a).to(dtype).to(cuda_device) for a in (d, p))
    for nd in (0, n_dict, cap):
        got = pq_gather_fixed(v, ps, ix, dv, pv, nd)
        want = pq_gather_fixed_reference(v, ps, ix, dv, pv, nd)
        torch.cuda.synchronize()
        assert torch.equal(got, want), nd


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 24, 64, 256, 4100])
def test_gather_byte_array_kernel_equals_plain(cuda_device, width):
    rng = np.random.default_rng(width)
    cap, entries, d_entries = 1 << 14, 3000, 1000
    valid = rng.random(cap) < 0.88
    pos = (np.cumsum(valid) - 1).astype(np.int32)
    idx = rng.integers(0, 1100, 1 << 14).astype(np.int32)  # past d_entries
    lens = rng.integers(0, width + 1, entries).astype(np.int32)
    starts = (np.cumsum(lens.astype(np.int64) + 3) - lens - 3 + 1)
    blob = rng.integers(0, 256, int(starts[-1] + lens[-1] + 5)) \
        .astype(np.uint8)
    n_blob = len(blob)   # the kernel's 16-byte tail after it
    v, ps, ix, st, ln, bl = _on(cuda_device, valid, pos, idx, starts, lens,
                                np.pad(blob, (0, 16)))
    for nd in (0, 5000, cap):
        got = pq_gather_byte_array(v, ps, ix, st, ln, bl, n_blob, nd,
                                   d_entries, width)
        want = pq_gather_byte_array_reference(v, ps, ix, st, ln,
                                              bl[:n_blob], nd, d_entries,
                                              width)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # every start offset mod 16, lengths 0/15/16/17/width, small caps, and
    # entries reaching outside the blob
    for cap in _CAPS:
        for clamped in (False, True):
            arrays, n_blob, d_entries = cs._pq_edge_byte_arrays(
                rng, width, cap, clamped)
            v, ps, ix, st, ln, bl = _on(cuda_device, *arrays)
            for nd in (0, 3000, cap):
                got = pq_gather_byte_array(v, ps, ix, st, ln, bl, n_blob, nd,
                                           d_entries, width)
                want = pq_gather_byte_array_reference(
                    v, ps, ix, st, ln, bl[:n_blob], nd, d_entries, width)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) \
                    and torch.equal(got[1], want[1]), (cap, clamped, nd)


@pytest.mark.cuda
def test_byte_array_walk_native_equals_python(cuda_device):
    rng = np.random.default_rng(9)
    lens = rng.integers(0, 300, 20000)
    buf = b"".join(int(ln).to_bytes(4, "little") + b"y" * int(ln)
                   for ln in lens)
    for a, b in zip(pdev._parse_byte_array_stream(buf, len(lens), True),
                    pdev._parse_byte_array_stream(buf, len(lens), False)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(pdev.UnsupportedChunk):
        pdev._parse_byte_array_stream(buf[:-1], len(lens), True)


def _nullable_file(n: int = 5000, **kw) -> bytes:
    """tests/test_parquet_device.py's nine nullable columns, written by
    pyarrow into memory."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(7)
    cols = {
        "i64": pa.array(rng.integers(-10**12, 10**12, n), type=pa.int64()),
        "i32": pa.array(rng.integers(-2**30, 2**30, n).astype(np.int32)),
        "f64": pa.array(rng.normal(size=n)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "lowcard": pa.array(rng.integers(0, 40, n), type=pa.int64()),
        "date": pa.array(rng.integers(0, 20000, n).astype(np.int32)).cast(
            pa.date32()),
        "ts": pa.array(rng.integers(0, 2**48, n), type=pa.int64()).cast(
            pa.timestamp("us")),
        "s": pa.array([f"str{i % 11}" * (1 + i % 5) for i in range(n)]),
    }
    t = pa.table({k: pa.array(v.to_pylist(), type=v.type,
                              mask=rng.random(n) < 0.12)
                  for k, v in cols.items()})
    buf = io.BytesIO()
    pq.write_table(t, buf, row_group_size=2000, **kw)
    return buf.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"use_dictionary": False},
                                {"dictionary_pagesize_limit": 4096,
                                 "data_page_size": 2048,
                                 "data_page_version": "2.0"}])
def test_decode_row_group_on_card_equals_cpu(cuda_device, kw):
    """The whole device half on the card (one staged copy a chunk, the
    three kernels) against the same decode on the CPU, plane by plane."""
    import io

    import pyarrow.parquet as pq
    raw = _nullable_file(**kw)
    pf = pq.ParquetFile(io.BytesIO(raw))
    names = pf.schema_arrow.names
    for rg in range(pf.metadata.num_row_groups):
        got, n_dev = pdev.decode_row_group(raw, pf.metadata, rg,
                                           pf.schema_arrow, names, 64,
                                           cuda_device)
        want, n_cpu = pdev.decode_row_group(raw, pf.metadata, rg,
                                            pf.schema_arrow, names, 64,
                                            torch.device("cpu"))
        # v2 pages write booleans RLE-encoded, which the decoder gates out
        assert n_dev == n_cpu >= len(names) - ("data_page_version" in kw)
        assert torch.equal(got.row_mask.cpu(), want.row_mask)
        for g, w in zip(got.columns, want.columns):
            assert torch.equal(g.data.cpu(), w.data)
            assert torch.equal(g.validity.cpu(), w.validity)
            if w.lengths is not None:
                assert torch.equal(g.lengths.cpu(), w.lengths)
        assert got.to_host().to_arrow().equals(
            pf.read_row_group(rg).cast(got.to_host().to_arrow().schema))


def test_staged_packed_bytes_hold_the_kernels_tail():
    """A chunk's staged ``packed`` bytes end at least 4 bytes past their
    last aligned word, 4-byte aligned, as the expansion kernel reads them
    (its wrapper refuses anything less on the card)."""
    rt = pdev._RunTable()
    for n, width in ((100, 3), (37, 11)):
        buf, _ = _hybrid(np.random.default_rng(width), n, width)
        rt.parse_hybrid(buf, 0, len(buf), width, n)
    st = pdev._Staging()
    st.add(np.arange(3, dtype=np.int32))
    where = pdev._add_run_table(st, rt)
    views = st.views(torch.device("cpu"))
    packed, n_packed = views[where[1]], where[2]
    assert packed.data_ptr() % 4 == 0
    assert packed.numel() >= -(-n_packed // 4) * 4 + 4
    np.testing.assert_array_equal(packed[:n_packed].numpy(), rt.arrays()[1])
    np.testing.assert_array_equal(views[where[0]].numpy(), rt.arrays()[0])
