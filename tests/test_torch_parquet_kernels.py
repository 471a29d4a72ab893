"""The Parquet decode kernels' plain versions against the JAX functions they
replace (``spark_rapids_tpu/io/parquet_device.py``), exactly, and the CUDA
kernels against their plain versions on the card.

Run tables come from seeded RLE/bit-packed hybrid streams (widths 1-24,
RLE and bit-packed runs mixed, runs across byte edges, pages of growing
widths in one table, one run, pow2 padding, an empty dictionary) and from
seeded raw tables whose reads past the packed bytes clamp. The row choice
runs for every fixed-width element type and for strings of widths 8, 64
and 256, dictionary-only, plain-only and mixed, with nulls.

The JAX comparisons skip where the JAX package is not installed, so on the
card's machine the file runs as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_parquet_kernels.py

and there the ``cuda`` cases hold each kernel against its plain version."""
import numpy as np
import pytest
import torch

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
                         torch.arange(4, dtype=torch.uint8), 0, 0, 8)
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


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _padded(packed: np.ndarray) -> np.ndarray:
    return np.pad(packed, (0, -(-len(packed) // 4) * 4 + 4 - len(packed)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PAGE_SETS) + ["clamps"])
def test_expand_hybrid_kernel_equals_plain(cuda_device, case):
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
    v, ps, ix, st, ln, bl = _on(cuda_device, valid, pos, idx, starts, lens,
                                blob)
    for nd in (0, 5000, cap):
        got = pq_gather_byte_array(v, ps, ix, st, ln, bl, nd, d_entries,
                                   width)
        want = pq_gather_byte_array_reference(v, ps, ix, st, ln, bl, nd,
                                              d_entries, width)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
