"""Parquet page decode on the device — the port of
``spark_rapids_tpu/io/parquet_device.py`` (reference: GpuParquetScanBase
.scala:995,1194, which decodes raw column chunks on the accelerator).

The split is the JAX package's:

- The HOST does the byte plumbing: file reads, page-header parsing
  (io/parquet_thrift.py), page decompression, and one pass over the
  RLE/bit-packed hybrid streams into *run tables* (a few entries per run,
  not per value). A PLAIN BYTE_ARRAY stream is walked for its value starts
  and lengths (on the card's path by the host C function ``srt_ba_walk``
  of the kernel library; on the CPU by a Python loop), and the page bytes
  themselves are uploaded as they are.
- The DEVICE does the per-value work, with the three kernels of
  io/parquet_kernels.py: the run-table expansion of the definition levels
  and the dictionary indices, then the row choice (a dictionary value or a
  plain value per row, 0 at a null) into the fixed-width plane or straight
  from the page bytes into the string matrix. Each chunk's host arrays go
  to the device in one copy.

Supported (anything else decodes on the host, per column, and uploads):
flat columns (no repetition), physical BOOLEAN/INT32/INT64/FLOAT/DOUBLE/
BYTE_ARRAY (strings as the bucketed byte matrix), data pages v1 and v2,
PLAIN or RLE_DICTIONARY values, also chunks whose pages switch from the
dictionary to PLAIN mid-chunk (pyarrow's dictionary overflow), and any
codec ``pyarrow.decompress`` reads. The planes are bit-equal to the JAX
package's. Only what the reference gates out falls back: a chunk outside
the subset, an unsupported page, a codec ``pyarrow.decompress`` refuses, a
parse error of the host half. A failure of the device half raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import io as _io
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..columnar import dtypes as dt
from ..columnar.device import (DeviceColumn, DeviceTable, bucket_rows,
                               bucket_width)
from ..columnar.host import HostTable, _arrow_to_dtype
from ..conf import (PARQUET_DEVICE_DECODE_BOOLEANS,
                    PARQUET_DEVICE_DECODE_STRINGS)
from .parquet_kernels import (MAX_BIT_WIDTH, pow2_ceil, pq_expand_hybrid,
                              pq_gather_byte_array, pq_gather_fixed)
from .parquet_thrift import Encoding, PageType, read_page_header

__all__ = ["chunk_supported", "decode_row_group", "UnsupportedChunk",
           "DEVICE_DECODED_COLUMNS", "host_split", "SPLIT_STAGES"]

#: the scan's metric: columns of a row group decoded on the device
DEVICE_DECODED_COLUMNS = "deviceDecodedColumns"

_PHYS_OK = {"BOOLEAN", "INT32", "INT64", "FLOAT", "DOUBLE", "BYTE_ARRAY"}
_ENC_OK = {"PLAIN", "RLE", "RLE_DICTIONARY", "PLAIN_DICTIONARY",
           "BIT_PACKED"}


class UnsupportedChunk(Exception):
    """Column chunk outside the device decoder's subset."""


# ---------------------------------------------------------------------------
# Where the decode's time goes: counters that only a host_split() block reads
# ---------------------------------------------------------------------------
#: the decode's stages, as ``host_split()`` times them: page headers and
#: decompression; the hybrid streams into run tables; ``_count_defined``;
#: the BYTE_ARRAY walk; the staging buffer's host build; its copy to the
#: device; the kernels and the ops between them (synchronised); the host
#: decode of the columns the device does not take
SPLIT_STAGES = ("pages", "run_tables", "count_defined", "byte_array_walk",
                "staging", "upload", "kernels", "host_decode")

_split: Optional[dict] = None
_split_lock = threading.Lock()


@contextlib.contextmanager
def host_split() -> Iterator[dict]:
    """Times the decode inside the block. Yields a dict: host seconds by
    stage (``SPLIT_STAGES``, and ``"total"``: the whole of each
    ``decode_row_group``), ``"row_groups"``, and ``"runs"``: per column, a
    list of ``(stream, R, values)`` per chunk, where the stream is
    ``"defs"`` (definition levels) or ``"idx"`` (dictionary indices) and R
    counts the runs before pow2 padding. Outside such a block nothing is
    timed or synchronised."""
    global _split
    split = dict.fromkeys(SPLIT_STAGES + ("total",), 0.0)
    split.update(row_groups=0, runs={})
    with _split_lock:
        if _split is not None:
            raise RuntimeError("host_split() blocks do not nest")
        _split = split
    try:
        yield split
    finally:
        with _split_lock:
            _split = None


def _clock() -> float:
    """perf_counter() while a host_split() block is open, else 0.0."""
    return time.perf_counter() if _split is not None else 0.0


def _tally(stage: str, t0: float, device: Optional[torch.device] = None
           ) -> None:
    """Adds the seconds since ``t0`` (from ``_clock``) to ``stage``, after
    the device's queued work where ``device`` is a CUDA device."""
    split = _split
    if split is None or not t0:
        return
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    dt_s = time.perf_counter() - t0
    with _split_lock:
        split[stage] += dt_s


def _timed(stage: str):
    """Decorator: the call's seconds go to ``stage`` in a host_split()."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _split is None:
                return fn(*args, **kwargs)
            t0 = _clock()
            try:
                return fn(*args, **kwargs)
            finally:
                _tally(stage, t0)
        return run
    return deco


def chunk_supported(col_meta, arrow_field, conf=None) -> bool:
    """Static (metadata-only) eligibility of one column chunk, with the
    per-type gates (reference: the per-type read enables of
    RapidsConf.scala:877-917)."""
    if col_meta.physical_type not in _PHYS_OK:
        return False
    if conf is not None:
        if col_meta.physical_type == "BYTE_ARRAY" \
                and not conf.get(PARQUET_DEVICE_DECODE_STRINGS):
            return False
        if col_meta.physical_type == "BOOLEAN" \
                and not conf.get(PARQUET_DEVICE_DECODE_BOOLEANS):
            return False
    if any(e not in _ENC_OK for e in col_meta.encodings):
        return False
    t = arrow_field.type
    if pa.types.is_nested(t) or pa.types.is_dictionary(t):
        return False
    try:
        d = _arrow_to_dtype(t)
    except TypeError:
        return False  # a type the port does not hold (binary, nested, ...)
    if isinstance(d, dt.DecimalType):
        # as the JAX package (io/parquet_device.py:89): a decimal chunk
        # takes the host decode (columnar/host.py reads its Arrow buffer)
        return False
    if pa.types.is_timestamp(t) and t.unit != "us":
        return False  # the raw values are in another unit than the plane's
    if isinstance(d, (dt.StringType, dt.BinaryType)):
        return isinstance(d, dt.StringType) \
            and col_meta.physical_type == "BYTE_ARRAY"
    return col_meta.physical_type != "BYTE_ARRAY"


# ---------------------------------------------------------------------------
# Host side: pages -> merged run tables
# ---------------------------------------------------------------------------
@_timed("pages")
def _decompress(buf: bytes, codec: str, uncompressed_size: int) -> bytes:
    """A page's bytes through ``pyarrow.decompress``; a codec it refuses or
    a page it cannot inflate raises UnsupportedChunk (host decode)."""
    if codec in ("UNCOMPRESSED", None):
        return buf
    try:
        return pa.decompress(buf, decompressed_size=uncompressed_size,
                             codec=codec.lower()).to_pybytes()
    except (OSError, ValueError, NotImplementedError) as e:
        raise UnsupportedChunk(f"codec {codec}: {e}") from e


class _RunTable:
    """Accumulated RLE/bit-packed runs across a chunk's pages."""

    def __init__(self):
        self.out_start: List[int] = []
        self.count: List[int] = []
        self.is_rle: List[bool] = []
        self.rle_value: List[int] = []
        self.bit_base: List[int] = []   # absolute first bit into self.packed
        self.width: List[int] = []      # PER-RUN bit width: pages of a
        # growing dictionary bit-pack at growing widths
        self.packed = bytearray()
        self.total = 0

    @_timed("run_tables")
    def parse_hybrid(self, buf: bytes, pos: int, end: int, width: int,
                     max_count: int) -> None:
        """One RLE-hybrid stream (parquet format spec): the header varint's
        low bit selects bit-packed groups or an RLE run."""
        if width == 0:
            # zero-width stream: max_count zeros, no bytes
            self._push_rle(max_count, 0)
            return
        produced = 0
        vbytes = (width + 7) // 8
        while pos < end and produced < max_count:
            header = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                header |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            if header & 1:  # bit-packed groups
                groups = header >> 1
                nvals = min(groups * 8, max_count - produced)
                nbytes = groups * width  # groups*8 values * width/8 bits
                self.out_start.append(self.total)
                self.count.append(nvals)
                self.is_rle.append(False)
                self.rle_value.append(0)
                self.bit_base.append(len(self.packed) * 8)
                self.width.append(width)
                self.packed.extend(buf[pos:pos + nbytes])
                pos += nbytes
                self.total += nvals
                produced += nvals
            else:           # RLE run
                run = min(header >> 1, max_count - produced)
                v = int.from_bytes(buf[pos:pos + vbytes], "little")
                pos += vbytes
                self._push_rle(run, v)
                produced += run

    def _push_rle(self, run: int, v: int) -> None:
        if run <= 0:
            return
        self.out_start.append(self.total)
        self.count.append(run)
        self.is_rle.append(True)
        self.rle_value.append(v)
        self.bit_base.append(0)
        self.width.append(0)
        self.total += run

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (runs int64 (5, R), packed uint8), as the JAX package pads
        them: R and the blob pow2-padded (padding runs start at ``total``,
        so the expansion never selects them)."""
        n = pow2_ceil(len(self.out_start))
        pad = n - len(self.out_start)
        runs = np.array([self.out_start + [self.total] * pad,
                         self.is_rle + [True] * pad,
                         self.rle_value + [0] * pad,
                         self.bit_base + [0] * pad,
                         self.width + [0] * pad], dtype=np.int64)
        packed = np.frombuffer(bytes(self.packed) or b"\0", np.uint8)
        packed = np.pad(packed, (0, pow2_ceil(len(packed)) - len(packed)))
        return runs, packed


class _Chunk:
    """Parsed column chunk: run tables, plain values and the dictionary.

    The dense non-null value stream of a chunk is [dictionary-encoded
    pages' values] ++ [plain pages' values]: a writer that overflows its
    dictionary (pyarrow's 1 MB default) switches to PLAIN for the REST of
    the chunk, never back, so the order is dictionary, then plain."""

    def __init__(self, phys: str):
        self.phys = phys
        self.defs = _RunTable()      # definition levels (width 1)
        self.idx = _RunTable()       # dictionary indices (width per page)
        self.idx_width: int = 0
        self.plain_parts: List[bytes] = []
        self.dictionary: Optional[np.ndarray] = None
        # BYTE_ARRAY: the dictionary's and each plain page's (starts,
        # lengths, page bytes)
        self.ba_dict: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self.ba_plain: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.num_rows = 0
        self.num_nonnull = 0
        self.nullable = False
        self.bool_plain: List[Tuple[bytes, int]] = []  # packed bits, count
        self.uses_dict = False
        self.uses_plain = False


def _ba_walk_python(buf: bytes, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    starts = np.empty(n, np.int64)
    lens = np.empty(n, np.int64)
    pos = 0
    unpack = struct.unpack_from
    for i in range(n):
        if pos + 4 > len(buf):
            raise UnsupportedChunk("BYTE_ARRAY stream ends in a length")
        (ln,) = unpack("<I", buf, pos)
        pos += 4
        starts[i] = pos
        lens[i] = ln
        pos += ln
    if pos > len(buf):
        raise UnsupportedChunk("BYTE_ARRAY stream ends in a value")
    return starts, lens, pos


def _ba_walk_native(buf: bytes, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    from ..native import load_kernels
    starts = np.empty(n, np.int64)
    lens = np.empty(n, np.int64)
    src = np.frombuffer(buf, np.uint8)
    pos = load_kernels().srt_ba_walk(
        src.ctypes.data_as(ctypes.c_void_p), len(buf), n,
        starts.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p))
    if pos < 0:
        raise UnsupportedChunk("BYTE_ARRAY stream ends inside a value")
    return starts, lens, pos


@_timed("byte_array_walk")
def _parse_byte_array_stream(buf: bytes, n: int, native: bool
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk a PLAIN BYTE_ARRAY stream (u32 length before each value) ->
    (starts, lengths, the walked bytes) without copying the values. The
    walk is sequential: ``native`` runs it in the kernel library's host C
    function (the card's path), else a Python loop."""
    starts, lens, pos = (_ba_walk_native if native
                         else _ba_walk_python)(buf, n)
    return starts, lens, np.frombuffer(buf, np.uint8, pos)


def _parse_chunk(raw: bytes, col_meta, nullable: bool,
                 native: bool = False) -> _Chunk:
    ch = _Chunk(col_meta.physical_type)
    ch.nullable = nullable
    phys = ch.phys
    codec = col_meta.compression
    off = col_meta.dictionary_page_offset
    if off is None:
        off = col_meta.data_page_offset
    end = off + col_meta.total_compressed_size
    pos = off
    while pos < end:
        t0 = _clock()
        hdr = read_page_header(raw, pos)
        _tally("pages", t0)
        data_start = pos + hdr.header_bytes
        page = raw[data_start:data_start + hdr.compressed_size]
        pos = data_start + hdr.compressed_size
        if hdr.page_type == PageType.DICTIONARY_PAGE:
            page = _decompress(page, codec, hdr.uncompressed_size)
            if phys == "BYTE_ARRAY":
                ch.ba_dict = _parse_byte_array_stream(page, hdr.num_values,
                                                      native)
            else:
                ch.dictionary = _plain_values(page, phys, hdr.num_values)
            continue
        nvals = hdr.num_values
        if hdr.page_type == PageType.DATA_PAGE:
            page = _decompress(page, codec, hdr.uncompressed_size)
            p = 0
            # flat columns: no repetition levels; definition levels only
            # when the column is nullable (length-prefixed RLE, width 1)
            n_nonnull = nvals
            if nullable:
                if hdr.def_level_encoding != Encoding.RLE:
                    # legacy BIT_PACKED levels have no length prefix
                    raise UnsupportedChunk(
                        f"definition-level encoding {hdr.def_level_encoding}")
                (dl_len,) = np.frombuffer(page, np.uint32, 1, p)
                p += 4
                before = ch.defs.total
                ch.defs.parse_hybrid(page, p, p + int(dl_len), 1, nvals)
                if ch.defs.total - before < nvals:  # stream may omit tail
                    ch.defs._push_rle(nvals - (ch.defs.total - before), 1)
                p += int(dl_len)
                n_nonnull = _count_defined(ch.defs, before)
            else:
                ch.defs._push_rle(nvals, 1)
        elif hdr.page_type == PageType.DATA_PAGE_V2:
            # v2 layout: [rep levels][def levels] UNCOMPRESSED, then the
            # values (compressed iff is_compressed); levels are RLE with no
            # length prefix (the lengths are in the header)
            if hdr.rep_levels_byte_length:
                raise UnsupportedChunk("v2 repetition levels on flat column")
            dl = hdr.def_levels_byte_length
            levels = page[:dl]
            vals = page[dl:]
            if hdr.v2_is_compressed:
                vals = _decompress(vals, codec, hdr.uncompressed_size - dl)
            n_nonnull = nvals - hdr.num_nulls
            before = ch.defs.total
            if dl:
                ch.defs.parse_hybrid(levels, 0, dl, 1, nvals)
            if ch.defs.total - before < nvals:
                ch.defs._push_rle(nvals - (ch.defs.total - before), 1)
            page = vals
            p = 0
        else:
            raise UnsupportedChunk(f"page type {hdr.page_type}")
        if hdr.encoding in (Encoding.RLE_DICTIONARY,
                            Encoding.PLAIN_DICTIONARY):
            if ch.uses_plain:
                # the dense stream's order would break (plain sits last)
                raise UnsupportedChunk("dictionary page after plain page")
            width = page[p]
            p += 1
            if width > MAX_BIT_WIDTH:
                raise UnsupportedChunk(f"dict index width {width}")
            ch.idx_width = max(ch.idx_width, width)
            ch.idx.parse_hybrid(page, p, len(page), width, n_nonnull)
            ch.uses_dict = True
        elif hdr.encoding == Encoding.PLAIN:
            if phys == "BOOLEAN":
                ch.bool_plain.append((page[p:], n_nonnull))
            elif phys == "BYTE_ARRAY":
                ch.ba_plain.append(
                    _parse_byte_array_stream(page[p:], n_nonnull, native))
            else:
                ch.plain_parts.append(page[p:])
            ch.uses_plain = True
        else:
            raise UnsupportedChunk(f"encoding {hdr.encoding}")
        ch.num_rows += nvals
        ch.num_nonnull += n_nonnull
    if ch.uses_dict and ch.bool_plain:
        raise UnsupportedChunk("mixed dict+plain boolean pages")
    return ch


@_timed("count_defined")
def _count_defined(rt: _RunTable, from_entry_total: int) -> int:
    """Non-null count of the definition-level runs after a checkpoint:
    dictionary index streams hold only the non-null values."""
    total = 0
    for i in range(len(rt.out_start)):
        if rt.out_start[i] < from_entry_total:
            continue
        if rt.is_rle[i]:
            total += rt.count[i] * (1 if rt.rle_value[i] else 0)
        else:
            # bit-packed levels at width 1: count the set bits of the run
            base = rt.bit_base[i] // 8
            nbits = rt.count[i]
            blob = bytes(rt.packed[base:base + (nbits + 7) // 8])
            bits = np.unpackbits(np.frombuffer(blob, np.uint8),
                                 bitorder="little")[:nbits]
            total += int(bits.sum())
    return total


_NP_BY_PHYS = {"INT32": np.int32, "INT64": np.int64,
               "FLOAT": np.float32, "DOUBLE": np.float64}


def _plain_values(buf: bytes, phys: str, n: int) -> np.ndarray:
    if phys == "BOOLEAN":
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, (n + 7) // 8),
                             bitorder="little")[:n]
        return bits.astype(np.bool_)
    return np.frombuffer(buf, _NP_BY_PHYS[phys], n)


# ---------------------------------------------------------------------------
# Device side: one copy of the chunk's host arrays, then the kernels
# ---------------------------------------------------------------------------
class _Staging:
    """Host arrays laid out at 16-byte offsets in one buffer that crosses
    to the device in one copy; ``views`` cuts the device buffer back into
    typed tensors."""

    def __init__(self):
        self.parts: List[Tuple[int, np.ndarray, int]] = []
        self.size = 0

    def add(self, arr: np.ndarray, extra: int = 0) -> int:
        """Place ``arr`` and ``extra`` zero bytes after it (a 1-D uint8
        array's view then holds them too); its index."""
        arr = np.ascontiguousarray(arr)
        if extra and (arr.dtype != np.uint8 or arr.ndim != 1):
            raise TypeError("only a 1-D uint8 array takes extra bytes")
        self.size = -(-self.size // 16) * 16
        self.parts.append((self.size, arr, extra))
        self.size += arr.nbytes + extra
        return len(self.parts) - 1

    def views(self, device: torch.device, t0: float = 0.0
              ) -> List[torch.Tensor]:
        """The device buffer cut into the parts' views; ``t0`` (from
        ``_clock``): when the host build began, for host_split()."""
        buf = np.zeros(max(self.size, 16), np.uint8)
        for off, arr, _ in self.parts:
            buf[off:off + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        _tally("staging", t0)
        t0 = _clock()
        dev = torch.from_numpy(buf).to(device)
        _tally("upload", t0, device)
        out = []
        for off, arr, extra in self.parts:
            dtype = torch.bool if arr.dtype == np.bool_ \
                else torch.from_numpy(arr[:0].reshape(-1)).dtype
            t = dev[off:off + arr.nbytes + extra].view(dtype)
            out.append(t if extra else t.reshape(arr.shape))
        return out


def _add_run_table(st: _Staging, rt: _RunTable) -> Tuple[int, int, int]:
    """Stage a run table: (index of runs, index of packed, n_packed). The
    packed bytes get 8 zero bytes of tail, for the kernel's aligned
    32-bit reads."""
    runs, packed = rt.arrays()
    return st.add(runs), st.add(packed, extra=8), len(packed)


def _expand(views, where: Tuple[int, int, int], cap: int) -> torch.Tensor:
    runs, packed, n_packed = where
    return pq_expand_hybrid(views[runs], views[packed], n_packed, cap)


def _decode_column_device(ch: _Chunk, out_dtype: dt.DataType, cap: int,
                          device: torch.device) -> DeviceColumn:
    """-> DeviceColumn of row capacity ``cap`` on ``device``: the chunk's
    host arrays in one copy, then the expansion of its definition levels
    and dictionary indices and the row choice."""
    t0 = _clock()
    n = ch.num_rows
    n_dict = ch.idx.total if ch.uses_dict else 0
    st = _Staging()
    defs = _add_run_table(st, ch.defs)
    idx_tab = _add_run_table(st, ch.idx) if ch.uses_dict else None
    string = isinstance(out_dtype, dt.StringType)
    if string:
        if ch.uses_dict and ch.ba_dict is None:
            raise UnsupportedChunk("dict-encoded pages, no dict page")
        parts = ([ch.ba_dict] if ch.uses_dict else []) + ch.ba_plain
        dict_entries = len(ch.ba_dict[1]) if ch.uses_dict else 0
        max_len = 1
        if ch.ba_dict is not None and len(ch.ba_dict[1]):
            max_len = max(max_len, int(ch.ba_dict[1].max()))
        for _, lens, _b in ch.ba_plain:
            if len(lens):
                max_len = max(max_len, int(lens.max()))
        width = bucket_width(max_len)
        base = np.cumsum([0] + [len(b) for _, _, b in parts])[:-1]
        starts = np.concatenate([np.zeros(0, np.int64)]
                                + [s + o for (s, _, _), o in zip(parts, base)])
        lens = np.concatenate([np.zeros(0, np.int32)]
                              + [ln.astype(np.int32) for _, ln, _ in parts])
        blob = np.concatenate([np.zeros(0, np.uint8)]
                              + [b for _, _, b in parts])
        # 16 zero bytes of tail, for the kernel's aligned 16-byte reads
        i_starts, i_lens = st.add(starts), st.add(lens)
        i_blob, n_blob = st.add(blob, extra=16), len(blob)
    else:
        npdt = out_dtype.np_dtype()
        if ch.bool_plain and not ch.uses_dict:
            plain = np.concatenate([_plain_values(b, "BOOLEAN", c)
                                    for b, c in ch.bool_plain])
        elif ch.plain_parts:
            blob = b"".join(ch.plain_parts)
            size = np.dtype(_NP_BY_PHYS[ch.phys]).itemsize
            plain = _plain_values(blob, ch.phys, len(blob) // size)
        else:
            plain = np.zeros(0, npdt)
        plain = np.asarray(plain, npdt)
        plain = np.pad(plain, (0, pow2_ceil(len(plain)) - len(plain)))
        dict_vals = np.asarray(ch.dictionary, npdt) if ch.uses_dict \
            else np.zeros(1, npdt)
        dict_vals = np.pad(dict_vals, (0, pow2_ceil(len(dict_vals))
                                       - len(dict_vals)))
        i_dict, i_plain = st.add(dict_vals), st.add(plain)
    views = st.views(device, t0)
    t0 = _clock()
    levels = _expand(views, defs, cap)
    iota = torch.arange(cap, dtype=torch.int32, device=device)
    validity = torch.logical_and(levels > 0, iota < n)
    pos = torch.cumsum(validity, 0, dtype=torch.int32) - 1
    if ch.uses_dict:
        idx = _expand(views, idx_tab, pow2_ceil(n_dict))
    else:
        idx = torch.zeros(0, dtype=torch.int32, device=device)
    all_valid = ch.num_nonnull == n
    if string:
        data, lengths = pq_gather_byte_array(
            validity, pos, idx, views[i_starts], views[i_lens],
            views[i_blob], n_blob, n_dict, dict_entries, width)
        _tally("kernels", t0, device)
        return DeviceColumn(data, validity, out_dtype, all_valid=all_valid,
                            lengths=lengths)
    data = pq_gather_fixed(validity, pos, idx, views[i_dict], views[i_plain],
                           n_dict)
    _tally("kernels", t0, device)
    return DeviceColumn(data, validity, out_dtype, all_valid=all_valid)


def _note_runs(name: str, ch: _Chunk) -> None:
    """Records the chunk's run tables' shapes in an open host_split()."""
    split = _split
    if split is None:
        return
    shapes = [("defs", len(ch.defs.out_start), ch.defs.total)]
    if ch.uses_dict:
        shapes.append(("idx", len(ch.idx.out_start), ch.idx.total))
    with _split_lock:
        split["runs"].setdefault(name, []).extend(shapes)


#: what sends a column to the host decode: a chunk outside the subset or a
#: codec ``pyarrow.decompress`` refuses (UnsupportedChunk), a parse error of
#: the host half (ValueError, IndexError past the page's bytes). Not
#: OSError: the kernel library's load raises it, and that must not hide.
_HOST_DECODE_ERRORS = (UnsupportedChunk, ValueError, IndexError)


def decode_row_group(raw: bytes, pf_metadata, rg: int, arrow_schema,
                     columns: List[str], min_bucket: int,
                     device: torch.device, conf=None
                     ) -> Tuple[DeviceTable, int]:
    """Decode one row group into a DeviceTable on ``device``; a column the
    device decoder does not take decodes on the host (pyarrow) and
    uploads. Returns (DeviceTable, columns decoded on the device)."""
    t_total = _clock()
    device = torch.device(device)
    rg_meta = pf_metadata.row_group(rg)
    n = rg_meta.num_rows
    cap = bucket_rows(max(n, 1), min_bucket)
    name_to_ci = {pf_metadata.schema.column(i).path: i
                  for i in range(pf_metadata.num_columns)}
    native = device.type == "cuda"
    if native:
        # load (or build) the kernel library before any column is parsed:
        # a library that fails raises here, not into the host fallback
        from ..native import load_kernels
        load_kernels()
    cols = {}
    fallback: List[str] = []
    n_device = 0
    for name in columns:
        ci = name_to_ci.get(name)
        field = arrow_schema.field(name)
        col_meta = rg_meta.column(ci) if ci is not None else None
        if col_meta is None or not chunk_supported(col_meta, field, conf):
            fallback.append(name)
            continue
        try:
            ch = _parse_chunk(raw, col_meta, field.nullable, native)
            if ch.num_rows != n:
                raise UnsupportedChunk("row count mismatch")
        except _HOST_DECODE_ERRORS:
            fallback.append(name)
            continue
        _note_runs(name, ch)
        # outside the try: a failure of the kernels raises
        cols[name] = _decode_column_device(ch, _arrow_to_dtype(field.type),
                                           cap, device)
        n_device += 1
    if fallback:
        # per-column host decode of the rest (reference: the plugin keeps
        # unsupported columns on the CPU decode path)
        t0 = _clock()
        import pyarrow.parquet as pq
        t = pq.ParquetFile(_io.BytesIO(raw)).read_row_group(
            rg, columns=fallback)
        host = DeviceTable.from_host(HostTable.from_arrow(t), min_bucket,
                                     device, capacity=cap)
        for cname, c in zip(host.names, host.columns):
            cols[cname] = c
        _tally("host_decode", t0, device)
    mask = torch.arange(cap, device=device) < n
    ordered = tuple(cols[c] for c in columns)
    table = DeviceTable(ordered, mask,
                        torch.tensor(n, dtype=torch.int32, device=device),
                        tuple(columns))
    if _split is not None:
        _tally("total", t_total, device)
        with _split_lock:
            _split["row_groups"] += 1
    return table, n_device
