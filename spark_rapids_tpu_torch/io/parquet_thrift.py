"""Minimal Thrift compact-protocol reader for parquet page headers — the
port's copy of ``spark_rapids_tpu/io/parquet_thrift.py`` (pure Python; the
port imports nothing of the JAX package).

Reference: the plugin's device parquet reader walks raw column chunks and
parses page headers itself rather than round-tripping through the host
decoder (GpuParquetScanBase.scala:995,1194; the native kernels consume raw
page buffers). pyarrow exposes file/row-group/column-chunk METADATA but not
page boundaries, so this module implements just enough of the Thrift compact
protocol (parquet.thrift PageHeader and friends) to split a column chunk
into its pages. Implemented from the public Thrift compact protocol spec.

Only the fields the device decoder needs are materialized; everything else
is skipped structurally (unknown fields must be skipped, not rejected, for
forward compatibility).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["PageHeader", "read_page_header", "Encoding", "PageType"]


class PageType:
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


class Encoding:
    PLAIN = 0
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    RLE_DICTIONARY = 8


@dataclass
class PageHeader:
    page_type: int
    uncompressed_size: int
    compressed_size: int
    num_values: int = 0
    encoding: int = Encoding.PLAIN
    def_level_encoding: int = Encoding.RLE
    rep_level_encoding: int = Encoding.RLE
    header_bytes: int = 0  # length of the serialized header itself
    # DataPageHeaderV2 extras (parquet.thrift): levels sit uncompressed in
    # front of the (optionally compressed) values section
    num_nulls: int = 0
    def_levels_byte_length: int = 0
    rep_levels_byte_length: int = 0
    v2_is_compressed: bool = True


# -- compact protocol primitives --------------------------------------------
_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _skip(buf: bytes, pos: int, ctype: int) -> int:
    if ctype in (_CT_TRUE, _CT_FALSE):
        return pos
    if ctype == _CT_BYTE:
        return pos + 1
    if ctype in (_CT_I16, _CT_I32, _CT_I64):
        _, pos = _varint(buf, pos)
        return pos
    if ctype == _CT_DOUBLE:
        return pos + 8
    if ctype == _CT_BINARY:
        n, pos = _varint(buf, pos)
        return pos + n
    if ctype in (_CT_LIST, _CT_SET):
        head = buf[pos]
        pos += 1
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        for _ in range(size):
            pos = _skip(buf, pos, etype)
        return pos
    if ctype == _CT_MAP:
        size, pos = _varint(buf, pos)
        if size:
            kv = buf[pos]
            pos += 1
            for _ in range(size):
                pos = _skip(buf, pos, kv >> 4)
                pos = _skip(buf, pos, kv & 0x0F)
        return pos
    if ctype == _CT_STRUCT:
        fid = 0
        while True:
            head = buf[pos]
            pos += 1
            if head == _CT_STOP:
                return pos
            delta = head >> 4
            ftype = head & 0x0F
            if delta:
                fid += delta
            else:
                z, pos = _varint(buf, pos)
                fid = _zigzag(z)
            pos = _skip(buf, pos, ftype)
    raise ValueError(f"unknown thrift compact type {ctype}")


class _StructReader:
    """Iterate (field_id, ctype, pos) over one compact struct."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.fid = 0

    def fields(self):
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _CT_STOP:
                return
            delta = head >> 4
            ctype = head & 0x0F
            if delta:
                self.fid += delta
            else:
                z, self.pos = _varint(self.buf, self.pos)
                self.fid = _zigzag(z)
            yield self.fid, ctype

    def read_i32(self) -> int:
        z, self.pos = _varint(self.buf, self.pos)
        return _zigzag(z)

    def skip(self, ctype: int):
        self.pos = _skip(self.buf, self.pos, ctype)


def read_page_header(buf: bytes, pos: int = 0) -> PageHeader:
    """Parse one PageHeader starting at ``pos``; header_bytes records how
    many bytes the header consumed (page data follows immediately)."""
    start = pos
    hdr = PageHeader(page_type=-1, uncompressed_size=0, compressed_size=0)
    r = _StructReader(buf, pos)
    for fid, ctype in r.fields():
        if fid == 1:        # PageType
            hdr.page_type = r.read_i32()
        elif fid == 2:      # uncompressed_page_size
            hdr.uncompressed_size = r.read_i32()
        elif fid == 3:      # compressed_page_size
            hdr.compressed_size = r.read_i32()
        elif fid == 5 and ctype == _CT_STRUCT:   # DataPageHeader
            dr = _StructReader(r.buf, r.pos)
            for dfid, dctype in dr.fields():
                if dfid == 1:
                    hdr.num_values = dr.read_i32()
                elif dfid == 2:
                    hdr.encoding = dr.read_i32()
                elif dfid == 3:
                    hdr.def_level_encoding = dr.read_i32()
                elif dfid == 4:
                    hdr.rep_level_encoding = dr.read_i32()
                else:
                    dr.skip(dctype)
            r.pos = dr.pos
        elif fid == 7 and ctype == _CT_STRUCT:   # DictionaryPageHeader
            dr = _StructReader(r.buf, r.pos)
            for dfid, dctype in dr.fields():
                if dfid == 1:
                    hdr.num_values = dr.read_i32()
                elif dfid == 2:
                    hdr.encoding = dr.read_i32()
                else:
                    dr.skip(dctype)
            r.pos = dr.pos
        elif fid == 8 and ctype == _CT_STRUCT:   # DataPageHeaderV2
            dr = _StructReader(r.buf, r.pos)
            for dfid, dctype in dr.fields():
                if dfid == 1:
                    hdr.num_values = dr.read_i32()
                elif dfid == 2:
                    hdr.num_nulls = dr.read_i32()
                elif dfid == 4:
                    hdr.encoding = dr.read_i32()
                elif dfid == 5:
                    hdr.def_levels_byte_length = dr.read_i32()
                elif dfid == 6:
                    hdr.rep_levels_byte_length = dr.read_i32()
                elif dfid == 7:
                    # bool lives in the field-header type nibble
                    hdr.v2_is_compressed = (dctype == _CT_TRUE)
                else:
                    dr.skip(dctype)
            r.pos = dr.pos
        else:
            r.skip(ctype)
    hdr.header_bytes = r.pos - start
    return hdr
