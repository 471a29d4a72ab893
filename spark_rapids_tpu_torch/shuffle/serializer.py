"""Host columnar batch serialization — the port of
``spark_rapids_tpu/shuffle/serializer.py`` (reference:
GpuColumnarBatchSerializer + JCudfSerialization + TableCompressionCodec).

Framed binary format (little-endian)::

    magic 'SRTT' | u32 version | u32 codec | u64 body_len | u64 raw_len | body

The body (compressed by the codec) is a u32-length JSON header and the raw
column buffers. Strings travel as int32 offsets + concatenated UTF-8 bytes
(dense), a wide decimal as two int64 limbs a value (low limb first), the
rest as their numpy buffers; validity as packed bits. Codecs: ``none``,
``zlib`` and ``lz4`` (the LZ4 block codec of the host native library,
``host_native.py``, whose bytes are the JAX package's).
"""
from __future__ import annotations

import io
import json
import struct
import zlib
from typing import List

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.host import HostColumn, HostTable

__all__ = ["serialize_table", "deserialize_table", "CODECS", "default_codec"]

_MAGIC = b"SRTT"
_VERSION = 3

CODECS = {"none": 0, "zlib": 1, "lz4": 2}
_CODEC_BY_ID = {v: k for k, v in CODECS.items()}
_MASK64 = (1 << 64) - 1


def default_codec() -> str:
    """The codec a shuffle manager takes for a codec the serializer does
    not have (``zstd``), as the JAX package's: lz4, through the host
    library, which must build (it raises otherwise)."""
    from ..host_native import load_host_native
    load_host_native()
    return "lz4"


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}")


def _limbs(values: np.ndarray) -> np.ndarray:
    """Python ints -> (n, 2) uint64, low limb first (two's complement)."""
    out = np.zeros((len(values), 2), dtype=np.uint64)
    for i, v in enumerate(values):
        u = int(v) & ((1 << 128) - 1)
        out[i, 0] = u & _MASK64
        out[i, 1] = u >> 64
    return out


def _from_limbs(limbs: np.ndarray) -> np.ndarray:
    out = np.empty(len(limbs), dtype=object)
    for i, (lo, hi) in enumerate(limbs.tolist()):
        u = (hi << 64) | lo
        out[i] = u - (1 << 128) if u >> 127 else u
    return out


def serialize_table(table: HostTable, codec: str = "none") -> bytes:
    _check_codec(codec)
    n = table.num_rows
    header = {"n": n, "cols": []}
    payloads: List[bytes] = []
    for name, col in zip(table.names, table.columns):
        entry = {"name": name, "dtype": repr(col.dtype),
                 "has_validity": col.validity is not None}
        if isinstance(col.dtype, (dt.StringType, dt.BinaryType)):
            encoded = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                       for v in col.values]
            offsets = np.zeros(n + 1, dtype=np.int32)
            np.cumsum([len(b) for b in encoded], out=offsets[1:])
            blob = b"".join(encoded)
            entry["nbytes"] = [offsets.nbytes, len(blob)]
            payloads += [offsets.tobytes(), blob]
        elif dt.is_d128(col.dtype):
            data = _limbs(col.values)
            entry["nbytes"] = [data.nbytes]
            payloads.append(data.tobytes())
        else:
            data = np.ascontiguousarray(col.values)
            entry["np"] = data.dtype.str
            entry["nbytes"] = [data.nbytes]
            payloads.append(data.tobytes())
        if col.validity is not None:
            v = np.packbits(col.validity)
            entry["validity_nbytes"] = v.nbytes
            payloads.append(v.tobytes())
        header["cols"].append(entry)
    hj = json.dumps(header).encode()
    body = struct.pack("<I", len(hj)) + hj + b"".join(payloads)
    raw_len = len(body)
    if codec == "zlib":
        body = zlib.compress(body, level=1)
    elif codec == "lz4":
        from ..host_native import lz4_compress
        body = lz4_compress(body)
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<II", _VERSION, CODECS[codec]))
    buf.write(struct.pack("<QQ", len(body), raw_len))
    buf.write(body)
    return buf.getvalue()


def deserialize_table(data: bytes) -> HostTable:
    if data[:4] != _MAGIC:
        raise ValueError("not a serialized table (bad magic)")
    version, codec_id = struct.unpack_from("<II", data, 4)
    if version != _VERSION:
        raise ValueError(f"serialized table version {version}, expected "
                         f"{_VERSION}")
    length, raw_len = struct.unpack_from("<QQ", data, 12)
    body = data[28:28 + length]
    codec = _CODEC_BY_ID[codec_id]
    if codec == "zlib":
        body = zlib.decompress(body)
    elif codec == "lz4":
        from ..host_native import lz4_decompress
        body = lz4_decompress(body, raw_len)
    (hlen,) = struct.unpack_from("<I", body, 0)
    header = json.loads(body[4:4 + hlen])
    pos = 4 + hlen
    n = header["n"]
    names, cols = [], []
    for entry in header["cols"]:
        d = dt.from_simple_name(entry["dtype"])
        if isinstance(d, (dt.StringType, dt.BinaryType)):
            olen, blen = entry["nbytes"]
            offsets = np.frombuffer(body, dtype=np.int32, count=n + 1,
                                    offset=pos)
            pos += olen
            blob = body[pos:pos + blen]
            pos += blen
            vals = np.empty(n, dtype=object)
            for i in range(n):
                raw = blob[offsets[i]:offsets[i + 1]]
                vals[i] = raw.decode("utf-8") \
                    if isinstance(d, dt.StringType) else bytes(raw)
        elif dt.is_d128(d):
            (nbytes,) = entry["nbytes"]
            limbs = np.frombuffer(body, dtype=np.uint64, count=2 * n,
                                  offset=pos).reshape(n, 2)
            vals = _from_limbs(limbs)
            pos += nbytes
        else:
            (nbytes,) = entry["nbytes"]
            vals = np.frombuffer(body, dtype=np.dtype(entry["np"]), count=n,
                                 offset=pos).copy()
            pos += nbytes
        validity = None
        if entry["has_validity"]:
            vb = np.frombuffer(body, dtype=np.uint8,
                               count=entry["validity_nbytes"], offset=pos)
            pos += entry["validity_nbytes"]
            validity = np.unpackbits(vb)[:n].astype(bool)
        names.append(entry["name"])
        cols.append(HostColumn(d, vals, validity))
    return HostTable(names, cols)
