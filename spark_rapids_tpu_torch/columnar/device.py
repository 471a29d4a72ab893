"""Device-side columnar batches as torch tensors — the port of
``spark_rapids_tpu/columnar/device.py``.

The batch layout is the JAX package's, plane for plane, so batches of the
two engines can be compared directly:

1. **Bucketed capacities.** Every batch has a row capacity from the
   canonical bucket ladder (power-of-two multiples of a minimum bucket).
2. **Selection masks instead of compaction.** A filter ANDs a per-table
   ``row_mask``; masked-off rows keep stale data. Compaction (a stable
   partition of the mask plus a gather) happens only at operator boundaries
   that need dense data: exchanges, concatenation and host download.
3. **Validity as bool planes**, one per column, plus a host-side
   ``all_valid`` promise that lets kernels skip the plane.
4. **Strings as a byte matrix**: a ``(capacity, width)`` uint8 plane (each
   value left-aligned, zero-padded) plus an int32 ``lengths`` plane. The
   width is per batch, ``bucket_width`` of its longest value.
5. **Decimals** as scaled int64 up to 18 digits, and beyond as a
   ``(capacity, 2)`` int64 plane of limbs ``[hi, lo]`` with no lengths
   (expr/decimal128.py). A 2-D plane is a string when its column has
   ``lengths``, else a limb pair: every path that handles one asks that.

``num_rows`` is a 0-d int32 tensor on the batch's device: batch functions
never turn it into a Python int, so they never wait on the device. The host
reads it at the boundaries that must (download, exchange, shrink).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from . import dtypes as dt
from .host import HostColumn, HostTable, decimal_words

__all__ = ["BucketPolicy", "DeviceColumn", "DeviceTable", "append_column",
           "as_torch_dtype", "bucket_rows", "bucket_width", "drop_column",
           "concat_device_tables", "pack_string_key_words", "shrink_to_fit",
           "resolve_device", "slice_rows", "stable_partition_order",
           "to_host_batched", "torch_dtype"]

_TORCH_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.uint8): torch.uint8}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the torch dtype of a numpy dtype / scalar type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def torch_dtype(d: dt.DataType) -> torch.dtype:
    """The torch dtype of a type's value plane (uint8 for the string byte
    matrix)."""
    if isinstance(d, dt.StringType):
        return torch.uint8
    if isinstance(d, dt.BinaryType):
        raise TypeError(f"{d!r} columns are not ported to the device yet")
    return as_torch_dtype(d.np_dtype())


def resolve_device(device, who: str) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``: the engine's
    entry points run on the card unless the caller asks for the CPU, and a
    CUDA device on a machine without one raises, naming ``who``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to run "
            "the engine on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {device!r}")
    return dev


def stable_partition_order(mask: torch.Tensor) -> torch.Tensor:
    """Sort-free stable-partition permutation: int32 gather indices that put
    mask=True rows first, preserving relative order in both segments —
    ``argsort(!mask, stable=True)`` built from two cumsums and one scatter."""
    n = mask.shape[0]
    m32 = mask.to(torch.int32)
    kept_rank = torch.cumsum(m32, 0, dtype=torch.int32) - m32
    n_keep = m32.sum(dtype=torch.int32)
    drop = 1 - m32
    drop_rank = torch.cumsum(drop, 0, dtype=torch.int32) - drop
    dest = torch.where(mask, kept_rank, n_keep + drop_rank)
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    return torch.zeros(n, dtype=torch.int32, device=mask.device) \
        .scatter_(0, dest.long(), iota)


def _compact_impl(table: "DeviceTable") -> "DeviceTable":
    order = stable_partition_order(table.row_mask)
    # permutation + re-mask below: only real rows stay exposed
    cols = tuple(c.gather(order) for c in table.columns)
    iota = torch.arange(table.capacity, dtype=torch.int32,
                        device=table.row_mask.device)
    mask = iota < table.num_rows
    # masked-off tail keeps stale data; null it for hygiene
    cols = tuple(c.with_validity(torch.logical_and(c.validity, mask),
                                 all_valid=c.all_valid)
                 for c in cols)
    return DeviceTable(cols, mask, table.num_rows, table.names)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The bucket ladder: rungs are ``min_rows * growth^k``; within a rung,
    capacities quantize down toward the row count in steps of
    ``growth * rung * max_waste_frac`` (never below ``min_rows``). The
    defaults give the plain power-of-two ladder."""
    min_rows: int = 1024
    growth: float = 2.0
    max_waste_frac: float = 0.5

    def bucket(self, n: int, min_bucket: Optional[int] = None) -> int:
        base = int(min_bucket) if min_bucket is not None else self.min_rows
        cap = max(base, 1)
        while cap < n:
            # max(+1): a growth factor rounding to itself must still climb
            cap = max(cap + 1, int(cap * self.growth))
        if cap > base:
            step = max(base, int(cap * self.max_waste_frac))
            cap = min(cap, -(-n // step) * step)
        return cap


_POLICY = BucketPolicy()


def bucket_rows(n: int, min_bucket: Optional[int] = None) -> int:
    """Canonical row capacity for ``n`` rows, floored at ``min_bucket``."""
    return _POLICY.bucket(n, min_bucket)


def bucket_width(w: int, min_width: int = 8, max_width: int = 4096) -> int:
    """Byte width of a string matrix holding values of up to ``w`` bytes."""
    cap = min_width
    while cap < w:
        cap *= 2
    return min(cap, max(max_width, w))


@dataclasses.dataclass
class DeviceColumn:
    """One device column: padded values + validity (+ lengths for
    strings)."""
    data: torch.Tensor                # (capacity,); strings (capacity, width)
    validity: torch.Tensor            # (capacity,) bool — True = non-null
    dtype: dt.DataType
    #: null-freedom promise: every row under the table's row_mask is valid,
    #: so kernels may skip the validity plane (which stays correct either
    #: way). False is always safe.
    all_valid: bool = False
    #: (capacity,) int32 byte lengths of a string column, else None
    lengths: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def gather(self, idx: torch.Tensor) -> "DeviceColumn":
        """Row gather by int32 indices. Keeps ``all_valid``: callers only
        expose rows that map to real source rows (permutations,
        compaction)."""
        i = idx.long()
        return DeviceColumn(self.data.index_select(0, i),
                            self.validity.index_select(0, i), self.dtype,
                            self.all_valid,
                            None if self.lengths is None
                            else self.lengths.index_select(0, i))

    def with_validity(self, validity: torch.Tensor,
                      all_valid: bool = False) -> "DeviceColumn":
        return DeviceColumn(self.data, validity, self.dtype, all_valid,
                            self.lengths)

    def cut(self, rows: int) -> "DeviceColumn":
        """The first ``rows`` rows of every plane."""
        return DeviceColumn(self.data[:rows], self.validity[:rows],
                            self.dtype, self.all_valid,
                            None if self.lengths is None
                            else self.lengths[:rows])


@dataclasses.dataclass
class DeviceTable:
    """A batch of device columns + row mask (active rows) + row count."""
    columns: Tuple[DeviceColumn, ...]
    row_mask: torch.Tensor           # (capacity,) bool — True = row exists
    num_rows: torch.Tensor           # 0-d int32 == sum(row_mask)
    names: Tuple[str, ...]

    @property
    def capacity(self) -> int:
        return self.row_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.names.index(name)]

    def filter_mask(self, keep: torch.Tensor) -> "DeviceTable":
        """AND a predicate into the row mask (no data movement)."""
        mask = torch.logical_and(self.row_mask, keep)
        return DeviceTable(self.columns, mask, mask.sum(dtype=torch.int32),
                           self.names)

    def compact(self) -> "DeviceTable":
        """Move active rows to the front (stable). Same capacity; afterwards
        ``row_mask == iota < num_rows``."""
        return _compact_impl(self)

    def nbytes(self) -> int:
        total = self.row_mask.numel() + 4
        for c in self.columns:
            total += c.data.numel() * c.data.element_size() \
                + c.validity.numel()
            if c.lengths is not None:
                total += c.lengths.numel() * c.lengths.element_size()
        return total

    # -- host <-> device ------------------------------------------------------
    @staticmethod
    def from_host(table: HostTable, min_bucket: Optional[int],
                  device: torch.device,
                  capacity: Optional[int] = None) -> "DeviceTable":
        n = table.num_rows
        cap = capacity if capacity is not None \
            else bucket_rows(max(n, 1), min_bucket)
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} rows")
        cols = [_upload_column(hc, cap, device) for hc in table.columns]
        row_mask = torch.from_numpy(np.arange(cap) < n).to(device)
        return DeviceTable(tuple(cols), row_mask,
                           torch.tensor(n, dtype=torch.int32, device=device),
                           tuple(table.names))

    def to_host(self) -> HostTable:
        """Download and compact to exactly num_rows host rows."""
        return to_host_batched([self])[0]


def _host_column(dtype: dt.DataType, data: np.ndarray, validity: np.ndarray,
                 lengths: Optional[np.ndarray], mask: np.ndarray,
                 n: int) -> HostColumn:
    """A downloaded column's planes -> its host column over the active
    rows."""
    validity = validity[mask][:n]
    opt_valid = None if validity.all() else validity
    vals = data[mask][:n]
    if lengths is not None:
        return HostColumn(dtype, _decode_string_matrix(vals,
                                                       lengths[mask][:n]),
                          opt_valid)
    if dt.is_d128(dtype):
        # the signed hi limb makes the composition the signed value
        from ..expr.decimal128 import limbs_to_py_ints
        return HostColumn(dtype, limbs_to_py_ints(vals), opt_valid)
    return HostColumn(dtype, vals, opt_valid)


def to_host_batched(tables: Sequence["DeviceTable"]) -> List[HostTable]:
    """Download many device batches together (the JAX package's
    ``to_host_batched``): every plane of every batch is grouped by dtype,
    and each group crosses to the host in ONE copy, so a drain waits on the
    device once per plane type instead of once per plane and batch. Each
    table then decodes on the host over its active rows."""
    tables = list(tables)
    if not tables:
        return []
    planes: List[torch.Tensor] = []
    for t in tables:
        planes += [t.row_mask, t.num_rows.reshape(1)]
        for c in t.columns:
            planes += [c.data, c.validity]
            if c.lengths is not None:
                planes.append(c.lengths)
    # one table (``to_host``) copies plane by plane: a concatenation would
    # only hold a second copy of its planes on the device
    bulk = len(tables) > 1
    groups: dict = {}
    for i, p in enumerate(planes):
        groups.setdefault(p.dtype if bulk else i, []).append(i)
    host: List[Optional[np.ndarray]] = [None] * len(planes)
    for idx in groups.values():
        parts = [planes[i].reshape(-1) for i in idx]
        flat = (torch.cat(parts) if len(parts) > 1 else parts[0]) \
            .cpu().numpy()
        pos = 0
        for i in idx:
            k = planes[i].numel()
            host[i] = flat[pos:pos + k].reshape(tuple(planes[i].shape))
            pos += k
    out: List[HostTable] = []
    it = iter(host)
    for t in tables:
        mask = next(it)
        n = int(next(it)[0])
        cols = []
        for c in t.columns:
            data, validity = next(it), next(it)
            lengths = next(it) if c.lengths is not None else None
            cols.append(_host_column(c.dtype, data, validity, lengths, mask,
                                     n))
        out.append(HostTable(list(t.names), cols))
    return out


def _encode_string_matrix(values: np.ndarray, capacity: int,
                          arrow: Optional[pa.Array] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str -> (capacity, width) uint8 matrix + int32
    lengths, from Arrow's offsets and data buffers with one fancy-index
    scatter (no per-row Python loop). ``arrow``, when the column carries
    it, skips building the Arrow array from ``values``."""
    n = len(values)
    arr = arrow if arrow is not None else pa.array(values, type=pa.string(),
                                                   from_pandas=True)
    if pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.string())
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32,
                            count=n + 1 + arr.offset)[arr.offset:]
    blob_buf = arr.buffers()[2]
    blob = np.frombuffer(blob_buf, dtype=np.uint8) if blob_buf is not None \
        else np.zeros(0, dtype=np.uint8)
    starts = offsets[:-1].astype(np.int64)
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    width = bucket_width(max(int(lengths.max()) if n else 0, 1))
    mat = np.zeros((capacity, width), dtype=np.uint8)
    total = int(offsets[-1]) - int(offsets[0])
    if total and (lengths == lengths[0]).all():
        # values of one length: the data buffer is the matrix's rows
        mat[:n, :lengths[0]] = blob[int(offsets[0]):int(offsets[-1])] \
            .reshape(n, lengths[0])
    elif total:
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        flat = np.arange(int(offsets[0]), int(offsets[-1]), dtype=np.int64)
        cols = flat - np.repeat(starts, lengths)
        mat[rows, cols] = blob[flat]
    out_lengths = np.zeros(capacity, dtype=np.int32)
    out_lengths[:n] = lengths
    return mat, out_lengths


def _decode_string_matrix(data: np.ndarray, lengths: np.ndarray
                          ) -> np.ndarray:
    """(n, width) byte matrix + lengths -> object array of str, through one
    Arrow varlen array (the inverse of ``_encode_string_matrix``)."""
    n = len(lengths)
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    if total:
        rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
        cols = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
        blob = np.ascontiguousarray(data[rows, cols])
    else:
        blob = np.zeros(0, dtype=np.uint8)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    try:
        arr = pa.Array.from_buffers(pa.string(), n, [
            None, pa.py_buffer(offsets.tobytes()),
            pa.py_buffer(blob.tobytes())])
        arr.validate(full=True)
        return arr.to_numpy(zero_copy_only=False).astype(object)
    except pa.ArrowInvalid:
        # invalid UTF-8: per-row decode with replacement
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = bytes(data[i, :lengths[i]]).decode("utf-8",
                                                       errors="replace")
        return out


def _upload_column(hc: HostColumn, capacity: int,
                   device: torch.device) -> DeviceColumn:
    n = len(hc)
    validity = np.zeros(capacity, dtype=np.bool_)
    validity[:n] = hc.valid_mask()
    all_valid = hc.validity is None or bool(validity[:n].all())
    torch_dtype(hc.dtype)  # raises for the types not ported to the device
    if isinstance(hc.dtype, dt.StringType):
        mat, lengths = _encode_string_matrix(hc.values, capacity, hc.arrow)
        return DeviceColumn(torch.from_numpy(mat).to(device),
                            torch.from_numpy(validity).to(device), hc.dtype,
                            all_valid, torch.from_numpy(lengths).to(device))
    if dt.is_d128(hc.dtype):
        return DeviceColumn(torch.from_numpy(_host_limbs(hc, capacity))
                            .to(device),
                            torch.from_numpy(validity).to(device), hc.dtype,
                            all_valid)
    vals = np.zeros(capacity, dtype=hc.dtype.np_dtype())
    vals[:n] = hc.values
    return DeviceColumn(torch.from_numpy(vals).to(device),
                        torch.from_numpy(validity).to(device), hc.dtype,
                        all_valid)


def _host_limbs(hc: HostColumn, capacity: int) -> np.ndarray:
    """A wide decimal column's ``(capacity, 2)`` int64 limbs ``[hi, lo]``:
    from the Arrow buffer it was read from when it has one, else from its
    Python ints."""
    if hc.arrow is not None:
        words = decimal_words(hc.arrow)
        limbs = np.zeros((capacity, 2), dtype=np.int64)
        limbs[:len(words)] = words[:, ::-1]
        return limbs
    from ..expr.decimal128 import limbs_from_py_ints
    return limbs_from_py_ints(hc.values, capacity)


def concat_device_tables(tables: Sequence[DeviceTable],
                         min_bucket: Optional[int] = None) -> DeviceTable:
    """Device-side concatenation (reference: GpuCoalesceBatches concat):
    compacts each input, concatenates into a bucketed capacity."""
    if not tables:
        raise ValueError("cannot concat zero device tables")
    if len(tables) == 1:
        return tables[0]
    first = tables[0]
    total_cap = sum(t.capacity for t in tables)
    # a bucketed capacity keeps the set of shapes downstream small
    out_cap = bucket_rows(total_cap, min_bucket)
    tail = out_cap - total_cap
    compacted = [t.compact() for t in tables]

    def cat(planes: List[torch.Tensor]) -> torch.Tensor:
        out = torch.cat(planes)
        if not tail:
            return out
        # F.pad pads the last dimension first: (0, 0) keeps a matrix's width
        return torch.nn.functional.pad(
            out, (0, 0) * (out.dim() - 1) + (0, tail))

    out_cols = []
    for ci in range(first.num_columns):
        parts = [t.columns[ci] for t in compacted]
        lengths = None
        datas = [p.data for p in parts]
        if parts[0].lengths is not None:
            # string matrices: pad every part to the widest part's width
            width = max(d.shape[1] for d in datas)
            datas = [torch.nn.functional.pad(d, (0, width - d.shape[1]))
                     for d in datas]
            lengths = cat([p.lengths for p in parts])
        out_cols.append(DeviceColumn(
            cat(datas), cat([p.validity for p in parts]),
            parts[0].dtype, all(p.all_valid for p in parts), lengths))
    row_mask = cat([t.row_mask for t in compacted])
    num_rows = torch.stack([t.num_rows for t in tables]).sum(dtype=torch.int32)
    return DeviceTable(tuple(out_cols), row_mask, num_rows,
                       first.names).compact()


def shrink_to_fit(table: DeviceTable, min_bucket: Optional[int] = None,
                  num_rows: Optional[int] = None) -> DeviceTable:
    """Compact and shrink capacity to the bucket of the active row count.

    Reads the row count on the host (one int, a device wait) unless the
    caller already holds it and passes ``num_rows``."""
    floor = min_bucket if min_bucket is not None else _POLICY.min_rows
    if table.capacity <= floor:
        return table  # cannot shrink below one bucket: skip the device wait
    n = num_rows if num_rows is not None else int(table.num_rows)
    cap = bucket_rows(max(n, 1), min_bucket)
    if cap >= table.capacity:
        return table
    compacted = table.compact()
    cols = tuple(c.cut(cap) for c in compacted.columns)
    return DeviceTable(cols, compacted.row_mask[:cap], compacted.num_rows,
                       compacted.names)


def slice_rows(table: DeviceTable, start: int, length: int) -> DeviceTable:
    """The row window ``[start, start + length)`` as a table of capacity
    ``length`` (the JAX package's ``slice_rows``): ``start`` is clamped to
    ``[0, capacity - length]`` as ``dynamic_slice`` clamps it, a window past
    the capacity is zero-padded, and rows past the table's active count are
    masked off."""
    start = min(max(int(start), 0), max(table.capacity - length, 0))

    def slc(a: torch.Tensor) -> torch.Tensor:
        out = a[start:start + length]
        if length > a.shape[0]:
            out = torch.nn.functional.pad(
                out, (0, 0) * (a.dim() - 1) + (0, length - a.shape[0]))
        return out

    cols = tuple(DeviceColumn(slc(c.data), slc(c.validity), c.dtype,
                              c.all_valid,
                              None if c.lengths is None else slc(c.lengths))
                 for c in table.columns)
    iota = torch.arange(length, dtype=torch.int32, device=table.device)
    mask = torch.logical_and(slc(table.row_mask),
                             (iota + start) < table.num_rows)
    return DeviceTable(cols, mask, mask.sum(dtype=torch.int32), table.names)


def append_column(table: DeviceTable, name: str, col: DeviceColumn
                  ) -> DeviceTable:
    return DeviceTable(table.columns + (col,), table.row_mask,
                       table.num_rows, table.names + (name,))


def drop_column(table: DeviceTable, name: str) -> DeviceTable:
    i = table.names.index(name)
    return DeviceTable(table.columns[:i] + table.columns[i + 1:],
                       table.row_mask, table.num_rows,
                       table.names[:i] + table.names[i + 1:])


def pack_string_key_words(data: torch.Tensor, lengths: torch.Tensor
                          ) -> List[torch.Tensor]:
    """(cap, width) uint8 matrix + lengths -> 1-D int64 words, most
    significant first: 8 bytes per word big-endian, then the length as the
    last word, so zero padding cannot conflate "ab" with "ab\\x00".

    The words hold the bit patterns of the JAX package's uint64 words. As
    torch has no unsigned 64-bit order, a caller that sorts by them flips
    the sign bit first (``w ^ -2**63``); equality needs nothing."""
    cap, w = data.shape
    pad = -w % 8
    if pad:
        data = torch.nn.functional.pad(data, (0, pad))
    # reversing each 8-byte group and reading it as one little-endian
    # int64 packs the group big-endian
    packed = data.reshape(cap, -1, 8).flip(2).contiguous() \
        .view(torch.int64).reshape(cap, -1)
    return [packed[:, i] for i in range(packed.shape[1])] \
        + [lengths.to(torch.int64)]
