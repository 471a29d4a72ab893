"""The Parquet page decode's device kernels, each beside its plain PyTorch
version (kernels: csrc/parquet_decode.cu; the host half that feeds them is
io/parquet_device.py).

They replace the XLA code of ``spark_rapids_tpu/io/parquet_device.py``:
- ``pq_expand_hybrid``: ``_expand_hybrid_device`` :404, the expansion of an
  RLE/bit-packed hybrid run table (definition levels, dictionary indices);
- ``pq_gather_fixed``: the row choice of ``_mixed_kernel_builder`` :429 (a
  dictionary value or a plain value per row, 0 at a null);
- ``pq_gather_byte_array``: the row choice of ``_ba_kernel_builder`` :457
  for BYTE_ARRAY columns, straight from the page bytes into the
  ``(rows, width)`` string matrix.

A run table is one int64 tensor ``runs`` of shape ``(5, R)``: the rows are
each run's first output position (ascending; padding runs start at the
table's total), whether it is an RLE run, its RLE value, its first bit in
``packed`` and its bit width (at most 24). ``packed`` holds the bit-packed
runs' bytes; ``n_packed`` is its length as the JAX package clamps reads to
it (``g(k)`` at :419). The kernel reads ``packed`` in aligned 32-bit words,
so on the card its tensor is 4-byte aligned and holds at least
``round_up(n_packed, 4) + 4`` bytes. The string gather reads its page bytes
``blob`` (``n_blob`` of them used) in aligned 16-byte pieces, so ``blob``
is 16-byte aligned and holds ``n_blob + 16`` bytes, on every device.

A wrapper checks its inputs, then computes the plain version for tensors on
the CPU, or launches the kernel on the current stream of a CUDA device and
counts the launch in ``<wrapper>.launches``; a failed launch raises. There
is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["pq_expand_hybrid", "pq_expand_hybrid_reference",
           "pq_gather_fixed", "pq_gather_fixed_reference",
           "pq_gather_byte_array", "pq_gather_byte_array_reference",
           "MAX_BIT_WIDTH", "pow2_ceil"]

#: the widest bit-packed run the decoder takes (4 bytes cover a value)
MAX_BIT_WIDTH = 24

_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _check(name: str, t: torch.Tensor, dtype, dim: int, device) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous {dim}-D {dtype} "
                        f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(fn, kernel: str, *args) -> None:
    from ..native import load_kernels
    lib = load_kernels()
    rc = getattr(lib, kernel)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    fn.launches += 1


# ---------------------------------------------------------------------------
# Run-table expansion
# ---------------------------------------------------------------------------
def pq_expand_hybrid_reference(runs: torch.Tensor, packed: torch.Tensor,
                               n_packed: int, cap: int) -> torch.Tensor:
    """Plain version of ``pq_expand_hybrid``: the JAX function's arithmetic
    in int64 (torch has no shifts on uint32), masked to 32 bits."""
    dev = runs.device
    out_start, is_rle, rle_value, bit_base, widths = runs
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    r = runs.shape[1]
    run = (torch.searchsorted(out_start, i, right=True) - 1).clamp(0, r - 1)
    w = widths[run]
    bit = bit_base[run] + (i - out_start[run]) * w
    byte0 = bit >> 3
    shift = bit & 7
    src = packed[:n_packed].to(torch.int64)

    def g(k: int) -> torch.Tensor:
        return src[(byte0 + k).clamp(0, n_packed - 1)]

    dword = g(0) | (g(1) << 8) | (g(2) << 16) | (g(3) << 24)
    mask = ((1 << w) - 1) & 0xFFFFFFFF
    bp_val = (dword >> shift) & mask
    return torch.where(is_rle[run] != 0, rle_value[run],
                       bp_val).to(torch.int32)


def pq_expand_hybrid(runs: torch.Tensor, packed: torch.Tensor,
                     n_packed: int, cap: int) -> torch.Tensor:
    """The values at output positions ``0..cap-1`` of a hybrid run table:
    for each position, its run (the last whose first position is at or
    before it, clamped into the table), then the run's RLE value or its bit
    field, LSB first. Returns int32 ``(cap,)`` (values are below 2^24)."""
    dev = runs.device
    _check("runs", runs, torch.int64, 2, dev)
    _check("packed", packed, torch.uint8, 1, dev)
    if runs.shape[0] != 5 or runs.shape[1] < 1:
        raise ValueError(f"runs must be (5, R >= 1), got {tuple(runs.shape)}")
    if not 1 <= n_packed <= packed.numel():
        raise ValueError(f"n_packed {n_packed} outside 1..{packed.numel()}")
    if dev.type == "cpu":
        return pq_expand_hybrid_reference(runs, packed, n_packed, cap)
    if dev.type != "cuda":
        raise TypeError(f"pq_expand_hybrid: no kernel for device {dev}")
    if packed.data_ptr() % 4 or packed.numel() < -(-n_packed // 4) * 4 + 4:
        raise ValueError("pq_expand_hybrid: packed must be 4-byte aligned "
                         "and hold round_up(n_packed, 4) + 4 bytes")
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap:
        with torch.cuda.device(dev):
            _launch(pq_expand_hybrid, "srt_pq_expand_hybrid", runs.data_ptr(),
                    runs.shape[1], packed.data_ptr(), n_packed, cap,
                    out.data_ptr())
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
pq_expand_hybrid.launches = 0


# ---------------------------------------------------------------------------
# Fixed-width row choice
# ---------------------------------------------------------------------------
def pq_gather_fixed_reference(validity: torch.Tensor, pos: torch.Tensor,
                              idx: torch.Tensor, dict_vals: torch.Tensor,
                              plain: torch.Tensor,
                              n_dict: int) -> torch.Tensor:
    """Plain version of ``pq_gather_fixed``."""
    p = pos.to(torch.int64)
    if n_dict:
        k = idx[p.clamp(0, idx.numel() - 1)].to(torch.int64)
        v_dict = dict_vals[k.clamp(0, dict_vals.numel() - 1)]
    else:
        v_dict = torch.zeros_like(plain[:1]).expand(p.numel())
    v_plain = plain[(p - n_dict).clamp(0, plain.numel() - 1)]
    vals = torch.where(p < n_dict, v_dict, v_plain)
    return torch.where(validity, vals, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))


def pq_gather_fixed(validity: torch.Tensor, pos: torch.Tensor,
                    idx: torch.Tensor, dict_vals: torch.Tensor,
                    plain: torch.Tensor, n_dict: int) -> torch.Tensor:
    """Per row ``r`` of a fixed-width chunk: 0 where ``validity`` is False;
    else, with ``p = pos[r]`` (the row's place among the chunk's non-null
    values), ``dict_vals[idx[p]]`` while ``p < n_dict`` and ``plain[p -
    n_dict]`` after, every index clamped into its array as the JAX package
    clamps it. ``validity`` bool and ``pos`` int32 ``(cap,)``, ``idx``
    int32 (the expanded dictionary indices; unused when ``n_dict`` is 0),
    ``dict_vals`` and ``plain`` 1-D of the output dtype (1, 2, 4 or 8
    bytes), neither empty. Returns ``(cap,)`` of that dtype."""
    dev = validity.device
    _check("validity", validity, torch.bool, 1, dev)
    _check("pos", pos, torch.int32, 1, dev)
    _check("idx", idx, torch.int32, 1, dev)
    _check("dict_vals", dict_vals, dict_vals.dtype, 1, dev)
    _check("plain", plain, dict_vals.dtype, 1, dev)
    if pos.shape != validity.shape:
        raise ValueError(f"pos {tuple(pos.shape)} != validity "
                         f"{tuple(validity.shape)}")
    if not dict_vals.numel() or not plain.numel() \
            or (n_dict and not idx.numel()):
        raise ValueError("pq_gather_fixed: empty dict_vals, plain or idx")
    size = dict_vals.element_size()
    if size not in _WORD:
        raise TypeError(f"pq_gather_fixed: no kernel for {dict_vals.dtype}")
    if dev.type == "cpu":
        return pq_gather_fixed_reference(validity, pos, idx, dict_vals,
                                         plain, n_dict)
    if dev.type != "cuda":
        raise TypeError(f"pq_gather_fixed: no kernel for device {dev}")
    cap = validity.numel()
    out = torch.empty(cap, dtype=dict_vals.dtype, device=dev)
    if cap:
        word = _WORD[size]
        with torch.cuda.device(dev):
            _launch(pq_gather_fixed, "srt_pq_gather_fixed", size,
                    validity.data_ptr(), pos.data_ptr(), idx.data_ptr(),
                    idx.numel(), dict_vals.view(word).data_ptr(),
                    dict_vals.numel(), plain.view(word).data_ptr(),
                    plain.numel(), n_dict, cap, out.view(word).data_ptr())
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
pq_gather_fixed.launches = 0


# ---------------------------------------------------------------------------
# BYTE_ARRAY row choice
# ---------------------------------------------------------------------------
def _ba_entries(validity: torch.Tensor, pos: torch.Tensor, idx: torch.Tensor,
                n_dict: int, dict_entries: int, plain_entries: int
                ) -> torch.Tensor:
    """The value entry of each row (-1: null, or a padding row of the JAX
    package's pow2-padded matrices), in the entry order dictionary then
    plain."""
    p = pos.to(torch.int64)
    d_rows = pow2_ceil(dict_entries)
    p_rows = pow2_ceil(plain_entries)
    none = torch.full_like(p, -1)
    if n_dict:
        k = idx[p.clamp(0, idx.numel() - 1)].to(torch.int64) \
            .clamp(0, d_rows - 1)
        from_dict = torch.where(k < dict_entries, k, none)
    else:
        from_dict = none
    q = (p - n_dict).clamp(0, p_rows - 1)
    from_plain = torch.where(q < plain_entries, dict_entries + q, none)
    entry = torch.where(p < n_dict, from_dict, from_plain)
    return torch.where(validity, entry, none)


def pow2_ceil(n: int) -> int:
    """The least power of two >= ``n`` (1 for ``n <= 1``): the JAX
    package's padding of run tables, dictionaries and plain values."""
    c = 1
    while c < n:
        c *= 2
    return c


def pq_gather_byte_array_reference(validity: torch.Tensor, pos: torch.Tensor,
                                   idx: torch.Tensor, starts: torch.Tensor,
                                   lens: torch.Tensor, blob: torch.Tensor,
                                   n_dict: int, dict_entries: int,
                                   width: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``pq_gather_byte_array``."""
    entry = _ba_entries(validity, pos, idx, n_dict, dict_entries,
                        starts.numel() - dict_entries)
    e = entry.clamp(0, max(starts.numel() - 1, 0))
    has = entry >= 0
    zero = torch.zeros((), dtype=torch.int32, device=lens.device)
    length = torch.where(has, lens[e] if lens.numel() else zero, zero)
    col = torch.arange(width, dtype=torch.int64, device=blob.device)
    inside = col[None, :] < length[:, None]
    start = starts[e] if starts.numel() else torch.zeros_like(e)
    src = torch.where(inside, start[:, None] + col[None, :], 0)
    src = src.clamp(0, max(blob.numel() - 1, 0))
    vals = blob[src] if blob.numel() else torch.zeros_like(src,
                                                           dtype=torch.uint8)
    data = torch.where(inside, vals, torch.zeros((), dtype=torch.uint8,
                                                 device=blob.device))
    return data, length


def pq_gather_byte_array(validity: torch.Tensor, pos: torch.Tensor,
                         idx: torch.Tensor, starts: torch.Tensor,
                         lens: torch.Tensor, blob: torch.Tensor, n_blob: int,
                         n_dict: int, dict_entries: int, width: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The string matrix of a BYTE_ARRAY chunk, straight from its page
    bytes. The chunk's values are entries of ``blob[:n_blob]`` (``starts``
    int64 and ``lens`` int32 per entry; a read outside it clamps into it):
    its ``dict_entries`` dictionary values first,
    then its plain values. Row ``r`` with ``p = pos[r]`` takes dictionary
    entry ``idx[p]`` while ``p < n_dict``, else plain entry ``p - n_dict``;
    a null row, and an index past the entries (a padding row of the JAX
    package's pow2-padded matrices), give length 0. Returns uint8 ``(cap,
    width)`` (each value left-aligned, zero-filled to ``width``) and int32
    lengths ``(cap,)``, bit-equal to the JAX package's planes."""
    dev = validity.device
    _check("validity", validity, torch.bool, 1, dev)
    _check("pos", pos, torch.int32, 1, dev)
    _check("idx", idx, torch.int32, 1, dev)
    _check("starts", starts, torch.int64, 1, dev)
    _check("lens", lens, torch.int32, 1, dev)
    _check("blob", blob, torch.uint8, 1, dev)
    if pos.shape != validity.shape or lens.shape != starts.shape \
            or not 0 <= dict_entries <= starts.numel() or width < 1 \
            or (n_dict and not idx.numel()):
        raise ValueError("pq_gather_byte_array: inconsistent shapes")
    if n_blob < 0 or blob.data_ptr() % 16 or blob.numel() < n_blob + 16:
        raise ValueError("pq_gather_byte_array: blob must be 16-byte "
                         "aligned and hold n_blob + 16 bytes")
    if dev.type == "cpu":
        return pq_gather_byte_array_reference(validity, pos, idx, starts,
                                              lens, blob[:n_blob], n_dict,
                                              dict_entries, width)
    if dev.type != "cuda":
        raise TypeError(f"pq_gather_byte_array: no kernel for device {dev}")
    cap = validity.numel()
    data = torch.empty((cap, width), dtype=torch.uint8, device=dev)
    lengths = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap:
        plain_entries = starts.numel() - dict_entries
        with torch.cuda.device(dev):
            _launch(pq_gather_byte_array, "srt_pq_gather_byte_array",
                    validity.data_ptr(), pos.data_ptr(), idx.data_ptr(),
                    idx.numel(), starts.data_ptr(), lens.data_ptr(),
                    blob.data_ptr(), n_blob, n_dict, dict_entries,
                    pow2_ceil(dict_entries), plain_entries,
                    pow2_ceil(plain_entries), cap, width,
                    data.data_ptr(), lengths.data_ptr())
    return data, lengths


#: kernel launches so far (a test or smoke run resets it to 0)
pq_gather_byte_array.launches = 0
