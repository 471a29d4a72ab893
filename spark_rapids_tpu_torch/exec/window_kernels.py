"""The window's hand-written CUDA kernels (``csrc/window.cu``), each beside
its plain PyTorch version.

- ``seg_scan``: an inclusive segmented scan (add, min or max) that restarts
  where a flag is set (the JAX package's ``_segmented_scan``), forward or
  from the last row to the first (its reverse ``associative_scan`` of
  ``jnp.minimum``, which finds segment and peer-group ends);
- ``frame_bounds``: for each row the first position of ``[lo, hi)`` whose
  key is ``>=`` its target, or ``>`` when strict (``_device_bsearch``);
- ``frame_reduce``: for each row the sum, min or max of the valid values of
  ``[lo, hi)`` and their count (``_device_range_minmax`` and the bounded
  frames' float sums); frames the caller knows to be short skip the block
  aggregates.

Float min and max follow Spark's order: NaN above +inf (so a min is NaN
only when every value is), -0.0 below 0.0; a NaN result is the canonical
NaN. Integer adds wrap. A float sum adds the frame's (or the segment's)
own values, never a difference of prefix sums, so no value outside the
frame can cancel into it.

A wrapper checks its inputs, then computes the plain version for tensors on
the CPU, or launches the kernel on the current stream for tensors on a CUDA
device (counted in ``<wrapper>.launches``, its row count added to the set
``<wrapper>.launch_rows``); a failed launch raises. There is no fallback
from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .aggregate import _float_order_key

__all__ = ["seg_scan", "seg_scan_reference", "frame_bounds",
           "frame_bounds_reference", "frame_reduce",
           "frame_reduce_reference", "order_key", "OPS"]

#: the operations, with their codes in csrc/window.cu
OPS = {"add": 0, "min": 1, "max": 2}
_SCAN_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                torch.float64: 3}
_I64_MAX = 2**63 - 1


def order_key(x: torch.Tensor) -> torch.Tensor:
    """Spark's order of floats as int64 keys: NaN above +inf, -0.0 below
    0.0 (the aggregate's order key, every NaN the greatest key)."""
    d = x.to(torch.float64).contiguous()
    k = _float_order_key(d)
    return torch.where(torch.isnan(d), torch.full_like(k, _I64_MAX), k)


def _identity(dtype: torch.dtype, op: str):
    if op == "add":
        return -0.0 if dtype.is_floating_point else 0
    if dtype.is_floating_point:
        return float("nan") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _apply(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """``op(a, b)``, ``a`` before ``b``; a tie keeps ``a``."""
    if op == "add":
        return a + b
    if a.dtype.is_floating_point:
        ka, kb = order_key(a), order_key(b)
        return torch.where(kb < ka if op == "min" else kb > ka, b, a)
    return torch.where(b < a if op == "min" else b > a, b, a)


def _canonical_nan(x: torch.Tensor, op: str) -> torch.Tensor:
    """A float min or max's NaN as the one canonical NaN (NaNs tie under
    the order key, so the bits kept would depend on the grouping)."""
    if op == "add" or not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def seg_scan_reference(values: torch.Tensor, flags, op: str,
                       reverse: bool = False) -> torch.Tensor:
    """Plain version of ``seg_scan``: the doubling scan of (flag, value)
    pairs, log2(n) steps of torch ops; in reverse, the same scan of the
    rows and flags flipped, flipped back."""
    if flags is None:
        flags = torch.zeros(values.shape[0], dtype=torch.bool,
                            device=values.device)
    if reverse:
        return seg_scan_reference(values.flip(0), flags.flip(0), op).flip(0)
    v = values.clone()
    f = flags.to(torch.bool).clone()
    n = v.shape[0]
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], _apply(v[:-d], v[d:], op))
        nf = torch.logical_or(f[d:], f[:-d])
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d <<= 1
    return _canonical_nan(v, op)


def frame_bounds_reference(key: torch.Tensor, target: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor,
                           strict: bool) -> torch.Tensor:
    """Plain version of ``frame_bounds``: the vectorized binary search of
    the JAX ``_device_bsearch``, a fixed bit-length of n steps."""
    n = key.shape[0]
    lo = lo.clamp(0, n)
    hi = hi.clamp(0, n)
    for _ in range(max(1, n.bit_length())):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = key[mid.clamp(0, max(n - 1, 0))]
        right = mv <= target if strict else mv < target
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def frame_reduce_reference(values: torch.Tensor, valid: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor, op: str,
                           max_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``frame_reduce``: each frame as the power-of-two
    blocks of its length's bits, smallest first, from a level of blocks
    built one doubling at a time (one level held at once). ``max_len``,
    the kernel's hint, does not change the result."""
    n = values.shape[0]
    ident = _identity(values.dtype, op)
    x = torch.where(valid, values, torch.full_like(values, ident))
    c = valid.to(torch.int64)
    lo = lo.clamp(0, n)
    hi = torch.maximum(hi.clamp(0, n), lo)
    length = hi - lo
    acc = torch.full_like(values, ident)
    cnt = torch.zeros_like(c)
    cur = lo
    k = 0
    while n and (1 << k) <= n:
        take = ((length >> k) & 1).to(torch.bool)
        idx = cur.clamp(max=n - 1)
        acc = torch.where(take, _apply(acc, x[idx], op), acc)
        cnt = cnt + torch.where(take, c[idx], torch.zeros_like(cnt))
        cur = cur + (take.to(torch.int64) << k)
        s = 1 << k
        if s < n:
            x = torch.cat([_apply(x[:n - s], x[s:], op), x[n - s:]])
            c = torch.cat([c[:n - s] + c[s:], c[n - s:]])
        k += 1
    return _canonical_nan(acc, op), cnt


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def _check_1d(fn: str, name: str, t: torch.Tensor, dtypes, n: int,
              device) -> None:
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{fn}: {name} must be a contiguous 1-D tensor of "
                        f"{sorted(str(d) for d in dtypes)}, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.shape[0] != n or t.device != device:
        raise ValueError(f"{fn}: {name} is {tuple(t.shape)} on {t.device}, "
                         f"expected ({n},) on {device}")


def _check_op(fn: str, op: str) -> int:
    if op not in OPS:
        raise ValueError(f"{fn}: op {op!r} is not one of {sorted(OPS)}")
    return OPS[op]


def _launch(fn, kernel: str, device: torch.device, n: int, *args) -> None:
    if device.type != "cuda":
        raise TypeError(f"{fn.__name__}: no kernel for device {device}")
    from ..native import load_kernels
    lib = load_kernels()
    with torch.cuda.device(device):
        rc = getattr(lib, kernel)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")
    fn.launches += 1
    fn.launch_rows.add(n)


def _scratch(kernel: str, device: torch.device, *args) -> torch.Tensor:
    from ..native import load_kernels
    nbytes = getattr(load_kernels(), kernel)(*args)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def seg_scan(values: torch.Tensor, flags, op: str,
             reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``values`` (int32, int64, float32 or float64) under
    ``op`` (``"add"``, ``"min"`` or ``"max"``), restarting at each row whose
    ``flags`` (bool or uint8; ``None``: one segment, no flags read) is set;
    with ``reverse`` from the last row to the first, so a flag restarts the
    scan at its row going backwards. Kernel: ``csrc/window.cu``
    ``seg_scan`` (a memset of its look-back slots, then one launch)."""
    dev = values.device
    n = values.shape[0] if values.dim() == 1 else -1
    _check_1d("seg_scan", "values", values, _SCAN_DTYPES, n, dev)
    if flags is not None:
        _check_1d("seg_scan", "flags", flags, (torch.bool, torch.uint8), n,
                  dev)
    code = _check_op("seg_scan", op)
    if dev.type == "cpu":
        return seg_scan_reference(values, flags, op, reverse)
    out = torch.empty_like(values)
    if n:
        scratch = _scratch("srt_seg_scan_scratch_bytes", dev, n)
        _launch(seg_scan, "srt_seg_scan", dev, n, values.data_ptr(),
                None if flags is None else flags.data_ptr(), n,
                _SCAN_DTYPES[values.dtype], code, int(bool(reverse)),
                scratch.data_ptr(), out.data_ptr())
    return out


def frame_bounds(key: torch.Tensor, target: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, strict: bool) -> torch.Tensor:
    """For each row ``i``, the first position ``p`` of ``[lo[i], hi[i])``
    with ``key[p] >= target[i]`` (``>`` when ``strict``), else ``hi[i]``;
    ``key`` ascends within each such range. ``key`` and ``target`` are
    int64 or float64 (no NaN), ``lo`` and ``hi`` int64. Kernel:
    ``csrc/window.cu`` ``frame_bounds``."""
    dev = key.device
    n = key.shape[0] if key.dim() == 1 else -1
    _check_1d("frame_bounds", "key", key, (torch.int64, torch.float64), n,
              dev)
    _check_1d("frame_bounds", "target", target, (key.dtype,), n, dev)
    for name, t in (("lo", lo), ("hi", hi)):
        _check_1d("frame_bounds", name, t, (torch.int64,), n, dev)
    if dev.type == "cpu":
        return frame_bounds_reference(key, target, lo, hi, strict)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _launch(frame_bounds, "srt_frame_bounds", dev, n, key.data_ptr(),
                target.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                out.data_ptr(), n, int(key.is_floating_point()),
                int(bool(strict)))
    return out


def frame_reduce(values: torch.Tensor, valid: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, op: str,
                 max_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row ``i``, ``op`` (``"add"``, ``"min"`` or ``"max"``) over
    the rows ``j`` of ``[lo[i], hi[i])`` with ``valid[j]``, and their count
    -> (values' dtype, int64). ``values`` are int64 or float64; an empty
    frame gives the op's identity and 0. ``max_len``: the longest frame,
    where the caller knows it without reading the device. Kernel:
    ``csrc/window.cu`` ``frame_reduce``: one launch when ``max_len`` is at
    most 64 (every frame row by row; a longer one is still reduced right,
    only slower); else a memset, the block aggregates' launch and the
    frames'."""
    dev = values.device
    n = values.shape[0] if values.dim() == 1 else -1
    _check_1d("frame_reduce", "values", values, (torch.int64, torch.float64),
              n, dev)
    _check_1d("frame_reduce", "valid", valid, (torch.bool,), n, dev)
    for name, t in (("lo", lo), ("hi", hi)):
        _check_1d("frame_reduce", name, t, (torch.int64,), n, dev)
    code = _check_op("frame_reduce", op)
    if dev.type == "cpu":
        return frame_reduce_reference(values, valid, lo, hi, op)
    out = torch.empty_like(values)
    count = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        limit = -1 if max_len is None else max(0, int(max_len))
        scratch = _scratch("srt_frame_reduce_scratch_bytes", dev, n, limit)
        _launch(frame_reduce, "srt_frame_reduce", dev, n, values.data_ptr(),
                valid.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
                int(values.is_floating_point()), code, limit,
                scratch.data_ptr(), out.data_ptr(), count.data_ptr())
    return out, count


for _fn in (seg_scan, frame_bounds, frame_reduce):
    _fn.launches = 0
    _fn.launch_rows = set()
