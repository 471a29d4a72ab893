"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper checks its inputs, then:
- for tensors on the CPU, computes the plain version;
- for tensors on a CUDA device, launches the kernel on the current stream
  (building the library at first use) and counts the launch in
  ``<wrapper>.launches``; a failed launch raises. There is no fallback from
  the kernel to the plain version.
"""
from __future__ import annotations

import torch

__all__ = ["axpy", "axpy_reference", "nfa_match", "nfa_match_reference"]


def axpy_reference(a: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Plain version of ``axpy``: two float32 ops, each rounded."""
    return a * x + y


def axpy(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a * x + y`` over 1-D float32 tensors
    (kernel: csrc/axpy.cu, replacing the Pallas ``_axpy_kernel``)."""
    for name, t in (("a", a), ("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError(f"axpy: {name} must be a contiguous 1-D float32 "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != a.device or t.shape != a.shape:
            raise ValueError(f"axpy: {name} is {tuple(t.shape)} on "
                             f"{t.device}, a is {tuple(a.shape)} on "
                             f"{a.device}")
    if a.device.type == "cpu":
        return axpy_reference(a, x, y)
    if a.device.type != "cuda":
        raise TypeError(f"axpy: no kernel for device {a.device}")
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    from ..native import load_kernels
    lib = load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.srt_axpy_f32(a.data_ptr(), x.data_ptr(), y.data_ptr(),
                              out.data_ptr(), n,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"axpy kernel launch failed: CUDA error {rc}")
    axpy.launches += 1
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
axpy.launches = 0


def nfa_match_reference(values: torch.Tensor, lengths: torch.Tensor,
                        class_of_byte: torch.Tensor, masks: torch.Tensor,
                        start_bits: int, accept_bits: int,
                        anchored_start: bool, anchored_end: bool,
                        nullable: bool) -> torch.Tensor:
    """Plain version of ``nfa_match``: the column loop of the JAX
    ``DeviceNfa.matches`` scan, every row in step. State sets are int64
    (torch has no shifts on uint32)."""
    n, w = values.shape
    dev = values.device
    n_states = masks.shape[1]
    cls = class_of_byte.long()[values.long()]                     # (n, w)
    m_all = masks.long()
    bit = torch.ones(n_states, dtype=torch.int64, device=dev) \
        << torch.arange(n_states, dtype=torch.int64, device=dev)
    pos = torch.arange(w, dtype=torch.int32, device=dev)
    lead_in = ((values & 0xC0) != 0x80) & (pos[None, :] < lengths[:, None])
    # the lead byte of each row's final character (for $ anchoring)
    any_lead = lead_in.any(dim=1)
    last_lead = w - 1 - torch.argmax(lead_in.flip(1).to(torch.int8), dim=1)
    is_last = lead_in & (pos[None, :] == last_lead[:, None]) \
        & any_lead[:, None]
    matched = torch.where(lengths == 0,
                          torch.full((n,), nullable, device=dev),
                          torch.full((n,), nullable and not anchored_end,
                                     device=dev))
    active = torch.full((n,), start_bits, dtype=torch.int64, device=dev)
    accept = accept_bits
    for j in range(w):
        m = m_all[cls[:, j]]                                       # (n, S)
        hits = (active[:, None] & m) != 0
        nxt = (hits.long() * bit[None, :]).sum(dim=1)
        if not anchored_start:
            nxt = nxt | start_bits
        inside = lead_in[:, j]
        active = torch.where(inside, nxt, active)
        done = (active & accept) != 0
        gate = is_last[:, j] if anchored_end else inside
        matched = torch.where(gate, matched | done, matched)
    return matched


def nfa_match(values: torch.Tensor, lengths: torch.Tensor,
              class_of_byte: torch.Tensor, masks: torch.Tensor,
              start_bits: int, accept_bits: int, anchored_start: bool,
              anchored_end: bool, nullable: bool) -> torch.Tensor:
    """Per row of the padded string matrix ``values`` (uint8 ``(n, w)``,
    byte ``lengths`` int32 ``(n,)``): does the byte-class NFA accept, with
    find() semantics (kernel: csrc/nfa_match.cu, replacing the XLA scan of
    ``spark_rapids_tpu/expr/regex.py`` ``DeviceNfa.matches``).
    ``class_of_byte`` is int32 ``(256,)``; ``masks`` int64 ``(classes,
    states)`` holding uint32 bit sets, at most 32 states. Returns bool
    ``(n,)``."""
    if values.dtype != torch.uint8 or values.dim() != 2 \
            or not values.is_contiguous():
        raise TypeError(f"nfa_match: values must be a contiguous 2-D uint8 "
                        f"tensor, got {values.dtype} {tuple(values.shape)}")
    n, w = values.shape
    checks = (("lengths", lengths, torch.int32, (n,)),
              ("class_of_byte", class_of_byte, torch.int32, (256,)),
              ("masks", masks, torch.int64, None))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or (shape is not None
                                and tuple(t.shape) != shape):
            raise TypeError(f"nfa_match: {name} must be {dtype} of shape "
                            f"{shape or '(classes, states)'}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != values.device:
            raise ValueError(f"nfa_match: {name} is on {t.device}, values "
                             f"on {values.device}")
    if masks.dim() != 2 or not 1 <= masks.shape[1] <= 32 \
            or not 1 <= masks.shape[0] <= 256:
        raise ValueError(f"nfa_match: masks must be (1..256 classes, "
                         f"1..32 states), got {tuple(masks.shape)}")
    if values.device.type == "cpu":
        return nfa_match_reference(values, lengths, class_of_byte, masks,
                                   start_bits, accept_bits, anchored_start,
                                   anchored_end, nullable)
    if values.device.type != "cuda":
        raise TypeError(f"nfa_match: no kernel for device {values.device}")
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if n == 0:
        return out
    # the uint32 bit sets as int32 words of the same bits
    masks32 = torch.where(masks >= 2 ** 31, masks - 2 ** 32, masks) \
        .to(torch.int32).contiguous()
    lengths = lengths.contiguous()
    class_of_byte = class_of_byte.contiguous()
    flags = (int(anchored_start) | int(anchored_end) << 1
             | int(nullable) << 2)
    from ..native import load_kernels
    lib = load_kernels()
    with torch.cuda.device(values.device):
        rc = lib.srt_nfa_match(
            values.data_ptr(), lengths.data_ptr(), n, w,
            class_of_byte.data_ptr(), masks32.data_ptr(), masks.shape[0],
            masks.shape[1], start_bits, accept_bits, flags, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nfa_match kernel launch failed: CUDA error {rc}")
    nfa_match.launches += 1
    return out


#: kernel launches so far (a test or smoke run resets it to 0)
nfa_match.launches = 0
