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

__all__ = ["axpy", "axpy_reference"]


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
