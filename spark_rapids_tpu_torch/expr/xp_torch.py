"""The torch array namespace that device expression evaluation runs on.

Expressions are written once against an array namespace ``xp`` (numpy on
the host engine, this namespace on the device), the design the JAX package
uses with ``jax.numpy``. Torch differs from numpy in three ways that matter
here, and this namespace hides them:

- allocation needs a device, so the namespace is bound to one;
- dtypes are torch dtypes: ``dtype=`` arguments accept numpy dtypes, numpy
  scalar types and ``bool`` as well, and map them;
- a tensor has no ``.astype``: expressions call ``xp.astype(x, dtype)``.
"""
from __future__ import annotations

import torch

from ..columnar.device import as_torch_dtype

__all__ = ["TorchNamespace"]


class TorchNamespace:
    """numpy-style functions over torch tensors on one device."""

    bool_ = torch.bool
    int8 = torch.int8
    int16 = torch.int16
    int32 = torch.int32
    int64 = torch.int64
    float32 = torch.float32
    float64 = torch.float64
    uint8 = torch.uint8

    def __init__(self, device):
        self.device = torch.device(device)

    # -- construction ---------------------------------------------------------
    def zeros(self, n, dtype=torch.float64) -> torch.Tensor:
        return torch.zeros(n, dtype=as_torch_dtype(dtype), device=self.device)

    def ones(self, n, dtype=torch.float64) -> torch.Tensor:
        return torch.ones(n, dtype=as_torch_dtype(dtype), device=self.device)

    def full(self, shape, value, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=as_torch_dtype(dtype),
                          device=self.device)

    @staticmethod
    def zeros_like(x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    @staticmethod
    def ones_like(x: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(x)

    @staticmethod
    def full_like(x: torch.Tensor, value) -> torch.Tensor:
        return torch.full_like(x, value)

    def asarray(self, a) -> torch.Tensor:
        """A numpy array (or tensor) as a tensor on this device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(a, device=self.device)

    # -- elementwise ----------------------------------------------------------
    @staticmethod
    def astype(x: torch.Tensor, dtype) -> torch.Tensor:
        return x.to(as_torch_dtype(dtype))

    @staticmethod
    def where(cond, a, b) -> torch.Tensor:
        return torch.where(cond, a, b)

    @staticmethod
    def logical_and(a, b) -> torch.Tensor:
        return torch.logical_and(a, b)

    @staticmethod
    def logical_or(a, b) -> torch.Tensor:
        return torch.logical_or(a, b)

    @staticmethod
    def logical_not(a) -> torch.Tensor:
        return torch.logical_not(a)

    @staticmethod
    def isnan(a) -> torch.Tensor:
        return torch.isnan(a)

    @staticmethod
    def abs(a) -> torch.Tensor:
        return torch.abs(a)

    @staticmethod
    def trunc(a) -> torch.Tensor:
        return torch.trunc(a)

    @staticmethod
    def minimum(a, b) -> torch.Tensor:
        return torch.minimum(a, b)

    @staticmethod
    def floor_divide(a, b) -> torch.Tensor:
        return torch.floor_divide(a, b)

    @staticmethod
    def round(a) -> torch.Tensor:
        """Round half to even, as ``numpy.round``."""
        return torch.round(a)
