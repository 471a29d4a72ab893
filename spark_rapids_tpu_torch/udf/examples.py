"""Example accelerated UDFs — the port of ``pallas_axpy`` from
``spark_rapids_tpu/udf/examples.py``: a hand-written kernel slotted into a
query as a columnar UDF (on this engine a CUDA kernel, udf/kernels.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..columnar import dtypes as dt
from .columnar import columnar_udf
from .kernels import axpy

__all__ = ["pallas_axpy"]


def _pallas_axpy_device(a, x, y):
    return axpy(*(t.to(torch.float32).contiguous() for t in (a, x, y)))


def _pallas_axpy_host(a, x, y):
    return (np.asarray(a, dtype=np.float32) * np.asarray(x, dtype=np.float32)
            + np.asarray(y, dtype=np.float32))


@columnar_udf(dt.FLOAT, name="pallas_axpy", host_fn=_pallas_axpy_host)
def pallas_axpy(a, x, y):
    """a*x + y in float32 as a hand-written kernel wrapped in a columnar
    UDF — the pattern for plugging custom kernels into queries."""
    return _pallas_axpy_device(a, x, y)
