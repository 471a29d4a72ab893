"""Carry a device batch across from another engine.

There are no weights in this system: its state is the device batch. This
builds the port's ``DeviceTable`` from the planes of a batch that another
engine produced (the JAX package's ``DeviceTable``, handed over as numpy
arrays), so the same batch can run through both engines' operator chains
and the results can be compared plane by plane.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .device import DeviceColumn, DeviceTable, torch_dtype

__all__ = ["device_table_from_numpy"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # copy: arrays exported from another engine may be read-only views
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def device_table_from_numpy(names: Sequence[str],
                            columns: Sequence[Mapping],
                            row_mask, num_rows, device) -> DeviceTable:
    """Build a ``DeviceTable`` from numpy planes.

    ``columns`` holds one mapping per column with keys ``data`` and
    ``validity`` (arrays of the batch capacity; ``data`` of a string column
    is its ``(capacity, width)`` byte matrix), ``dtype`` (a port
    ``DataType`` or its simple name, e.g. ``"double"``), ``all_valid`` and,
    for a string column, ``lengths``. ``row_mask`` is the bool row mask and
    ``num_rows`` the active row count.
    """
    device = torch.device(device)
    cap = len(row_mask)
    cols = []
    for name, c in zip(names, columns):
        d = c["dtype"]
        d = dt.from_simple_name(d) if isinstance(d, str) else d
        data = _tensor(c["data"], torch_dtype(d), device)
        validity = _tensor(c["validity"], torch.bool, device)
        lengths = None
        if isinstance(d, dt.StringType):
            lengths = _tensor(c["lengths"], torch.int32, device)
            ok = data.dim() == 2 and data.shape[0] == cap \
                and lengths.shape == (cap,)
        elif dt.is_d128(d):  # limbs [hi, lo]: a 2-D plane without lengths
            ok = data.shape == (cap, 2)
        else:
            ok = data.shape == (cap,)
        if not ok or validity.shape != (cap,):
            raise ValueError(f"column {name!r}: planes {tuple(data.shape)} /"
                             f" {tuple(validity.shape)}, capacity {cap}")
        cols.append(DeviceColumn(data, validity, d, bool(c["all_valid"]),
                                 lengths))
    return DeviceTable(tuple(cols), _tensor(row_mask, torch.bool, device),
                       torch.tensor(int(num_rows), dtype=torch.int32,
                                    device=device),
                       tuple(names))
