"""The Parquet scan on the device — the port of ``TpuParquetScanExec``
from ``spark_rapids_tpu/exec/scan.py`` (reference: GpuFileSourceScanExec +
GpuParquetScanBase: the scan is a device operator whose output is already
columnar device memory).

Each row group decodes through io/parquet_device.py (host byte plumbing,
then the device kernels of io/parquet_kernels.py); a column outside the
device decoder's subset decodes on the host and uploads, so the scan yields
one DeviceTable per row group either way. Files are read a few ahead of
the decode on a thread pool (io/prefetch.py).
"""
from __future__ import annotations

import io as _io
from typing import Iterator, List, Optional

import torch

from ..columnar.device import DeviceTable
from ..conf import MULTITHREAD_READ_NUM_THREADS
from ..io.parquet_device import DEVICE_DECODED_COLUMNS, decode_row_group
from ..io.prefetch import prefetched
from .base import TpuExec

__all__ = ["TpuParquetScanExec"]


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class TpuParquetScanExec(TpuExec):
    def __init__(self, source, columns: Optional[List[str]], schema,
                 min_bucket: int, device: torch.device):
        super().__init__()
        self.source = source
        self.columns = list(columns) if columns else None
        self.children = ()
        self.schema = schema
        self.min_bucket = min_bucket
        self.device = device
        self.metrics[DEVICE_DECODED_COLUMNS] = 0

    @property
    def num_partitions(self) -> int:
        return self.source.partitions()

    def runs_kernel(self) -> bool:
        return True    # the page decode kernels

    def node_desc(self) -> str:
        return (f"{self.source.name()} device-decode "
                f"cols={self.columns or '*'}")

    def execute_columnar(self, pidx: int) -> Iterator[DeviceTable]:
        import pyarrow.parquet as pq
        cols = self.columns or self.schema.names
        window = max(2, self.source.conf.get(MULTITHREAD_READ_NUM_THREADS))
        # bounded read-ahead: file reads overlap the decode (reference:
        # MultiFileCloudParquetPartitionReader's read pool)
        for _, raw in prefetched(self.source.partition_files(pidx),
                                 _read_bytes, window):
            pf = pq.ParquetFile(_io.BytesIO(raw))
            for rg in range(pf.metadata.num_row_groups):
                table, n_dev = decode_row_group(
                    raw, pf.metadata, rg, pf.schema_arrow, cols,
                    self.min_bucket, self.device, conf=self.source.conf)
                # the row count from the file's metadata: the metric never
                # waits on the device
                self.account_batch(pf.metadata.row_group(rg).num_rows)
                self.metrics[DEVICE_DECODED_COLUMNS] += n_dev
                yield table
