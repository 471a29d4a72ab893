"""Parquet scan source — the port of ``spark_rapids_tpu/io/parquet.py``
(reference: GpuParquetScanBase.scala:83 + GpuMultiFileReader).

The reference offers three reader strategies (RapidsConf.scala:721), and so
does the host reader here (pyarrow decode, then upload):
- PERFILE: one read per file;
- COALESCING: small files stitched into batches of the target size
  (MultiFileParquetPartitionReader, GpuParquetScanBase.scala:995);
- MULTITHREADED: files read on a thread pool while earlier ones are
  consumed (MultiFileCloudParquetPartitionReader, :1194; pool :934).

A pushed filter (``push_filter``, io/pushdown.py) prunes row groups by
their statistics in the host reader. A scan without one can decode on the
device instead (exec/scan.py ``TpuParquetScanExec``), which reads this
source's files by partition. Each partition holds whole files; every field
is nullable.
"""
from __future__ import annotations

import concurrent.futures as cf
import glob as _glob
import math
import os
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from ..columnar.host import HostTable
from ..conf import (MULTITHREAD_READ_NUM_THREADS, PARQUET_READER_TYPE,
                    READER_BATCH_SIZE_ROWS, RapidsConf)
from ..plan.logical import DataSource
from ..plan.schema import Field, Schema

__all__ = ["ParquetSource"]


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, "**", "*.parquet"),
                                         recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no parquet files for {paths}")
    return out


class ParquetSource(DataSource):
    def __init__(self, paths, conf: Optional[RapidsConf] = None,
                 num_partitions: Optional[int] = None):
        self.files = _expand_paths(paths)
        self.conf = conf or RapidsConf()
        self.reader_type = str(self.conf.get(PARQUET_READER_TYPE)).upper()
        self.batch_rows = self.conf.get(READER_BATCH_SIZE_ROWS)
        self.filter_expr = None  # a pyarrow dataset filter (pushdown)
        first = pq.read_schema(self.files[0])
        ht = HostTable.from_arrow(first.empty_table())
        self._schema = Schema([Field(n, c.dtype, True)
                               for n, c in zip(ht.names, ht.columns)])
        nparts = num_partitions or min(len(self.files), 8)
        per = math.ceil(len(self.files) / nparts)
        self._file_parts = [self.files[i * per:(i + 1) * per]
                            for i in range(nparts)
                            if self.files[i * per:(i + 1) * per]]

    def schema(self) -> Schema:
        return self._schema

    def push_filter(self, arrow_expr) -> None:
        """Planner pushdown hook (io/pushdown.py): AND into any existing
        filter; row groups whose statistics exclude the predicate are
        skipped (reference: GpuParquetScanBase filter pushdown)."""
        self.filter_expr = arrow_expr if self.filter_expr is None \
            else (self.filter_expr & arrow_expr)

    def partitions(self) -> int:
        return len(self._file_parts)

    def partition_files(self, pidx: int) -> List[str]:
        return list(self._file_parts[pidx])

    def read_partition(self, pidx: int, columns: Optional[List[str]] = None
                       ) -> Iterator[HostTable]:
        files = self._file_parts[pidx]
        if self.reader_type == "MULTITHREADED":
            yield from self._read_multithreaded(files, columns)
        elif self.reader_type == "PERFILE":
            for f in files:
                yield from self._slice_out(self._read_file(f, columns),
                                           allow_empty=True)
        else:  # COALESCING (also AUTO)
            yield from self._read_coalescing(files, columns)

    # -- strategies ----------------------------------------------------------
    def _read_file(self, path: str, columns) -> pa.Table:
        if self.filter_expr is not None:
            ds = pads.dataset(path, format="parquet")
            return ds.to_table(columns=columns, filter=self.filter_expr)
        return pq.read_table(path, columns=columns, use_threads=True)

    def _read_coalescing(self, files: Sequence[str], columns
                         ) -> Iterator[HostTable]:
        pending: List[pa.Table] = []
        pending_rows = 0
        for f in files:
            t = self._read_file(f, columns)
            pending.append(t)
            pending_rows += t.num_rows
            if pending_rows >= self.batch_rows:
                yield from self._slice_out(pa.concat_tables(pending))
                pending, pending_rows = [], 0
        if pending:
            yield from self._slice_out(pa.concat_tables(pending),
                                       allow_empty=True)

    def _slice_out(self, t: pa.Table, allow_empty: bool = False
                   ) -> Iterator[HostTable]:
        if t.num_rows == 0 and allow_empty:
            yield HostTable.from_arrow(t)
            return
        pos = 0
        while pos < t.num_rows:
            yield HostTable.from_arrow(t.slice(pos, self.batch_rows))
            pos += self.batch_rows

    def _read_multithreaded(self, files: Sequence[str], columns
                            ) -> Iterator[HostTable]:
        nthreads = self.conf.get(MULTITHREAD_READ_NUM_THREADS)
        with cf.ThreadPoolExecutor(max_workers=nthreads,
                                   thread_name_prefix="srt-pq-read") as pool:
            futures = [pool.submit(self._read_file, f, columns)
                       for f in files]
            for fut in futures:  # file order kept, reads overlap
                yield from self._slice_out(fut.result(), allow_empty=True)

    def estimated_size_bytes(self) -> int:
        """The planner's broadcast estimate: the files' bytes, as the JAX
        package reads it, so both plan the same joins."""
        return sum(os.path.getsize(f) for f in self.files)

    def name(self) -> str:
        return f"Parquet[{len(self.files)} files, {self.reader_type}]"
