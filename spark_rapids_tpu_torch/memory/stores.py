"""Tiered buffer stores: DEVICE -> HOST -> DISK — the port of
``spark_rapids_tpu/memory/stores.py`` (reference: RapidsBuffer.scala:53,
RapidsDeviceMemoryStore / RapidsHostMemoryStore / RapidsDiskStore).

A buffer is a whole ``DeviceTable``. Spilling it to the host copies each
plane into a numpy array, under the JAX package's plane keys (``row_mask``,
``num_rows``, ``col{i}.data``, ``col{i}.validity``, ``col{i}.lengths``), so
a table spilled by either package has the same planes. The disk tier writes
those arrays: in ``direct`` mode one ``.npy`` a plane, restored as a
read-only memory map that is copied once to the device, else one ``.npz``;
with ``checksum`` a crc32 sidecar is checked on restore and a mismatch
raises ``SpillCorruptionError``. The caching allocator owns the device
memory, so the device store keeps a logical budget and frees by dropping
references.

Not ported: the fault-injection hooks of the JAX stores (ROADMAP Queue 1:
memory and robustness).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..columnar.device import DeviceColumn, DeviceTable

__all__ = ["StorageTier", "StoredTable", "DeviceStore", "HostStore",
           "DiskStore", "SpillCorruptionError"]


class SpillCorruptionError(RuntimeError):
    """A disk-spilled buffer failed its crc32 check on restore: the data is
    lost, loudly, instead of served as silently wrong bytes."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"spill file {path} failed integrity check: "
                         f"{detail}")
        self.path = path


class StorageTier:
    DEVICE = 0
    HOST = 1
    DISK = 2

    NAMES = {0: "DEVICE", 1: "HOST", 2: "DISK"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A plane's host copy. A CPU tensor is copied too, so the host tier
    never shares memory with the table it spilled."""
    return t.detach().cpu().numpy().copy() if t.device.type == "cpu" \
        else t.detach().cpu().numpy()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One copy of a host plane to ``device``. A read-only memory map goes
    straight to a CUDA device (torch warns that the array is not writable;
    the tensor over it is only read, by that copy); a CPU restore copies it
    into memory the table owns."""
    if device.type == "cpu":
        return torch.from_numpy(np.array(a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(a)).to(device)


def _table_to_host_arrays(table: DeviceTable) -> Tuple[dict, dict]:
    """Flatten a DeviceTable into numpy planes + the metadata to rebuild it
    (``_table_to_host_arrays`` / ``_flatten_column``)."""
    arrays = {"row_mask": _to_numpy(table.row_mask),
              "num_rows": _to_numpy(table.num_rows)}
    meta = {"names": list(table.names), "device": table.device, "cols": []}
    for i, c in enumerate(table.columns):
        key = f"col{i}"
        arrays[f"{key}.data"] = _to_numpy(c.data)
        arrays[f"{key}.validity"] = _to_numpy(c.validity)
        if c.lengths is not None:
            arrays[f"{key}.lengths"] = _to_numpy(c.lengths)
        meta["cols"].append({"dtype": c.dtype, "all_valid": c.all_valid,
                             "lengths": c.lengths is not None})
    return arrays, meta


def _host_arrays_to_table(arrays: dict, meta: dict) -> DeviceTable:
    device = meta["device"]
    cols = []
    for i, d in enumerate(meta["cols"]):
        key = f"col{i}"
        lengths = _to_device(arrays[f"{key}.lengths"], device) \
            if d["lengths"] else None
        cols.append(DeviceColumn(_to_device(arrays[f"{key}.data"], device),
                                 _to_device(arrays[f"{key}.validity"], device),
                                 d["dtype"], d["all_valid"], lengths))
    # num_rows restores as a 0-d tensor (a memory-mapped .npy of a 0-d
    # array may load with shape (1,))
    return DeviceTable(tuple(cols), _to_device(arrays["row_mask"], device),
                       _to_device(arrays["num_rows"], device).reshape(()),
                       tuple(meta["names"]))


class StoredTable:
    """One buffer's storage state across tiers."""

    def __init__(self, buffer_id: int, table: DeviceTable, priority: int,
                 size_bytes: int):
        self.buffer_id = buffer_id
        self.priority = priority
        self.size_bytes = size_bytes
        self.tier = StorageTier.DEVICE
        self.device_table: Optional[DeviceTable] = table
        self.host_arrays: Optional[dict] = None
        self.meta: Optional[dict] = None
        self.disk_path: Optional[str] = None
        self.refcount = 0
        self.closed = False


class DeviceStore:
    """Logical device budget (reference: RapidsDeviceMemoryStore)."""

    def __init__(self, limit_bytes: int):
        self.limit_bytes = limit_bytes
        self.used_bytes = 0

    def fits(self, nbytes: int) -> bool:
        return self.used_bytes + nbytes <= self.limit_bytes


class HostStore:
    """Host staging tier with its own bound (reference:
    RapidsHostMemoryStore, spark.rapids.memory.host.spillStorageSize)."""

    def __init__(self, limit_bytes: int):
        self.limit_bytes = limit_bytes
        self.used_bytes = 0

    def fits(self, nbytes: int) -> bool:
        return self.used_bytes + nbytes <= self.limit_bytes

    def put(self, stored: StoredTable):
        arrays, meta = _table_to_host_arrays(stored.device_table)
        stored.host_arrays = arrays
        stored.meta = meta
        stored.device_table = None
        stored.tier = StorageTier.HOST
        self.used_bytes += stored.size_bytes

    def drop(self, stored: StoredTable):
        stored.host_arrays = None
        self.used_bytes -= stored.size_bytes


class DiskStore:
    """Disk tier (reference: RapidsDiskStore). ``direct`` is the
    GPUDirect-Storage analogue: each plane a raw ``.npy`` restored through
    a read-only memory map, so the upload reads the file's pages with no
    heap copy between; otherwise one compact ``.npz`` a buffer. The spill
    directory is made on the first write."""

    #: per-buffer checksum sidecar (direct mode); never a spilled array
    CHECKSUM_SIDECAR = "CHECKSUMS.json"

    def __init__(self, directory: Optional[str] = None, direct: bool = True,
                 checksum: bool = True):
        self._dir = directory
        self.direct = direct
        self.checksum = checksum
        self.used_bytes = 0

    @property
    def dir(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="srt_spill_")
        os.makedirs(self._dir, exist_ok=True)
        return self._dir

    @staticmethod
    def _crc32_file(path: str) -> int:
        crc = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    return crc
                crc = zlib.crc32(chunk, crc)

    def put(self, stored: StoredTable):
        assert stored.host_arrays is not None
        if self.direct:
            d = os.path.join(self.dir, f"buf{stored.buffer_id}")
            os.makedirs(d, exist_ok=True)
            size = 0
            crcs: Dict[str, int] = {}
            for k, arr in stored.host_arrays.items():
                fp = os.path.join(d, f"{k}.npy")
                np.save(fp, np.ascontiguousarray(arr))
                size += os.path.getsize(fp)
                if self.checksum:
                    crcs[f"{k}.npy"] = self._crc32_file(fp)
            if self.checksum:
                sidecar = os.path.join(d, self.CHECKSUM_SIDECAR)
                with open(sidecar, "w", encoding="utf-8") as f:
                    json.dump(crcs, f)
                size += os.path.getsize(sidecar)
            stored.disk_path = d
        else:
            path = os.path.join(self.dir, f"buf{stored.buffer_id}.npz")
            np.savez(path, **stored.host_arrays)
            stored.disk_path = path
            size = os.path.getsize(path)
            if self.checksum:
                with open(path + ".crc", "w", encoding="utf-8") as f:
                    f.write(str(self._crc32_file(path)))
                size += os.path.getsize(path + ".crc")
        stored.host_arrays = None
        stored.tier = StorageTier.DISK
        self.used_bytes += size

    def _verify(self, path: str, expected: int) -> None:
        actual = self._crc32_file(path)
        if actual != expected:
            raise SpillCorruptionError(
                path, f"crc32 {actual:#010x} != recorded {expected:#010x}")

    def load(self, stored: StoredTable) -> dict:
        if os.path.isdir(stored.disk_path):
            crcs: Optional[Dict[str, int]] = None
            sidecar = os.path.join(stored.disk_path, self.CHECKSUM_SIDECAR)
            if self.checksum and os.path.exists(sidecar):
                with open(sidecar, "r", encoding="utf-8") as f:
                    crcs = json.load(f)
            out = {}
            for fn in os.listdir(stored.disk_path):
                if not fn.endswith(".npy"):
                    continue  # the checksum sidecar is not an array
                fp = os.path.join(stored.disk_path, fn)
                if crcs is not None:
                    if fn not in crcs:
                        raise SpillCorruptionError(
                            fp, "no recorded checksum for spilled array")
                    self._verify(fp, int(crcs[fn]))
                out[fn[:-4]] = np.load(fp, mmap_mode="r", allow_pickle=False)
            return out
        crc_path = stored.disk_path + ".crc"
        if self.checksum and os.path.exists(crc_path):
            with open(crc_path, "r", encoding="utf-8") as f:
                self._verify(stored.disk_path, int(f.read().strip()))
        with np.load(stored.disk_path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def _size_of(self, path: str) -> int:
        if os.path.isdir(path):
            return sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
        size = os.path.getsize(path)
        if os.path.exists(path + ".crc"):
            size += os.path.getsize(path + ".crc")
        return size

    def drop(self, stored: StoredTable):
        if stored.disk_path and os.path.exists(stored.disk_path):
            self.used_bytes -= self._size_of(stored.disk_path)
            if os.path.isdir(stored.disk_path):
                shutil.rmtree(stored.disk_path, ignore_errors=True)
            else:
                os.unlink(stored.disk_path)
                if os.path.exists(stored.disk_path + ".crc"):
                    os.unlink(stored.disk_path + ".crc")
        stored.disk_path = None
