"""Device meshes — the port of ``spark_rapids_tpu/parallel/mesh.py``.

The JAX package builds ``jax.sharding.Mesh`` objects; the port's mesh is an
ordered tuple of ``torch.device``s under one axis name, ``dp``: shard ``i``
of a row-sharded table lives on ``devices[i]``. A mesh of fewer than two
shards means the local tier (one device-resident partition), as the JAX
session decides (``TorchSession.shuffle_mesh``).

- ``data_parallel_mesh``: one shard on every visible card, the partitions
  as shards (Spark tasks across executors).
- ``virtual_mesh(n, device)``: ``n`` shards on ONE device, the counterpart
  of the JAX ``virtual_cpu_mesh`` (which gives the JAX tests 8 host
  devices). The CPU tests run the mesh tier on ``virtual_mesh(n, "cpu")``,
  and a machine with one card runs it on ``virtual_mesh(n, "cuda:0")``: the
  same code moves each destination's slab with ``.to(device)``, a no-op on
  a virtual mesh and a peer copy between two cards.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

__all__ = ["Mesh", "MeshTopology", "data_parallel_mesh", "virtual_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one axis (``dp``)."""
    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def virtual(self) -> bool:
        """Whether every shard lives on one device."""
        return len(set(self.devices)) == 1

    def describe(self) -> str:
        if self.virtual:
            return f"virtual {self.size} x {self.devices[0]}"
        return "[" + ", ".join(str(d) for d in self.devices) + "]"


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """The cards this process sees (one host: the port runs one
    controller process over its mesh)."""
    n_devices: int
    platform: str

    @staticmethod
    def detect() -> "MeshTopology":
        if torch.cuda.is_available():
            return MeshTopology(torch.cuda.device_count(), "gpu")
        return MeshTopology(1, "cpu")


def data_parallel_mesh(n: Optional[int] = None, axis: str = "dp") -> Mesh:
    """A mesh over the first ``n`` visible cards (every card by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("data_parallel_mesh: no CUDA device is visible; "
                           "use virtual_mesh(n, 'cpu') on the CPU")
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise ValueError(f"need {n} devices, have {count}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n or count)),
                axis)


def virtual_mesh(n: int, device: Union[str, torch.device] = "cpu",
                 axis: str = "dp") -> Mesh:
    """``n`` shards on one device."""
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    return Mesh((torch.device(device),) * n, axis)
