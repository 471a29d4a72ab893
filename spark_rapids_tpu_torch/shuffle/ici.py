"""The device exchange across a mesh — the port of
``spark_rapids_tpu/shuffle/ici.py`` (``ici_all_to_all_exchange``,
``shard_table``, ``unshard_table``).

The JAX package re-homes rows with one ``jax.lax.all_to_all`` inside a
``shard_map`` program. The port keeps that form in one controller process:
a row-sharded table is a ``ShardedTable``, one ``DeviceTable`` a shard on
its mesh device, and ``mesh_exchange``

1. runs the ``partition_ids`` and ``counting_order`` kernels on each source
   shard (masked rows parked past the last partition), or takes the plans
   a count pass already made (exec/exchange.py does),
2. scatters each source's rows, in their stable order, into ``n``
   destination slabs of ``quota`` slots (the all-to-all's equal quotas;
   slots past a pair's row count stay masked and zero), with no host read,
3. moves slab ``(source, destination)`` to the destination's device: a peer
   copy between two cards, nothing on a virtual mesh, and concatenates the
   slabs of each destination in source order.

So output shard ``d`` is the JAX package's masked slot layout
(``ici.py:124-146``): ``n * quota`` slots, the sources in shard order, each
source's rows in their order on that source. Floats are hashed normalised
(shuffle/manager.py): -0.0 and 0.0, and every NaN, meet on one shard.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.device import DeviceColumn, DeviceTable
from ..parallel.mesh import Mesh
from .manager import partition_ids, partition_order

__all__ = ["ShardedTable", "ExchangePlan", "shard_table", "unshard_table",
           "exchange_plan", "mesh_exchange"]


@dataclasses.dataclass
class ShardedTable:
    """A table row-sharded over a mesh: ``shards[i]`` lives on
    ``mesh.devices[i]``; every shard has the same capacity."""
    shards: Tuple[DeviceTable, ...]
    mesh: Mesh

    @property
    def names(self) -> Tuple[str, ...]:
        return self.shards[0].names

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.shards)


@dataclasses.dataclass
class ExchangePlan:
    """One source shard's partition ids (masked rows parked at ``n``), their
    stable order and the count of each id (``n + 1`` of them)."""
    pid: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor


def _rows(col: DeviceColumn, lo: int, hi: int,
          device: torch.device) -> DeviceColumn:
    return DeviceColumn(col.data[lo:hi].to(device), col.validity[lo:hi]
                        .to(device), col.dtype, col.all_valid,
                        None if col.lengths is None
                        else col.lengths[lo:hi].to(device))


def shard_table(table: DeviceTable, mesh: Mesh) -> ShardedTable:
    """Cut a table into ``mesh.size`` equal row ranges, one a device."""
    n = mesh.size
    if table.capacity % n:
        raise ValueError(f"capacity {table.capacity} not divisible by mesh "
                         f"axis {n}")
    per = table.capacity // n
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * per, (i + 1) * per
        mask = table.row_mask[lo:hi].to(dev)
        shards.append(DeviceTable(
            tuple(_rows(c, lo, hi, dev) for c in table.columns), mask,
            mask.sum(dtype=torch.int32), table.names))
    return ShardedTable(tuple(shards), mesh)


def unshard_table(sharded: ShardedTable) -> DeviceTable:
    """The shards concatenated in mesh order on the first device, slots and
    masks as they are (the JAX ``unshard_table``)."""
    dev = sharded.mesh.devices[0]
    shards = sharded.shards
    cols = []
    for ci, c0 in enumerate(shards[0].columns):
        parts = [s.columns[ci] for s in shards]
        cols.append(DeviceColumn(
            torch.cat([p.data.to(dev) for p in parts]),
            torch.cat([p.validity.to(dev) for p in parts]), c0.dtype,
            all(p.all_valid for p in parts),
            None if c0.lengths is None
            else torch.cat([p.lengths.to(dev) for p in parts])))
    mask = torch.cat([s.row_mask.to(dev) for s in shards])
    return DeviceTable(tuple(cols), mask, mask.sum(dtype=torch.int32),
                       sharded.names)


def exchange_plan(shard: DeviceTable, key_names: Sequence[str],
                  n: int) -> ExchangePlan:
    """Partition ids and their counting order on one source shard."""
    pid = partition_ids(shard, key_names, n, normalize_floats=True,
                        row_mask=shard.row_mask)
    order, counts = partition_order(pid, n)
    return ExchangePlan(pid, order, counts)


def _scatter_slabs(shard: DeviceTable, plan: ExchangePlan, n: int,
                   q: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One source's rows scattered into ``n * q`` destination slots ->
    (every column plane, in ``DeviceTable`` plane order, as ``(n, q, ...)``;
    the slot mask ``(n, q)``). A row past its pair's quota, and every parked
    row, lands in one extra trash slot that is cut off."""
    dev = shard.device
    cap = shard.capacity
    order = plan.order.long()
    sorted_pid = plan.pid.index_select(0, order).long()
    counts = plan.counts.long()
    start = torch.cumsum(counts, 0) - counts
    dst = sorted_pid.clamp(max=n - 1)
    k = torch.arange(cap, dtype=torch.int64, device=dev) - start[dst]
    ok = (sorted_pid < n) & (k < q)
    slot = torch.where(ok, dst * q + k, n * q)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        xs = x.index_select(0, order)
        fill = torch.where(ok.reshape((-1,) + (1,) * (xs.dim() - 1)), xs,
                           torch.zeros_like(xs))
        out = torch.zeros((n * q + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out.index_copy_(0, slot, fill)
        return out[:n * q].reshape((n, q) + tuple(x.shape[1:]))

    planes = []
    for c in shard.columns:
        planes.append(scatter(c.data))
        planes.append(scatter(c.validity))
        if c.lengths is not None:
            planes.append(scatter(c.lengths))
    mask = torch.zeros(n * q + 1, dtype=torch.bool, device=dev)
    mask.index_copy_(0, slot, ok)
    return planes, mask[:n * q].reshape(n, q)


def mesh_exchange(sharded: ShardedTable, key_names: Sequence[str],
                  quota: Optional[int] = None,
                  plans: Optional[Sequence[ExchangePlan]] = None
                  ) -> ShardedTable:
    """Hash-exchange a row-sharded table so that rows with equal keys land on
    one shard. ``quota`` is the slot count of each (source, destination)
    pair; it must be at least the rows any source sends any destination
    (a count pass sizes it; fewer would drop rows) and defaults to the local
    capacity, always enough. Returns shards of capacity ``n * quota``."""
    mesh = sharded.mesh
    n = mesh.size
    if plans is None:
        plans = [exchange_plan(s, key_names, n) for s in sharded.shards]
    scattered = []
    for shard, plan in zip(sharded.shards, plans):
        cap = shard.capacity
        q = cap if quota is None else min(quota, cap)
        scattered.append(_scatter_slabs(shard, plan, n, q))
    template = sharded.shards[0]
    out = []
    for d, dev in enumerate(mesh.devices):
        planes = [torch.cat([p[i][d].to(dev, non_blocking=True)
                             for p, _ in scattered])
                  for i in range(len(scattered[0][0]))]
        mask = torch.cat([m[d].to(dev, non_blocking=True)
                          for _, m in scattered])
        cols = []
        it = iter(planes)
        for c in template.columns:
            data, validity = next(it), next(it)
            lengths = next(it) if c.lengths is not None else None
            cols.append(DeviceColumn(data, validity, c.dtype, c.all_valid,
                                     lengths))
        out.append(DeviceTable(tuple(cols), mask,
                               mask.sum(dtype=torch.int32), template.names))
    return ShardedTable(tuple(out), mesh)
