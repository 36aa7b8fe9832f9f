"""Meshes of shard slots, the port's counterpart of a JAX device mesh.

The reference shards a NOMAD fit over a ``jax.sharding.Mesh`` of devices
that one controller drives, its CPU tests simulating several devices in
one process (``--xla_force_host_platform_device_count``). Here a
:class:`Mesh` is a named grid of **shard slots**. A slot is (process rank,
``torch.device``): the work of one shard, run by the process that owns it
on that device. One process may own several slots on one device, which is
how one card (or the CPU) stands in for several: the slots of a process
run one after another, and the only data that crosses slots goes through
:meth:`Mesh.all_gather`.

The **global pool** (:func:`devices`) is every rank's slots in rank order,
``local_slot_count()`` a rank (default 1, the launcher's
``--host-devices``). Under ``torch.distributed`` (NCCL on the card, gloo on
the CPU) the ranks' devices are exchanged once when the pool is built, and
:meth:`Mesh.all_gather` crosses processes with ``all_gather``; in one
process it is a reordering. Either way every slot receives every slot's
tensor, in the mesh's slot order, so what a slot computes depends on its
place in the mesh and never on which process runs it.

Functions, never module-level meshes: importing this module touches no
device and no process group.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.runtime import process_count, process_group, process_index, resolve_device

_LOCAL_SLOTS = 1  # slots a process owns in the global pool


@dataclasses.dataclass(frozen=True)
class Slot:
    """One shard's place: the rank that runs it and the device it runs on."""

    rank: int
    device: torch.device


def set_local_slots(n: int) -> None:
    """Slots each process owns in the global pool (the launcher's
    ``--host-devices``; every rank must set the same count)."""
    global _LOCAL_SLOTS
    if n < 1:
        raise ValueError(f"local slots must be >= 1, got {n}")
    _LOCAL_SLOTS = int(n)


def local_slot_count() -> int:
    return _LOCAL_SLOTS


def devices(device=None) -> list:
    """The global pool: ``local_slot_count()`` slots of every rank, rank
    major. This rank's slots sit on ``device`` (default: the first CUDA
    device); the other ranks' devices are exchanged over the process group
    (a collective: every rank calls it together)."""
    device = resolve_device(device)
    dist = process_group()
    if dist is None:
        return [Slot(0, device) for _ in range(_LOCAL_SLOTS)]
    mine = (str(device), _LOCAL_SLOTS)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    counts = {n for _d, n in everyone}
    if len(counts) != 1:
        raise ValueError(f"ranks own different slot counts {[n for _d, n in everyone]}")
    return [Slot(r, torch.device(d)) for r, (d, n) in enumerate(everyone) for _ in range(n)]


def device_count() -> int:
    """Size of the global pool, without building it (no collective)."""
    return process_count() * _LOCAL_SLOTS


def _as_slot(d) -> Slot:
    if isinstance(d, Slot):
        return d
    return Slot(process_index(), torch.device(d))


class Mesh:
    """A named grid of shard slots: ``devices`` an object array of
    :class:`Slot` of shape ``tuple(shape.values())``, ``axis_names`` its
    axes (JAX's ``Mesh`` attributes)."""

    def __init__(self, slots, axis_names: Sequence[str]):
        grid = np.empty(np.shape(np.asarray(slots, dtype=object)), dtype=object)
        flat = [_as_slot(s) for s in np.asarray(slots, dtype=object).reshape(-1)]
        grid.reshape(-1)[:] = flat
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d slot grid with axes {axis_names}")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        """Every slot, row-major over the axes."""
        return list(self.devices.reshape(-1))

    def coords(self, i: int) -> dict:
        """The axis coordinates of flat slot ``i``."""
        return dict(zip(self.axis_names, np.unravel_index(i, self.devices.shape)))

    def local_indices(self) -> list:
        """Flat indices of the slots this process runs."""
        me = process_index()
        return [i for i, s in enumerate(self.slots) if s.rank == me]

    def check_processes(self) -> None:
        """Every rank of the run owns the same number (≥ 1) of this mesh's
        slots: the all-gather moves equal blocks, and a rank with no slot
        would compute an answer of its own."""
        per = [sum(s.rank == r for s in self.slots) for r in range(process_count())]
        if min(per) < 1 or len(set(per)) != 1:
            raise ValueError(
                f"mesh {self.shape} gives the {process_count()} processes {per} slots: every "
                "process must own the same number (≥ 1) of the mesh's slots"
            )

    def all_gather(self, local: Sequence[torch.Tensor]) -> list:
        """Every slot's tensor, in flat slot order, given this process's
        (one per :meth:`local_indices` entry, equal shapes and dtypes).
        Across processes one ``all_gather`` on the device of this process's
        first slot; the results stay on that device. Exact: a copy, no
        arithmetic."""
        ids = self.local_indices()
        if len(local) != len(ids):
            raise ValueError(f"{len(local)} tensors for {len(ids)} local slots")
        out = [None] * self.size
        dist = process_group()
        if dist is None:
            for i, t in zip(ids, local):
                out[i] = t
            return out
        self.check_processes()
        comm = self.slots[ids[0]].device
        stacked = torch.stack([t.to(comm) for t in local])
        parts = [torch.empty_like(stacked) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, stacked)
        for r in range(dist.get_world_size()):
            for j, i in enumerate(i for i, s in enumerate(self.slots) if s.rank == r):
                out[i] = parts[r][j]
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.slots})"


def make_mesh(shape, axes, devs=None, *, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` from the first ``prod(shape)``
    slots of ``devs`` (slots, or devices of this process), default the
    global pool on ``device``."""
    shape = tuple(int(s) for s in shape)
    pool = list(devs) if devs is not None else devices(device)
    n = int(np.prod(shape))
    if n > len(pool):
        raise ValueError(f"mesh {shape} needs {n} slots, the pool has {len(pool)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [_as_slot(d) for d in pool[:n]]
    return Mesh(grid.reshape(shape), axes)


def flat_mesh(axis: str = "data", devs=None, *, device=None) -> Mesh:
    """One flat axis over ``devs`` (default: the global pool on
    ``device``), never just this process's slots: a mesh of local slots
    alone would compute a per-process answer with no exchange."""
    pool = list(devs) if devs is not None else devices(device)
    return make_mesh((len(pool),), (axis,), pool)
