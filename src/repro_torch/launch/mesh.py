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

A placement spec :class:`P` names, for each dimension of a global tensor,
the axes it is split over; :func:`local_block` cuts a slot's block of it
and :func:`assemble` puts the blocks back (``sharding.py`` holds the
per-architecture rules that choose the specs).

Functions, never module-level meshes: importing this module touches no
device and no process group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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

    def group(self, i: int, axes) -> list:
        """Flat indices of the slots a collective over ``axes`` joins with
        slot ``i``: those that share its coordinates on every other axis,
        in mesh order (row-major over the mesh's axes)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        keep = [a for a in self.axis_names if a not in axes]
        c = self.coords(i)
        return [j for j in range(self.size) if all(self.coords(j)[a] == c[a] for a in keep)]

    def reduce(self, full: Sequence[torch.Tensor], axes, op: str = "sum", at=None) -> list:
        """Each slot's combination over its :meth:`group` of ``full`` (every
        slot's tensor, in flat slot order): a sum added in mesh order,
        ``((t0 + t1) + t2) + …``, or an elementwise max. The slots of
        ``at`` (default: all), in that order. One group's answer is the
        same tensor for each of its slots, whichever processes hold them,
        so slots that must agree after a ``psum`` agree bit for bit."""
        if op not in ("sum", "max"):
            raise ValueError(f"reduce op {op!r}: want 'sum' or 'max'")
        done: dict = {}
        out = []
        for i in range(self.size) if at is None else at:
            g = tuple(self.group(i, axes))
            if g not in done:
                acc = full[g[0]]
                for j in g[1:]:
                    t = full[j].to(acc.device)
                    acc = acc + t if op == "sum" else torch.maximum(acc, t)
                done[g] = acc
            out.append(done[g])
        return out

    def psum(self, local: Sequence[torch.Tensor], axes) -> list:
        """``jax.lax.psum`` over ``axes`` for this process's slots: their
        group sums, added in mesh order (:meth:`reduce`)."""
        return self.reduce(self.all_gather(local), axes, "sum", self.local_indices())

    def shift(self, local: Sequence[torch.Tensor], axis: str, offset: int = 1) -> list:
        """``jax.lax.ppermute`` by ``offset`` along ``axis`` (cyclic): the
        slot at coordinate c receives the tensor of the slot at c − offset,
        its other coordinates the same. For this process's slots."""
        full = self.all_gather(local)
        n = self.shape[axis]
        out = []
        for i in self.local_indices():
            c = self.coords(i)
            c[axis] = (int(c[axis]) - offset) % n
            out.append(full[int(np.ravel_multi_index(tuple(int(c[a]) for a in self.axis_names),
                                                     self.devices.shape))])
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


def make_production_mesh(*, multi_pod: bool = False, devs=None, device=None) -> Mesh:
    """The reference's production mesh: (16, 16) over (``data``,
    ``model``), or (2, 16, 16) over (``pod``, ``data``, ``model``) when
    ``multi_pod``, from the slots of ``devs`` (default: the global pool on
    ``device``). Raises as :func:`make_mesh` does when the pool is short."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devs, device=device)


def flat_mesh(axis: str = "data", devs=None, *, device=None) -> Mesh:
    """One flat axis over ``devs`` (default: the global pool on
    ``device``), never just this process's slots: a mesh of local slots
    alone would compute a per-process answer with no exchange."""
    pool = list(devs) if devs is not None else devices(device)
    return make_mesh((len(pool),), (axis,), pool)


# ---------------------------------------------------------------------------
# Placement specs: a slot's block of a global tensor
# ---------------------------------------------------------------------------


class P(tuple):
    """A placement spec: ``P("data", None)``, ``P(("pod", "data"), "model")``.
    One entry per dimension; a plain tuple otherwise. A one-axis tuple
    entry is its axis (``("data",)`` → ``"data"``), as JAX writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_size(mesh, entry) -> int:
    """Slots a spec entry splits a dimension into (1 for None)."""
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _coords(mesh, slot: int) -> dict:
    return dict(zip(mesh.shape, np.unravel_index(int(slot), tuple(mesh.shape.values()))))


def block_range(mesh, entry, slot: int, n: int) -> tuple:
    """[start, stop) of slot ``slot``'s block of a length-``n`` dimension
    split by ``entry`` (its axes folded first-outermost, as JAX folds a
    tuple entry); ``n`` must divide."""
    parts = axis_size(mesh, entry)
    if n % parts:
        raise ValueError(f"dimension {n} does not split into {parts} blocks over {entry}")
    if entry is None:
        return 0, n
    c = _coords(mesh, slot)
    at = 0
    for a in entry if isinstance(entry, tuple) else (entry,):
        at = at * mesh.shape[a] + int(c[a])
    size = n // parts
    return at * size, (at + 1) * size


def local_block(t: torch.Tensor, spec: Sequence, mesh, slot: int) -> torch.Tensor:
    """Slot ``slot``'s block (flat slot index) of the global tensor ``t``
    under ``spec``: a view, exact. Missing trailing entries are None."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d tensor")
    for dim, entry in enumerate(spec):
        lo, hi = block_range(mesh, entry, slot, t.shape[dim])
        if hi - lo != t.shape[dim]:
            t = t.narrow(dim, lo, hi - lo)
    return t


def without(spec: Sequence, axis: Optional[str]) -> P:
    """``spec`` with ``axis`` taken out of every entry: the block an
    all-gather over ``axis`` leaves each slot (zero-3's weight gather)."""
    if axis is None:
        return P(*spec)
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = tuple(a for a in e if a != axis) or None
            e = e[0] if isinstance(e, tuple) and len(e) == 1 else e
        elif e == axis:
            e = None
        out.append(e)
    return P(*out)


def assemble(blocks: Sequence[torch.Tensor], spec: Sequence, mesh, shape) -> torch.Tensor:
    """The global tensor of ``shape`` whose :func:`local_block` under
    ``spec`` is ``blocks[i]`` for every flat slot i (the inverse of the
    cut; slots that hold one block must hold equal blocks, and the first
    of them is taken). On the first block's device."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=blocks[0].dtype, device=blocks[0].device)
    seen = set()
    for i, b in enumerate(blocks):
        ranges = tuple(block_range(mesh, spec[d] if d < len(spec) else None, i, shape[d]) for d in range(len(shape)))
        if ranges in seen:
            continue
        seen.add(ranges)
        out[tuple(slice(lo, hi) for lo, hi in ranges)] = b.to(out.device)
    return out
