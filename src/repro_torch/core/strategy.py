"""Execution strategies: where and how one NOMAD epoch runs, and the fit's
event API.

* :class:`LocalStrategy` — one device, ``core/nomad.py:run_epoch`` (the
  only strategy of the non-factorising ``"infonc"`` baseline);
* :class:`PartialRefineStrategy` — the refinement epochs of ``partial_fit``;
* :class:`ShardedStrategy` — the paper's Fig. 2 multi-device mode: the
  clusters sharded over a mesh of shard slots
  (:mod:`repro_torch.launch.mesh`), the cell means all-gathered at each
  refresh (``core/distributed.py:make_sharded_epoch_fn``);
* :class:`HierarchicalStrategy` — the multi-pod extension: full means
  within a pod, one super-mean for each other pod.

:func:`resolve_strategy` picks from the global slot pool and the config:
one slot → local; several → sharded over the largest cluster-divisible
slot count (hierarchical when ``cfg.hierarchical`` and a 2-pod mesh fits).
Every strategy reads and returns θ in the same global cluster-major row
layout (:meth:`fetch`), so a checkpoint written under one resumes under
any other. Under ``torch.distributed`` the meshes span every process;
``"local"`` then raises, since each process would fit on its own.

The event API (:class:`FitCallbacks` and its events) is the JAX package's:
``fit`` and ``partial_fit`` emit ``on_epoch_start``, ``on_epoch_end`` (with
the *unpermuted* ``(N, out_dim)`` embedding), ``on_means_refresh`` and
``on_checkpoint``. Events only read θ, so a fit with callbacks is bit-equal
to one without.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.core.runtime import barrier, process_count, process_index
from repro_torch.launch.mesh import device_count, devices, flat_mesh, make_mesh

# ---------------------------------------------------------------------------
# Event API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EpochStartEvent:
    epoch: int
    n_epochs: int
    lr0: float  # lr at the first step of this epoch
    lr1: float  # lr at the last step of this epoch
    strategy: str


@dataclasses.dataclass
class EpochEndEvent:
    epoch: int
    n_epochs: int
    loss: float
    time_s: float
    strategy: str
    # (N, out_dim) in the ORIGINAL point order — never the raw cluster-major
    # capacity-padded buffer. None when no consumer asked for embeddings.
    embedding: Optional[np.ndarray] = None


@dataclasses.dataclass
class MeansRefreshEvent:
    epoch: int
    n_refreshes: int  # mean refreshes performed inside this epoch
    strategy: str


@dataclasses.dataclass
class CheckpointEvent:
    epoch: int
    step: int  # checkpoint step id (== epoch)
    directory: str
    n_shards: int


class FitCallbacks:
    """Structured fit events. Subclass and override what you need.

    ``wants_embedding`` controls whether :attr:`EpochEndEvent.embedding` is
    materialised (an O(N·d) device→host copy + unpermute per epoch); set it
    to False for cheap loss/time-only observers on big runs.
    """

    wants_embedding: bool = True

    def on_epoch_start(self, event: EpochStartEvent) -> None: ...

    def on_epoch_end(self, event: EpochEndEvent) -> None: ...

    def on_means_refresh(self, event: MeansRefreshEvent) -> None: ...

    def on_checkpoint(self, event: CheckpointEvent) -> None: ...


class CallbackList(FitCallbacks):
    """Fan one event stream out to several callback objects."""

    def __init__(self, callbacks: Sequence[FitCallbacks]):
        self.callbacks = list(callbacks)

    @property
    def wants_embedding(self) -> bool:  # type: ignore[override]
        return any(cb.wants_embedding for cb in self.callbacks)

    def on_epoch_start(self, event):
        for cb in self.callbacks:
            cb.on_epoch_start(event)

    def on_epoch_end(self, event):
        for cb in self.callbacks:
            cb.on_epoch_end(event)

    def on_means_refresh(self, event):
        for cb in self.callbacks:
            cb.on_means_refresh(event)

    def on_checkpoint(self, event):
        for cb in self.callbacks:
            cb.on_checkpoint(event)


class LegacyCallback(FitCallbacks):
    """Adapter for the old bare ``callback(epoch, embedding, loss)``; it
    hands the *unpermuted* ``(N, out_dim)`` embedding, the same array
    ``FitResult.embedding`` ends up with."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def on_epoch_end(self, event: EpochEndEvent) -> None:
        self.fn(event.epoch, event.embedding, event.loss)


def as_callbacks(
    callbacks=None, legacy_callback: Optional[Callable] = None
) -> Optional[FitCallbacks]:
    """Normalise fit()'s callback arguments into one FitCallbacks (or None)."""
    out = []
    if callbacks is not None:
        if isinstance(callbacks, FitCallbacks):
            out.append(callbacks)
        else:  # sequence of FitCallbacks
            out.extend(callbacks)
    if legacy_callback is not None:
        warnings.warn(
            "fit(callback=...) is deprecated; pass callbacks=FitCallbacks() "
            "(see repro_torch.core.strategy.FitCallbacks). The legacy callback "
            "receives the unpermuted (N, out_dim) embedding.",
            DeprecationWarning,
            stacklevel=3,
        )
        out.append(LegacyCallback(legacy_callback))
    if not out:
        return None
    return out[0] if len(out) == 1 else CallbackList(out)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Multi-process helpers
# ---------------------------------------------------------------------------


def fetch_global(parts: dict, mesh, shard_of: list) -> np.ndarray:
    """The global row array of a sharded tensor: ``parts`` maps each shard
    this process runs to its row block, ``shard_of`` each flat slot of
    ``mesh`` to its shard. A collective under ``torch.distributed`` (every
    process calls it and gets the whole array); in one process a
    concatenation in shard order."""
    local = [parts[shard_of[i]] for i in mesh.local_indices()]
    got = mesh.all_gather(local)
    by_shard = sorted(zip(shard_of, got), key=lambda p: p[0])
    return np.concatenate([t.cpu().numpy() for _s, t in by_shard])


def sync_processes(tag: str = "sync") -> None:
    """Barrier across the processes of the run; nothing in one process."""
    barrier(tag)


class ExecutionStrategy:
    """Where and how one epoch runs: ``prepare(cfg, method, index, theta0,
    device)`` places θ and the index, ``run_epoch(theta, epoch, lr0,
    lr1)`` steps θ in place and returns (θ, mean loss), ``fetch(theta)``
    gives θ's global (K·C, d) rows on the host."""

    name = "?"
    n_shards = 1
    mesh = None

    def refreshes_per_epoch(self) -> int:
        refresh = self.cfg.mean_refresh_steps or self.steps
        return max(1, -(-self.steps // refresh))

    def describe(self) -> dict:
        mesh = self.mesh
        return {
            "strategy": self.name,
            "n_shards": self.n_shards,
            "mesh_shape": tuple(mesh.shape.values()) if mesh is not None else None,
            "mesh_axes": tuple(mesh.axis_names) if mesh is not None else None,
            "process_count": process_count(),
            "process_index": process_index(),
        }


class LocalStrategy(ExecutionStrategy):
    """Single-device loop (``core/nomad.py:run_epoch``). ``prepare`` moves
    θ and the index arrays to the device; ``run_epoch`` steps θ in place,
    on the card by replaying the strategy's capture of the step
    (:class:`repro_torch.core.nomad.StepGraph`, taken anew at each
    ``prepare``)."""

    name = "local"

    def prepare(self, cfg: NomadConfig, method: str, index, theta0, device) -> torch.Tensor:
        from repro_torch.core.nomad import StepGraph

        self.cfg, self.method = cfg, method
        self.graph = StepGraph()
        self.steps = cfg.resolved_steps_per_epoch()
        counts = np.asarray(index.counts)
        self.idx = {
            "knn_idx": torch.as_tensor(np.asarray(index.knn_idx), dtype=torch.int64, device=device),
            "knn_w": torch.as_tensor(np.asarray(index.knn_w), dtype=torch.float32, device=device),
            "counts": torch.as_tensor(counts, dtype=torch.int64, device=device),
            "cum_counts": torch.as_tensor(np.cumsum(counts), dtype=torch.int64, device=device),
            "total": int(counts.sum()),
        }
        # a private copy: the epochs update it in place
        return torch.tensor(np.asarray(theta0), dtype=torch.float32, device=device)

    def run_epoch(self, theta, epoch: int, lr0: float, lr1: float):
        from repro_torch.core.nomad import run_epoch

        theta, loss = run_epoch(theta, self.idx, self.cfg, self.method, self.steps, lr0, lr1, epoch, graph=self.graph)
        return theta, float(loss)

    def fetch(self, theta: torch.Tensor) -> np.ndarray:
        return theta.cpu().numpy()


class PartialRefineStrategy(LocalStrategy):
    """Refinement epochs restricted to the cells a ``partial_fit`` touched.

    The epoch of :class:`LocalStrategy` (means refreshed over the **whole**
    grown layout, so repulsion still sees every cell), but heads are drawn
    only from ``affected_cells`` (:func:`repro_torch.core.nomad.
    sample_partial_rows`). Positives come from the patched in-cell kNN and
    negatives from the head's own cell, so no gradient reaches a row
    outside the affected cells: everything the append did not touch stays
    bit-identical. Steps per epoch scale with the affected point count,
    not N. Each step's generator is seeded from (seed + 11, n_points,
    epoch, step).
    """

    name = "partial"

    def __init__(self, affected_cells):
        self.affected_cells = np.asarray(affected_cells, np.int64)

    def prepare(self, cfg: NomadConfig, method: str, index, theta0, device) -> torch.Tensor:
        if self.affected_cells.size == 0:
            raise ValueError("PartialRefineStrategy needs >=1 affected cell")
        theta = super().prepare(cfg, method, index, theta0, device)
        counts = np.asarray(index.counts)
        aff = self.affected_cells
        n_aff = int(counts[aff].sum())
        self.steps = max(1, -(-n_aff // cfg.batch_size))
        self.n_points = int(index.n_points)
        self.idx.update(
            aff_cells=torch.as_tensor(aff, dtype=torch.int64, device=device),
            aff_cum_counts=torch.as_tensor(np.cumsum(counts[aff]), dtype=torch.int64, device=device),
            aff_total=n_aff,
        )
        return theta

    def run_epoch(self, theta, epoch: int, lr0: float, lr1: float):
        from repro_torch.core.nomad import run_epoch, sample_partial_rows

        theta, loss = run_epoch(
            theta, self.idx, self.cfg, self.method, self.steps, lr0, lr1, epoch,
            sampler=sample_partial_rows, key=(self.cfg.seed + 11, self.n_points), n_total=self.n_points,
            graph=self.graph,
        )
        return theta, float(loss)


class ShardedStrategy(ExecutionStrategy):
    """Fig. 2's cluster-sharded epochs with the flat mean exchange.

    ``mesh=None`` builds a flat mesh over the largest slot count of the
    global pool that divides ``cfg.n_clusters``. With a mesh given,
    ``shard_axes`` defaults to every axis but ``pod_axis``, and an axis
    named ``"pod"`` is the pod axis unless ``shard_axes`` claims it. θ is a
    dict of this process's shards' row blocks on their slots' devices."""

    name = "sharded"
    _hierarchical = False

    def __init__(self, mesh=None, shard_axes: Optional[Sequence[str]] = None, pod_axis: Optional[str] = None):
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes) if shard_axes is not None else None
        self.pod_axis = pod_axis
        self.n_shards = 1

    def _resolve_mesh(self, cfg: NomadConfig, device) -> None:
        if self.mesh is None:
            self.mesh = default_mesh(cfg, hierarchical=self._hierarchical, device=device)
            self.shard_axes = ("data",)
            self.pod_axis = "pod" if "pod" in self.mesh.axis_names else None
        names = self.mesh.axis_names
        if self.pod_axis is None and "pod" in names and (self.shard_axes is None or "pod" not in self.shard_axes):
            self.pod_axis = "pod"
        if self.shard_axes is None:
            self.shard_axes = tuple(a for a in names if a != self.pod_axis)
        uncovered = [a for a in names if a not in self.shard_axes and a != self.pod_axis and self.mesh.shape[a] > 1]
        if uncovered:
            raise ValueError(
                f"mesh axes {uncovered} are covered by neither shard_axes={self.shard_axes} nor "
                f"pod_axis={self.pod_axis!r}; θ would be silently replicated across them"
            )
        n_shards = int(np.prod([self.mesh.shape[a] for a in self.shard_axes]))
        if self.pod_axis:
            n_shards *= self.mesh.shape[self.pod_axis]
        if cfg.n_clusters % n_shards:
            raise ValueError(
                f"strategy={self.name!r}: n_clusters={cfg.n_clusters} is not divisible by the "
                f"{n_shards}-shard mesh {self.mesh.shape}; pick a compatible mesh or strategy='local'"
            )
        self.n_shards = n_shards

    def prepare(self, cfg: NomadConfig, method: str, index, theta0, device) -> dict:
        from repro_torch.core.distributed import make_sharded_epoch_fn, shard_ids, shard_index_arrays

        if method != "nomad":
            raise ValueError(
                f"method={method!r} only runs with strategy='local': its loss does not factorise "
                "over the cluster partition (paper Eq. 2)"
            )
        if self._hierarchical:
            cfg = cfg.replace(hierarchical=True)
        self._resolve_mesh(cfg, device)
        if self._hierarchical and self.pod_axis is None:
            raise ValueError("strategy='hierarchical' needs a mesh with a pod axis (e.g. axes ('pod', 'data'))")
        self.cfg = cfg
        # shards run side by side, each 1/n_shards of the local step count:
        # an epoch still samples ≈ N heads
        self.steps = max(1, -(-cfg.resolved_steps_per_epoch() // self.n_shards))
        axes = ((self.pod_axis,) if self.pod_axis else ()) + self.shard_axes
        self.shard_of = shard_ids(self.mesh, axes)
        arrays = shard_index_arrays(index, self.n_shards)
        theta0 = np.asarray(theta0)
        rows_per = theta0.shape[0] // self.n_shards
        Kl = cfg.n_clusters // self.n_shards
        theta, self.idx, self.counts_global = {}, {}, {}
        for i in self.mesh.local_indices():
            s, dev = self.shard_of[i], self.mesh.slots[i].device
            rows = slice(s * rows_per, (s + 1) * rows_per)
            counts = arrays["counts"][s * Kl : (s + 1) * Kl]
            theta[s] = torch.tensor(theta0[rows], dtype=torch.float32, device=dev)
            self.idx[s] = {
                "knn_idx": torch.as_tensor(arrays["knn_idx"][rows], device=dev),
                "knn_w": torch.as_tensor(arrays["knn_w"][rows], device=dev),
                "counts": torch.as_tensor(counts, device=dev),
                "cum_counts": torch.as_tensor(arrays["cum_counts"][s * Kl : (s + 1) * Kl], device=dev),
                "total": int(counts.sum()),
            }
            self.counts_global[s] = torch.as_tensor(arrays["counts"], device=dev)
        self._epoch_fn = make_sharded_epoch_fn(cfg, self.mesh, shard_axes=self.shard_axes, pod_axis=self.pod_axis,
                                               steps_per_epoch=self.steps, n_shards=self.n_shards)
        return theta

    def run_epoch(self, theta, epoch: int, lr0: float, lr1: float):
        theta, loss = self._epoch_fn(theta, self.idx, self.counts_global, lr0, lr1, epoch)
        return theta, float(loss)

    def fetch(self, theta: dict) -> np.ndarray:
        """θ's global (K·C, d) rows; collective under several processes."""
        return fetch_global(theta, self.mesh, self.shard_of)


class HierarchicalStrategy(ShardedStrategy):
    """Multi-pod mode: intra-pod full means, inter-pod super-means."""

    name = "hierarchical"
    _hierarchical = True


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def largest_divisor_leq(k: int, n: int) -> int:
    """Largest divisor of ``k`` that is ≤ ``n``: the widest slot count a
    K-cluster fit or build shards over (and the cells a shard of a grown
    store-backed ``x_rows`` holds)."""
    for d in range(min(k, n), 0, -1):
        if k % d == 0:
            return d
    return 1


def default_mesh(cfg: NomadConfig, *, hierarchical: bool = False, device=None):
    """A mesh over (a prefix of) the global slot pool on ``device`` that
    K clusters divide: 2 pods × the widest per-pod count when
    ``hierarchical`` and it fits, else one flat axis."""
    devs = devices(device)
    K = cfg.n_clusters
    if hierarchical and K % 2 == 0:
        per_pod = largest_divisor_leq(K // 2, len(devs) // 2)
        if 2 * per_pod <= len(devs) and per_pod >= 1:
            return make_mesh((2, per_pod), ("pod", "data"), devs)
    return flat_mesh("data", devs[: largest_divisor_leq(K, len(devs))])


def resolve_strategy(spec, cfg: NomadConfig, *, method: Optional[str] = None, mesh=None,
                     shard_axes: Optional[Sequence[str]] = None, pod_axis: Optional[str] = None):
    """``"auto" | "local" | "sharded" | "hierarchical"`` (or a strategy
    instance) → a strategy ready to ``prepare``. ``"auto"``: sharded (or
    hierarchical, with ``cfg.hierarchical`` and a ``"pod"`` axis) when a
    mesh is given; local with one slot in the global pool or for
    ``"infonc"``; else sharded, hierarchical when ``cfg.hierarchical`` and
    ≥ 4 slots."""
    if isinstance(spec, ExecutionStrategy):
        return spec
    spec = spec or "auto"
    method = method or cfg.method
    if spec == "auto":
        n_dev = device_count()
        if mesh is not None:
            spec = "hierarchical" if cfg.hierarchical and "pod" in mesh.axis_names else "sharded"
        elif method == "infonc" or n_dev == 1:
            spec = "local"
        elif largest_divisor_leq(cfg.n_clusters, n_dev) == 1:
            warnings.warn(
                f"strategy='auto': {n_dev} slots share no divisor with n_clusters={cfg.n_clusters}; "
                "falling back to strategy='local'"
            )
            spec = "local"
        elif cfg.hierarchical and n_dev >= 4 and cfg.n_clusters % 2 == 0:
            spec = "hierarchical"
        else:
            spec = "sharded"
    if spec == "local":
        if process_count() > 1:
            raise ValueError(
                f"strategy='local' (method={method!r}) cannot run under torch.distributed with "
                f"{process_count()} processes: each would fit on its own. Use strategy='sharded' "
                "with n_clusters divisible by the global slot count."
            )
        return LocalStrategy()
    if spec == "sharded":
        return ShardedStrategy(mesh=mesh, shard_axes=shard_axes, pod_axis=pod_axis)
    if spec == "hierarchical":
        return HierarchicalStrategy(mesh=mesh, shard_axes=shard_axes, pod_axis=pod_axis)
    raise ValueError(f"unknown strategy {spec!r} (want 'auto'|'local'|'sharded'|'hierarchical')")
