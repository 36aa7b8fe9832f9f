"""Execution strategies: where and how one NOMAD epoch runs, and the fit's
event API.

This slice ports :class:`LocalStrategy`, the single-device loop, and
:class:`PartialRefineStrategy`, the refinement epochs of ``partial_fit``;
the sharded and hierarchical strategies come with the multi-GPU slice.

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


class LocalStrategy:
    """Single-device loop (``core/nomad.py:run_epoch``). ``prepare`` moves
    θ and the index arrays to the device; ``run_epoch`` steps θ in place."""

    name = "local"
    n_shards = 1

    def prepare(self, cfg: NomadConfig, method: str, index, theta0, device) -> torch.Tensor:
        self.cfg, self.method = cfg, method
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

        theta, loss = run_epoch(theta, self.idx, self.cfg, self.method, self.steps, lr0, lr1, epoch)
        return theta, float(loss)

    def refreshes_per_epoch(self) -> int:
        refresh = self.cfg.mean_refresh_steps or self.steps
        return max(1, -(-self.steps // refresh))

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
        )
        return theta, float(loss)


def largest_divisor_leq(k: int, n: int) -> int:
    """Largest divisor of ``k`` that is ≤ ``n`` (the JAX package's
    ``core/strategy.py:largest_divisor_leq``): here, the cells a shard of a
    grown store-backed ``x_rows`` holds."""
    for d in range(min(k, n), 0, -1):
        if k % d == 0:
            return d
    return 1
