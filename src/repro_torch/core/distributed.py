"""Distributed NOMAD Projection (paper Fig. 2) over a mesh of shard slots.

Clusters are sharded contiguously: shard ``s`` of ``n`` owns clusters
``[s·K/n, (s+1)·K/n)``, and each cluster is a component of the kNN graph
(paper §3.2), so positives and the exact in-cell negatives never leave
their shard. The only exchange of the optimisation loop is the
per-refresh all-gather of the cell means (:meth:`repro_torch.launch.mesh.
Mesh.all_gather`), once for all of a process's slots.

Two exchange modes (:func:`cell_exchange`):

* ``flat``         — the paper: every shard sees all K means, with weights
  ``cell_w = n_noise · counts_global / N``;
* ``hierarchical`` — the reference's multi-pod extension: the full means
  of the shard's own pod, plus one size-weighted super-mean per pod. The
  own pod's super-mean has weight 0 (its cells are already there) and the
  own cells sit at ``own_base = shard_off − pod · Kp`` of the pod block.

A slot's step is the local step (``core/nomad.py:step_update``: K1 through
``losses.nomad_step_term`` and the three fixed-order scatters) on its own
θ block with the exchanged means, weights and own-cell offset.
``batch_size`` is per shard and an epoch runs ``ceil(steps / n_shards)``
steps, so it still touches ≈ N heads. A slot's generator is seeded from ``(seed + 1, epoch, shard,
step)``, or ``(seed + 1, epoch, step)`` with one shard, which is the local
loop's stream: one slot reproduces the local fit bit for bit. Draws depend
on the shard id alone, and the cross-shard loss is a sum in shard order
of all-gathered per-slot losses, so P processes reproduce one process with
the same slot count bit for bit.

The host-side orchestration is the estimator's
(:class:`repro_torch.core.nomad.NomadProjection` with
:class:`repro_torch.core.strategy.ShardedStrategy`); :func:`fit_distributed`
is the deprecated shim the reference keeps.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.core.nomad import NomadProjection, local_means, sample_step_rows, step_update
from repro_torch.core.trace import span
from repro_torch.index.build import seeded_generator


def shard_ids(mesh, axes) -> list:
    """Each flat slot's shard id: its coordinates over ``axes`` folded in
    that order (the first axis outermost)."""
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        s = 0
        for a in axes:
            s = s * mesh.shape[a] + int(c[a])
        out.append(s)
    return out


def cell_exchange(means, counts_global: torch.Tensor, shard: int, *, n_noise: int, n_total: int,
                  n_pods: int = 1, hierarchical: bool = False):
    """One shard's view of a refresh: ``(cell_means, cell_w, own_base)``.

    ``means`` holds every shard's (K/n, d) cell means in shard order;
    ``counts_global`` the (K,) cell sizes. Flat: all K means, weights
    |M|·(|r|/N), own cells at ``shard·K/n``. Hierarchical (``n_pods`` pods
    of contiguous shards): the own pod's Kp means, then one super-mean a
    pod (the pod's means weighted by cell size), weights |M|·(|pod|/N)
    with the own pod's 0, own cells at ``shard·K/n − pod·Kp``."""
    n_shards = len(means)
    Kl = means[0].shape[0]
    p_cell = counts_global.float() / float(n_total)
    if not hierarchical:
        return torch.cat(means), float(n_noise) * p_cell, shard * Kl
    per_pod = n_shards // n_pods
    Kp = Kl * per_pod
    pod = shard // per_pod
    counts_f = counts_global.float()
    pod_means, supers, super_counts = None, [], []
    for q in range(n_pods):
        mq = torch.cat(means[q * per_pod : (q + 1) * per_pod])
        cq = counts_f[q * Kp : (q + 1) * Kp]
        supers.append(torch.sum(mq * cq[:, None], 0) / torch.clamp_min(torch.sum(cq), 1.0))
        super_counts.append(torch.sum(cq))
        if q == pod:
            pod_means = mq
    super_w = float(n_noise) * (torch.stack(super_counts) / float(n_total))
    super_w = torch.where(torch.arange(n_pods, device=super_w.device) == pod, 0.0, super_w)
    cell_w = torch.cat([float(n_noise) * p_cell[pod * Kp : (pod + 1) * Kp], super_w])
    return torch.cat([pod_means, torch.stack(supers)]), cell_w, shard * Kl - pod * Kp


def step_key(cfg: NomadConfig, epoch: int, shard: int, step: int, n_shards: int) -> tuple:
    """A slot's generator key at ``step`` of ``epoch``: the local loop's
    ``(seed + 1, epoch, step)`` with one shard, else with the shard id."""
    return (cfg.seed + 1, epoch, step) if n_shards == 1 else (cfg.seed + 1, epoch, shard, step)


def make_sharded_epoch_fn(cfg: NomadConfig, mesh, *, shard_axes=("data",), pod_axis: Optional[str] = None,
                          steps_per_epoch: int, n_shards: int):
    """``epoch(theta, idx, counts_global, lr0, lr1, e) -> (theta, loss)``.

    ``theta`` and ``idx`` map each shard this process runs to its θ block
    (K/n·C, d) and index arrays (:func:`shard_index_arrays`, on the slot's
    device); ``counts_global`` maps each of those shards to the (K,) cell
    sizes on its device. Blocks are updated in place. Means are exchanged
    every ``cfg.mean_refresh_steps`` steps (default: once, at the start),
    as the local loop refreshes them; the returned loss is the mean over
    shards of each shard's mean step loss."""
    C = cfg.cluster_capacity
    steps = steps_per_epoch
    refresh = cfg.mean_refresh_steps or steps
    axes = ((pod_axis,) if pod_axis else ()) + tuple(shard_axes)
    hierarchical = cfg.hierarchical and pod_axis is not None
    n_pods = mesh.shape[pod_axis] if pod_axis else 1
    of = shard_ids(mesh, axes)
    slot_of = {s: i for i, s in enumerate(of)}
    local = [(of[i], mesh.slots[i].device) for i in mesh.local_indices()]

    def epoch(theta, idx, counts_global, lr0: float, lr1: float, e: int):
        cells = {}
        step_losses = {s: [] for s, _ in local}
        with span("nomad.epoch"):
            for t in range(steps):
                if t % refresh == 0:
                    with span("nomad.means"):
                        got = mesh.all_gather([local_means(theta[s], idx[s]["counts"], C) for s, _ in local])
                        for s, dev in local:
                            means = [got[slot_of[r]].to(dev) for r in range(n_shards)]
                            cells[s] = cell_exchange(means, counts_global[s], s, n_noise=cfg.n_noise,
                                                     n_total=cfg.n_points, n_pods=n_pods, hierarchical=hierarchical)
                lr = lr0 + (lr1 - lr0) * (t / steps)
                for s, dev in local:
                    with span("nomad.step"):
                        with span("nomad.step.sample"):
                            gen = seeded_generator(dev, *step_key(cfg, e, s, t, n_shards))
                            rows, cl, neg_rows = sample_step_rows(gen, idx[s], cfg, "nomad")
                        cell_means, cell_w, own_base = cells[s]
                        step_losses[s].append(step_update(theta[s], idx[s], cell_means, idx[s]["counts"], lr, rows,
                                                          cl, neg_rows, cfg=cfg, cell_w=cell_w, own_base=own_base))
            got = mesh.all_gather([torch.stack(step_losses[s]).mean() for s, _ in local])
            per_shard = torch.stack([got[slot_of[s]].to(got[slot_of[0]].device) for s in range(n_shards)])
            return theta, per_shard.sum() / n_shards

    return epoch


def shard_index_arrays(index, n_shards: int) -> dict:
    """The index arrays of the sharded epoch, as host arrays in the global
    row layout: kNN rows rebased to shard-local rows (an edge that leaves
    its shard raises), per-shard cumulative counts."""
    K, C = index.n_clusters, index.capacity
    if K % n_shards:
        raise ValueError(f"n_clusters={K} not divisible by n_shards={n_shards}")
    Kl = K // n_shards
    rows_per = Kl * C
    knn_local = np.array(index.knn_idx, dtype=np.int64)
    for s in range(n_shards):
        lo, hi = s * rows_per, (s + 1) * rows_per
        blk = knn_local[lo:hi]
        if blk.size and ((blk < lo) | (blk >= hi)).any():
            raise AssertionError("kNN edge crosses shard boundary")
        knn_local[lo:hi] = blk - lo
    counts = np.asarray(index.counts, np.int64)
    cum = np.concatenate([np.cumsum(counts[s * Kl : (s + 1) * Kl]) for s in range(n_shards)])
    return {
        "knn_idx": knn_local,
        "knn_w": np.asarray(index.knn_w, np.float32),
        "counts": counts,
        "cum_counts": cum,
    }


def fit_distributed(cfg: NomadConfig, x, mesh, *, shard_axes=("data", "model"), pod_axis: Optional[str] = None,
                    index=None, theta0=None, callback=None, device=None):
    """Deprecated: use ``NomadProjection(cfg, strategy="sharded", mesh=mesh,
    device=device).fit(x)``. Returns the old ``(embedding, index, losses)``
    triple; ``callback`` receives the unpermuted (N, out_dim) embedding."""
    warnings.warn(
        "fit_distributed is deprecated; use "
        "NomadProjection(cfg, strategy='sharded'|'hierarchical', mesh=mesh).fit(x)",
        DeprecationWarning,
        stacklevel=2,
    )
    strategy = "hierarchical" if (cfg.hierarchical and pod_axis) else "sharded"
    est = NomadProjection(cfg, strategy=strategy, mesh=mesh, shard_axes=shard_axes, pod_axis=pod_axis,
                          device=device)
    res = est.fit(x, index=index, callback=callback, theta0=theta0)
    return res.embedding, res.index, res.losses
