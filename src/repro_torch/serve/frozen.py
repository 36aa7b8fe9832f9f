"""The frozen state a fitted map is served from.

:class:`FrozenMap` holds on one device what every transform reads: the
fitted positions θ (cluster-major, capacity-padded, the layout training
used), the frozen §3.2 index geometry (cluster vectors, centroids,
counts), the per-cell position means the repulsive M̃ term reads, and the
row → original-id inverse permutation that neighbour ids are reported in.
It is built

* from a finished fit (:meth:`from_fit`; the estimator does this), or
* from a checkpoint directory (:meth:`from_checkpoint`): θ from the latest
  ``step_*/`` and the index from the ``index.npz`` written beside it, so
  the server never needs the corpus that built the map. Directories
  written by the JAX package load too.

Nothing here is ever written after construction: the serving kernels'
gradients stop at the query positions and the repulsive mass.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.index.ann import AnnIndex, index_cache_path, load_index


@dataclasses.dataclass
class FrozenMap:
    """One fitted NOMAD map, resident on ``theta_rows.device``."""

    theta_rows: torch.Tensor  # (K·C, out_dim) fitted positions, cluster-major
    x_rows: torch.Tensor  # (K·C, D) frozen input vectors (padding rows = 0)
    centroids: torch.Tensor  # (K, D)
    counts: torch.Tensor  # (K,) int64 real points per cluster
    means: torch.Tensor  # (K, out_dim) per-cell position means (M̃ input)
    inv_perm: torch.Tensor  # (K·C,) int64 original point id per row (-1 = pad)
    capacity: int
    n_points: int
    cfg: NomadConfig

    @property
    def device(self) -> torch.device:
        return self.theta_rows.device

    @property
    def n_clusters(self) -> int:
        return int(self.counts.shape[0])

    @property
    def out_dim(self) -> int:
        return int(self.theta_rows.shape[1])

    @property
    def dim(self) -> int:
        return int(self.x_rows.shape[1])

    @property
    def x_blocks(self) -> torch.Tensor:
        """x_rows as (K, C, D) cells."""
        return self.x_rows.view(self.n_clusters, self.capacity, self.dim)

    def neighbors(self, vec, k: Optional[int] = None):
        """Corpus rows nearest to embedding vector(s) ``vec`` through the
        frozen index: centroid assign → in-cell kNN → original ids.

        ``vec`` is ``(D,)`` or ``(B, D)``; returns ``(ids, dists)`` of shape
        ``(k,)``/``(B, k)``: int32 original corpus ids (-1 where the cell
        holds fewer than ``k`` rows) and float32 Euclidean distances (inf
        there). ``k`` defaults to ``cfg.n_neighbors``. The ids and
        distances equal the transform path's neighbour report.
        """
        from repro_torch.serve.transform import assign_and_knn

        q = np.asarray(vec, np.float32)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"neighbors: expected ({self.dim},) or (n, {self.dim}) vectors, "
                f"got shape {np.asarray(vec).shape}"
            )
        if not np.isfinite(q).all():
            raise ValueError("neighbors: query vectors contain NaN/Inf")
        kk = self.cfg.n_neighbors if k is None else int(k)
        if not 1 <= kk <= self.capacity:
            raise ValueError(f"neighbors: k={kk} outside [1, capacity={self.capacity}]")
        with torch.no_grad():
            _, rows, d2, valid = assign_and_knn(self, torch.from_numpy(q).to(self.device), kk)
            ids = torch.where(valid, self.inv_perm[rows], -1)
            dists = torch.where(valid, torch.sqrt(d2), torch.inf)
        ids = ids.cpu().numpy().astype(np.int32)
        dists = dists.cpu().numpy()
        return (ids[0], dists[0]) if squeeze else (ids, dists)

    def to(self, device) -> "FrozenMap":
        """The same map with every tensor on ``device`` (a serving slot's
        replica)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if torch.is_tensor(getattr(self, f.name))
        })

    # -- constructors ----------------------------------------------------------

    @classmethod
    def from_index_theta(cls, index: AnnIndex, theta_rows, cfg: NomadConfig, *,
                         device=None) -> "FrozenMap":
        """Freeze an (index, cluster-major θ) pair: the shared tail of both
        public constructors, so a fit-resident and a checkpoint-loaded map
        are bit-identical given the same inputs. ``device`` defaults to the
        card (raising without one); pass ``"cpu"`` for the plain path."""
        from repro_torch.core.nomad import local_means
        from repro_torch.core.runtime import resolve_device

        device = resolve_device(device)
        K, C = index.n_clusters, index.capacity
        theta = torch.as_tensor(np.asarray(theta_rows), dtype=torch.float32).to(device)
        if theta.dim() != 2 or theta.shape[0] != K * C:
            raise ValueError(
                f"theta_rows {tuple(theta.shape)} does not match the index layout "
                f"({K} clusters × capacity {C})"
            )
        counts = torch.as_tensor(np.asarray(index.counts), dtype=torch.int64).to(device)
        inv = np.full((K * C,), -1, np.int64)
        inv[index.perm] = np.arange(index.n_points, dtype=np.int64)
        return cls(
            theta_rows=theta,
            x_rows=_x_rows_on(index.x_rows, device),
            centroids=torch.as_tensor(np.asarray(index.centroids), dtype=torch.float32).to(device),
            counts=counts,
            means=local_means(theta, counts, C),
            inv_perm=torch.from_numpy(inv).to(device),
            capacity=C,
            n_points=index.n_points,
            cfg=cfg,
        )

    @classmethod
    def from_fit(cls, result, cfg: NomadConfig, *, device=None) -> "FrozenMap":
        """Freeze a finished :class:`~repro_torch.core.nomad.FitResult`
        (the embedding scattered back into the cluster-major buffer; padding
        rows are zero, as θ left training)."""
        index = result.index
        rows = np.zeros((index.n_clusters * index.capacity, result.embedding.shape[1]), np.float32)
        rows[index.perm] = result.embedding
        return cls.from_index_theta(index, rows, cfg, device=device)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, cfg: Optional[NomadConfig] = None, *,
                        device=None) -> "FrozenMap":
        """Freeze the latest checkpoint of ``checkpoint_dir``: θ from
        ``step_*/``, geometry from the ``index.npz`` cache. Needs no
        training data and no estimator."""
        from repro_torch.checkpoint import load_theta

        cache = index_cache_path(checkpoint_dir)
        if not os.path.exists(cache):
            raise FileNotFoundError(
                f"no index cache at {cache}: serving from a checkpoint needs the "
                "index.npz a fit with cfg.checkpoint_dir set writes (or pass an "
                "AnnIndex through FrozenMap.from_index_theta)"
            )
        index = load_index(cache)
        theta, meta = load_theta(checkpoint_dir)
        if cfg is None:
            stored = meta.get("config")
            if stored is None:
                raise ValueError(
                    f"checkpoint under {checkpoint_dir} has no stored config: "
                    "pass cfg= to serve it"
                )
            cfg = NomadConfig.from_stored(stored)
        return cls.from_index_theta(index, theta, cfg, device=device)


def _x_rows_on(x_rows, device: torch.device, chunk_rows: int = 65536) -> torch.Tensor:
    """The frozen cluster vectors on ``device`` as float32. A store-backed
    ``x_rows`` (the streamed build's spill) is copied chunk by chunk into
    one device tensor, so the host holds one chunk of it at a time."""
    from repro_torch.data.store import is_store
    from repro_torch.index.kmeans import chunk_to_device

    if not is_store(x_rows):
        return torch.as_tensor(np.asarray(x_rows), dtype=torch.float32).to(device)
    n = x_rows.shape[0]
    out = torch.empty(x_rows.shape, dtype=torch.float32, device=device)
    for s in range(0, n, chunk_rows):
        out[s : s + chunk_rows] = chunk_to_device(x_rows.read_encoded(s, min(s + chunk_rows, n)), device)
    return out
