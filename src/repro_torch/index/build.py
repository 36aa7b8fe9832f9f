"""The local index build (paper §3.2) on one device.

:class:`IndexBuilder` runs the JAX package's local pipeline stage by stage:

* **kmeans**  — LSH-initialised EM (:mod:`repro_torch.index.kmeans`), its
  E-step the ``kmeans_assign`` registry kernel per row block;
* **assign**  — capacity-bounded assignment: one row-blocked pass through
  the ``pairwise`` kernel caches each row's R nearest centroids
  (``cfg.build_candidates``), then bidding rounds, each O(N·R): every
  unassigned row bids for its nearest centroid with free capacity and
  :func:`capacity_admit` admits each centroid's ``free`` closest bidders;
* **stragglers** — rows whose whole candidate list filled up are
  force-placed on the host (the JAX package times this within "assign");
* **permute** — the cluster-major permutation (stable sort + scatter);
* **knn**     — exact in-cell kNN, chunks of cells at a time through the
  batched ``pairwise`` kernel, so the (K, C, C) distances never exist at
  once.

Devices: :class:`IndexBuilder` runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named it raises.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.index import kmeans as km
from repro_torch.index.ann import AnnIndex, data_fingerprint
from repro_torch.index.knn import batched_cluster_knn, smallest_k_by_sort
from repro_torch.kernels.capacity_admit.ops import capacity_admit
from repro_torch.kernels.pairwise.ops import pairwise_dist2

KNN_CELL_CHUNK = 256  # cells per batched in-cell kNN launch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the first CUDA device; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def seeded_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers (the
    port's stand-in for ``jax.random.fold_in`` keying)."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(seed[0]) << 31) ^ int(seed[1])
    )


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Capacity-bounded assignment
# ---------------------------------------------------------------------------


def candidate_pass(x: torch.Tensor, cents: torch.Tensor, n_cand: int, block: int):
    """Each row's ``R = min(n_cand, K)`` nearest centroids, distance-sorted
    (ties to the lower centroid, as ``jax.lax.top_k`` orders them): a
    (block, K) ``pairwise`` tile per row block, of which only the (N, R)
    top-R survives."""
    n = x.shape[0]
    r = min(n_cand, cents.shape[0])
    block = max(1, min(block, n))
    idx, d2 = [], []
    for s in range(0, n, block):
        top_d2, top_idx = smallest_k_by_sort(pairwise_dist2(x[s : s + block], cents), r)
        idx.append(top_idx.to(torch.int32))
        d2.append(top_d2)
    return torch.cat(idx), torch.cat(d2)


def bid_from_candidates(cand_idx, cand_d2, free):
    """Each row's nearest centroid with free capacity (the first free
    candidate); rows whose every candidate is full (``has`` False) sit out."""
    ok = free[cand_idx.long()] > 0  # (N, R)
    has = torch.any(ok, 1)
    j = torch.argmax(ok.to(torch.uint8), 1)  # first free candidate
    rows = torch.arange(cand_idx.shape[0], device=cand_idx.device)
    return cand_idx[rows, j], cand_d2[rows, j], has


def capacity_rounds(cand_idx, cand_d2, n_clusters: int, capacity: int, max_rounds: int):
    """Bidding rounds over cached candidates → (assign (N,) int32, -1 for
    stragglers; free (K,) int32). Every round with bidders admits at least
    one, and the loop stops once no row can bid."""
    n = cand_idx.shape[0]
    device = cand_idx.device
    assign = torch.full((n,), -1, dtype=torch.int32, device=device)
    free = torch.full((n_clusters,), capacity, dtype=torch.int32, device=device)
    for _ in range(max_rounds):
        if not bool(torch.any(assign < 0)):
            break
        pick, d2, has = bid_from_candidates(cand_idx, cand_d2, free)
        bidding = (assign < 0) & has
        if not bool(torch.any(bidding)):
            break
        admitted = capacity_admit(pick, d2, bidding, free)
        assign = torch.where(admitted, pick, assign)
        free = free - torch.bincount(pick[admitted].long(), minlength=n_clusters).to(torch.int32)
    return assign, free


def force_place_host(x: np.ndarray, cents: np.ndarray, assign: np.ndarray, free: np.ndarray, chunk: int = 8192):
    """Place stragglers (rows unassigned after the rounds) into their
    nearest centroid with space, on the host, chunked to a (chunk, K)
    distance block."""
    todo = np.flatnonzero(assign < 0)
    if todo.size == 0:
        return assign, 0
    c = cents.astype(np.float32)
    for s in range(0, todo.size, chunk):
        block = todo[s : s + chunk]
        a = x[block].astype(np.float32)
        d2 = np.sum(a**2, -1)[:, None] + np.sum(c**2, -1)[None, :] - 2.0 * a @ c.T
        for t, row in zip(block, np.argsort(d2, axis=1)):
            for cl in row:
                if free[cl] > 0:
                    assign[t] = cl
                    free[cl] -= 1
                    break
    if (assign < 0).any():
        raise RuntimeError("capacity assignment: total capacity < N")
    return assign, int(todo.size)


# ---------------------------------------------------------------------------
# Cluster-major permutation and kNN assembly
# ---------------------------------------------------------------------------


def permutation_from_assign(assign: torch.Tensor, n_clusters: int, capacity: int):
    """assign (N,) → (perm (N,), counts (K,)): row = cluster·capacity +
    slot, slots in stable original-index order."""
    n = assign.shape[0]
    a = assign.long()
    order = torch.argsort(a, stable=True)
    counts = torch.bincount(a, minlength=n_clusters)
    starts = torch.cumsum(counts, 0) - counts
    a_sorted = a[order]
    slot = torch.arange(n, device=a.device) - starts[a_sorted]
    perm = torch.empty_like(a)
    perm[order] = a_sorted * capacity + slot
    return perm, counts


def finalize_knn(knn_local: np.ndarray, knn_w: np.ndarray, K: int, C: int):
    """(K, C, k) in-cluster slots → (K·C, k) global rows; dead edges → self."""
    knn_w = knn_w.reshape(K * C, -1)
    base = (np.arange(K) * C)[:, None, None]
    knn_idx = (knn_local + base).reshape(K * C, -1).astype(np.int64)
    self_rows = np.arange(K * C)[:, None]
    knn_idx = np.where(knn_w > 0, knn_idx, self_rows)
    return knn_idx, knn_w.astype(np.float32)


def chunked_cluster_knn(x_rows: np.ndarray, counts: torch.Tensor, C: int, k: int,
                        device: torch.device):
    """In-cell kNN of every cell, KNN_CELL_CHUNK cells per batched launch."""
    K = counts.shape[0]
    D = x_rows.shape[1]
    blocks = x_rows.reshape(K, C, D)
    slots = torch.arange(C, device=device)
    idx, w = [], []
    for c0 in range(0, K, KNN_CELL_CHUNK):
        c1 = c0 + KNN_CELL_CHUNK
        xb = torch.from_numpy(np.ascontiguousarray(blocks[c0:c1])).to(device).float()
        valid = slots[None, :] < counts[c0:c1, None]
        i, ww = batched_cluster_knn(xb, valid, k)
        idx.append(i.cpu().numpy())
        w.append(ww.cpu().numpy())
    return np.concatenate(idx), np.concatenate(w)


# ---------------------------------------------------------------------------
# IndexBuilder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BuildReport:
    """Provenance of one index build."""

    strategy: str
    n_shards: int
    total_s: float
    # {"kmeans" | "assign" | "stragglers" | "permute" | "knn": seconds};
    # "stragglers" is the host force-place the JAX package counts in "assign"
    stage_s: dict
    stragglers: int = 0


class IndexBuilder:
    """Builds the §3.2 :class:`AnnIndex` on one device.

    ``device`` defaults to the first CUDA device (raising without one);
    pass ``device="cpu"`` for the plain path. After ``build`` the per-stage
    wall times (synchronised with the device) sit in :attr:`report`.
    """

    def __init__(self, cfg: NomadConfig, *, device=None):
        if cfg.build_strategy not in ("auto", "local"):
            raise NotImplementedError(
                f"build_strategy={cfg.build_strategy!r}: only the local build is ported"
            )
        if cfg.chunk_rows:
            raise NotImplementedError("chunk_rows > 0 (the streamed build) is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.report: Optional[BuildReport] = None

    def build(self, x: np.ndarray) -> AnnIndex:
        """Build the index of ``x`` (N, D) float32."""
        cfg, device = self.cfg, self.device
        n, d = x.shape
        K, C, k = cfg.n_clusters, cfg.cluster_capacity, cfg.n_neighbors
        if K * C < n:
            raise ValueError(f"capacity {C}×{K} < N={n}; raise capacity_slack")
        block = cfg.build_block_rows
        stage_s: dict = {}

        @contextmanager
        def stage(label):
            t0 = time.time()
            yield
            synchronize(device)
            stage_s[label] = stage_s.get(label, 0.0) + (time.time() - t0)

        t0 = time.time()
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        with stage("kmeans"):
            cents = km.kmeans_centroids(
                seeded_generator(device, cfg.seed),
                xd,
                K,
                n_iters=cfg.kmeans_iters,
                tol=cfg.kmeans_tol,
                block=block,
            )
        with stage("assign"):
            cand_idx, cand_d2 = candidate_pass(xd, cents, cfg.build_candidates, block)
            del xd
            assign_d, free_d = capacity_rounds(cand_idx, cand_d2, K, C, cfg.build_max_rounds)
        with stage("stragglers"):
            cents_h = cents.cpu().numpy()
            assign, stragglers = force_place_host(
                x, cents_h, assign_d.cpu().numpy().astype(np.int64), free_d.cpu().numpy().copy()
            )
        with stage("permute"):
            perm_d, counts = permutation_from_assign(torch.from_numpy(assign).to(device), K, C)
            perm = perm_d.cpu().numpy()
            x_rows = np.zeros((K * C, d), x.dtype)
            x_rows[perm] = x
        with stage("knn"):
            knn_local, knn_w = chunked_cluster_knn(x_rows, counts, C, k, device)
            knn_idx, knn_w = finalize_knn(knn_local, knn_w, K, C)
        index = AnnIndex(
            x_rows=x_rows,
            knn_idx=knn_idx,
            knn_w=knn_w,
            counts=counts.cpu().numpy().astype(np.int64),
            centroids=cents_h,
            perm=perm,
            capacity=C,
            n_points=n,
            fingerprint=data_fingerprint(x),
        )
        self.report = BuildReport(
            strategy="local", n_shards=1, total_s=time.time() - t0,
            stage_s=stage_s, stragglers=stragglers,
        )
        return index
