"""LSH-initialised K-means (paper §3.2).

Every E-step goes through :func:`blocked_assign`, which runs the
``kmeans_assign`` registry kernel (the fused CUDA E-step on the card, its
plain version on the CPU) one row block at a time, so a live (block, K)
matrix exists only on the CPU path. EM is a Python loop with the JAX
scan's freeze-on-converge rule: once the largest centroid shift drops
under ``tol`` the *pre-update* centroids are kept. The M-step sums rows
with ``index_put_(accumulate=True)``, which on CUDA sorts the indices and
adds duplicates in a fixed order, so EM repeats bit for bit on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.kmeans_assign.ops import assign_nearest


def scatter_sum(n_out: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ values[index == i], deterministic on every device."""
    out = torch.zeros((n_out,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_put_((index.long(),), values, accumulate=True)


def lsh_init_centroids(
    gen: torch.Generator, x: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    """Random-hyperplane LSH buckets → bucket means as initial centroids.

    b = ceil(log2 K) hyperplanes give 2^b ≥ K buckets; the K most populated
    buckets seed the centroids; empty seats fall back to random points.
    """
    n, d = x.shape
    b = max(1, int(np.ceil(np.log2(n_clusters))))
    planes = torch.randn((d, b), generator=gen, device=x.device)
    bits = (x.float() @ planes) > 0  # (n, b)
    codes = torch.sum(bits * (2 ** torch.arange(b, device=x.device))[None, :], 1)
    n_buckets = 2**b
    sums = scatter_sum(n_buckets, codes, x.float())
    cnts = scatter_sum(n_buckets, codes, torch.ones((n,), device=x.device))
    order = torch.argsort(-cnts, stable=True)  # most populated first
    top = order[:n_clusters]
    cents = sums[top] / torch.clamp_min(cnts[top], 1.0)[:, None]
    fallback = x[torch.randint(0, n, (n_clusters,), generator=gen, device=x.device)].float()
    return torch.where((cnts[top] > 0)[:, None], cents, fallback)


def blocked_assign(x: torch.Tensor, cents: torch.Tensor, block: int):
    """Row-blocked E-step through the registry: (assign (N,) int32,
    min_d2 (N,) fp32), one ``kmeans_assign`` call per ``block`` rows."""
    n = x.shape[0]
    block = max(1, min(block, n))
    parts = [assign_nearest(x[s : s + block], cents) for s in range(0, n, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def em_loop(x, cents0, n_clusters: int, n_iters: int, tol: float, block: int):
    """The EM body of the JAX ``_em_scan``: E-step, M-step, and once the
    largest centroid shift drops under ``tol``, stop and keep the
    pre-update centroids (the JAX scan's freeze-on-converge rule)."""
    xf = x.float()
    ones = torch.ones((x.shape[0],), device=x.device)
    cents = cents0
    for _ in range(n_iters):
        a, _ = blocked_assign(x, cents, block)
        cnts = scatter_sum(n_clusters, a, ones)
        new = scatter_sum(n_clusters, a, xf) / torch.clamp_min(cnts, 1.0)[:, None]
        new = torch.where((cnts > 0)[:, None], new, cents)
        if bool(torch.max(torch.sum(torch.square(new - cents), -1)) < tol):
            break
        cents = new
    return cents


def kmeans_centroids(
    gen: torch.Generator,
    x: torch.Tensor,
    n_clusters: int,
    n_iters: int = 25,
    tol: float = 1e-4,
    *,
    block: int = 16384,
    cents0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Centroids-only EM from LSH init — the index build's kmeans stage.
    ``cents0`` replaces the LSH init (the tests start both packages from
    the same centroids)."""
    if cents0 is None:
        cents0 = lsh_init_centroids(gen, x, n_clusters)
    return em_loop(x, cents0, n_clusters, n_iters, tol, min(block, x.shape[0]))
