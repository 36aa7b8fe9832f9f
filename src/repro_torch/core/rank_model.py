"""The inverse-rank edge model (paper Eq. 6).

    p(j|i) = e^{1/rank_j(i)} / Z   if rank_j(i) ≤ k, else 0
    Z      = Σ_{j=0}^{k} e^{1/(j+1)}

``rank_j(i)`` is the index of the head i in the list of points sorted by
ascending distance to the tail j (index 0 is j itself). The functions take
an optional leading batch of cells; ranks use a *stable* sort so ties rank
as the JAX package's ``jnp.argsort`` ranks them.
"""

from __future__ import annotations

import numpy as np
import torch


def normalizer(k: int) -> float:
    return float(np.exp(1.0 / np.arange(1, k + 2)).sum())


def rank_matrix(dist2: torch.Tensor) -> torch.Tensor:
    """R[..., i, j] = rank of i in j's ascending-distance order (0 = j).

    dist2: (..., C, C) squared distances with dist2[..., j, j] = 0.
    """
    order = torch.argsort(dist2, dim=-2, stable=True)  # order[r, j] = point at rank r from j
    C = dist2.shape[-1]
    ranks = torch.arange(C, device=dist2.device, dtype=torch.int32)[:, None]
    return torch.empty_like(order, dtype=torch.int32).scatter_(
        -2, order, ranks.expand(order.shape).contiguous()
    )


def edge_weights(
    dist2: torch.Tensor, knn_idx: torch.Tensor, k: int, valid: torch.Tensor
) -> torch.Tensor:
    """Weights p(j|i) for each kNN edge i→j (Eq. 6).

    dist2:   (..., C, C) in-cluster squared distances (padding masked high)
    knn_idx: (..., C, k) neighbour slots per point
    valid:   (..., C) real-point mask
    Returns (..., C, k) fp32 weights; invalid edges get 0.
    """
    R = rank_matrix(dist2)
    r_ji = torch.gather(R, -1, knn_idx.long())  # R[i, j]: rank of i from j
    w = torch.exp(1.0 / torch.clamp_min(r_ji.float(), 1.0)) / normalizer(k)
    w = torch.where((r_ji >= 1) & (r_ji <= k), w, 0.0)
    valid_j = torch.gather(valid, -1, knn_idx.long().flatten(-2)).view(knn_idx.shape)
    return torch.where(valid[..., :, None] & valid_j, w, 0.0)
