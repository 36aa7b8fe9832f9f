"""Exact within-cluster kNN + the inverse-rank edge weights (paper §3.2/Eq 6).

Neighbour candidates are confined to the point's own (padded) cluster
block, so every cluster is a connected component of the ANN graph. The
in-cell distance matrices come from the ``pairwise`` registry kernel with
its leading batch dimension (one launch per chunk of cells, in place of
the JAX package's vmap); top-k and the rank matrix stay in PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.core.rank_model import edge_weights
from repro_torch.kernels.pairwise.ops import pairwise_dist2

BIG = 1e30


def batched_cluster_knn(x_blocks: torch.Tensor, valid: torch.Tensor, k: int):
    """x_blocks (Kc, C, D) padded cells, valid (Kc, C) real-point mask →
    (knn_idx (Kc, C, k) in-cell slots int32, weights (Kc, C, k) fp32)."""
    C = x_blocks.shape[1]
    d2 = pairwise_dist2(x_blocks, x_blocks)  # (Kc, C, C)
    pad = (~(valid[:, :, None] & valid[:, None, :])).float()
    eye = torch.eye(C, device=d2.device)
    search = d2 + pad * BIG + eye * BIG  # padding and self never chosen
    knn_idx = torch.topk(search, k, dim=-1, largest=False, sorted=True).indices
    # ranks use the true distances with padding pushed to the end
    w = edge_weights(d2 + pad * BIG, knn_idx, k, valid)
    return knn_idx.to(torch.int32), w


def cluster_knn(x_block: torch.Tensor, valid: torch.Tensor, k: int):
    """One padded cluster: x_block (C, D), valid (C,) → (C, k) slots, weights."""
    idx, w = batched_cluster_knn(x_block[None], valid[None], k)
    return idx[0], w[0]
