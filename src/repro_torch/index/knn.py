"""Exact within-cluster kNN + the inverse-rank edge weights (paper §3.2/Eq 6).

Neighbour candidates are confined to the point's own (padded) cluster
block, so every cluster is a connected component of the ANN graph. The
in-cell distance matrices come from the ``pairwise`` registry kernel with
its leading batch dimension (one launch per chunk of cells, in place of
the JAX package's vmap); top-k and the rank matrix stay in PyTorch.
Serving's query-side kNN (:func:`query_cluster_knn`) takes the same kernel,
each query a batch of one row against its cell.
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


def query_cluster_knn(q: torch.Tensor, own: torch.Tensor, x_blocks: torch.Tensor,
                      counts: torch.Tensor, k: int, *, block: int = 256):
    """Query-only kNN against a frozen index: each query searches its own
    assigned (padded) cluster block, the §3.2 locality the training graph
    uses.

    q (B, D), own (B,) assigned cells, x_blocks (K, C, D), counts (K,).
    Runs ``block`` queries at a time, so the gathered (block, C, D) tile
    bounds peak memory. The distances come from the ``pairwise`` kernel
    with each query a batch of one row against its cell, so every query's
    distances are summed in one fixed order whatever the batch; a cuBLAS
    product could pick another algorithm, and round otherwise, for another
    batch size. Returns (slot (B, k) in-cell slots int64, d2 (B, k)
    ascending, valid (B, k) real-neighbour mask).
    """
    B = q.shape[0]
    C = x_blocks.shape[1]
    block = max(1, min(block, B))
    own = own.long()
    slots, d2s = [], []
    cslots = torch.arange(C, device=q.device)
    for s in range(0, B, block):
        qb, ob = q[s : s + block].float(), own[s : s + block]
        d2 = pairwise_dist2(qb[:, None, :], x_blocks[ob])[:, 0, :]  # (b, C)
        invalid = cslots[None, :] >= counts[ob][:, None]
        top = torch.topk(d2 + invalid * BIG, k, dim=-1, largest=False, sorted=True)
        slots.append(top.indices)
        d2s.append(top.values)
    slot, d2 = torch.cat(slots), torch.cat(d2s)
    valid = (slot < counts[own][:, None]) & (d2 < BIG / 2)
    return slot, torch.where(valid, d2, 0.0), valid
