"""Exact within-cluster kNN + the inverse-rank edge weights (paper §3.2/Eq 6).

Neighbour candidates are confined to the point's own (padded) cluster
block, so every cluster is a connected component of the ANN graph. The
in-cell distance matrices come from the ``pairwise`` registry kernel with
its leading batch dimension (one launch per chunk of cells, in place of
the JAX package's vmap); top-k and the rank matrix stay in PyTorch.
Serving's query-side kNN (:func:`query_cluster_knn`) takes the same kernel,
each query a batch of one row against its cell.

Top-k keeps ``jax.lax.top_k``'s order among equal distances, by the way
that measured cheaper at each site on the card
(``chip_smoke.py:check_top_k``): ``torch.topk`` over int64 keys for the
in-cell kNN, a stable sort for serving's query kNN and the build's
candidate pass.
"""

from __future__ import annotations

import torch

from repro_torch.core.rank_model import edge_weights
from repro_torch.kernels.pairwise.ops import pairwise_dist2

BIG = 1e30


def _total_order(d: torch.Tensor) -> torch.Tensor:
    """``d``'s float32 bits as int32 keys in the total order of floats that
    ``jax.lax.top_k`` sorts by (-0.0 before +0.0): negative floats' bits
    are reversed."""
    bits = d.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def smallest_k_by_sort(d: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries of ``d`` along its last
    dim, ascending, equal values in ascending index order: what
    ``jax.lax.top_k(-d, k)`` returns. ``torch.topk`` keeps no order among
    equal values; a stable sort of the total-order keys does."""
    idx = torch.sort(_total_order(d), dim=-1, stable=True).indices[..., :k]
    return torch.gather(d, -1, idx), idx


def smallest_k_by_topk(d: torch.Tensor, k: int):
    """:func:`smallest_k_by_sort`'s result from ``torch.topk`` over an int64
    key: the total-order bits above, the column below, every key distinct."""
    key = (_total_order(d).long() << 32) | torch.arange(d.shape[-1], device=d.device)
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(d, -1, idx), idx


def batched_cluster_knn(x_blocks: torch.Tensor, valid: torch.Tensor, k: int):
    """x_blocks (Kc, C, D) padded cells, valid (Kc, C) real-point mask →
    (knn_idx (Kc, C, k) in-cell slots int32, weights (Kc, C, k) fp32)."""
    C = x_blocks.shape[1]
    d2 = pairwise_dist2(x_blocks, x_blocks)  # (Kc, C, C)
    pad = (~(valid[:, :, None] & valid[:, None, :])).float()
    eye = torch.eye(C, device=d2.device)
    search = d2 + pad * BIG + eye * BIG  # padding and self never chosen
    _, knn_idx = smallest_k_by_topk(search, k)
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
        top_d2, top_slot = smallest_k_by_sort(d2 + invalid * BIG, k)
        slots.append(top_slot)
        d2s.append(top_d2)
    slot, d2 = torch.cat(slots), torch.cat(d2s)
    valid = (slot < counts[own][:, None]) & (d2 < BIG / 2)
    return slot, torch.where(valid, d2, 0.0), valid
