"""Neighborhood preservation @ k (paper §4): the mean overlap of
k-neighbourhoods between the high- and low-dimensional spaces, and
:func:`map_stability`, the same overlap between two versions of a map.

The neighbour search is exact, never the index's approximation: blocked
squared distances on the device (``‖q‖² + ‖x‖² − 2 q·x``, clamped at 0),
merged block by block into a running best list by
:func:`repro_torch.index.knn.smallest_k_by_sort`, which orders equal
distances by index as ``jax.lax.top_k`` does. For large N the metric is
evaluated on a uniform subsample of query rows, drawn as the JAX package
draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.knn import smallest_k_by_sort


def _topk_neighbors(queries: torch.Tensor, data: torch.Tensor, k: int, block: int = 8192) -> torch.Tensor:
    """Exact k nearest rows of ``data`` for each query (B, k) int64, self
    included; equal distances in ascending row order."""
    q2 = torch.sum(torch.square(queries), -1)[:, None]
    B = queries.shape[0]
    best_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=queries.device)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=queries.device)
    for start in range(0, data.shape[0], block):
        db = data[start : start + block]
        d2 = torch.clamp_min(q2 + torch.sum(torch.square(db), -1)[None, :] - 2.0 * (queries @ db.T), 0.0)
        ids = torch.arange(start, start + db.shape[0], device=queries.device).expand(B, -1)
        best_d, pos = smallest_k_by_sort(torch.cat([best_d, d2], 1), k)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, pos)
    return best_i


def exact_knn(data, q_idx: np.ndarray, k: int, *, device=None, chunk: int = 2048) -> np.ndarray:
    """The k nearest rows of ``data`` (N, d) to each of its rows ``q_idx``,
    the row itself left out: (Q, k) int64. A query with more than k rows
    at distance 0 may not find itself among the k + 1 searched, and keeps
    the first k. Where N ≤ k the missing neighbours are -1 or -2, as in the
    JAX package; neither is a row. Runs on ``device`` (default: the card)."""
    from repro_torch.index.build import resolve_device

    device = resolve_device(device)
    d = torch.as_tensor(np.asarray(data, np.float32), device=device)
    q_idx = np.asarray(q_idx, np.int64)
    out = np.full((q_idx.size, k), -2, np.int64)
    for s in range(0, q_idx.size, chunk):
        qi = q_idx[s : s + chunk]
        found = _topk_neighbors(d[torch.as_tensor(qi, device=device)], d, k + 1).cpu().numpy()
        for r, (row, self_i) in enumerate(zip(found, qi)):
            row = row[row != self_i][:k]
            out[s + r, : len(row)] = row
    return out


def neighborhood_preservation(x_high: np.ndarray, x_low: np.ndarray, k: int = 10, n_queries: int = 2000,
                              seed: int = 0, *, device=None) -> float:
    """NP@k in [0, 1] over ``n_queries`` rows drawn from ``seed``, self
    neighbours excluded. Runs on ``device`` (default: the card)."""
    n = x_high.shape[0]
    rng = np.random.default_rng(seed)
    q_idx = rng.choice(n, size=min(n_queries, n), replace=False)
    hi = exact_knn(x_high, q_idx, k, device=device)
    lo = exact_knn(x_low, q_idx, k, device=device)
    overlap = [len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(hi, lo)]
    return float(np.mean(overlap))


def map_stability(emb_prev: np.ndarray, emb_new: np.ndarray, k: int = 10, n_queries: int = 2000,
                  seed: int = 0, *, device=None) -> float:
    """How much a map *moved* under an update, in [0, 1]: the
    k-neighbourhood overlap between two embeddings of the **same rows in
    the same order** (after appending rows, pass the new embedding's shared
    prefix). 1.0: every row kept its neighbours; 0.0: none did."""
    emb_prev = np.asarray(emb_prev)
    emb_new = np.asarray(emb_new)
    if emb_prev.shape[0] != emb_new.shape[0]:
        raise ValueError(
            f"map_stability compares the same rows across versions: got "
            f"{emb_prev.shape[0]} previous vs {emb_new.shape[0]} new rows — "
            "slice the grown embedding to the shared prefix first"
        )
    return neighborhood_preservation(emb_prev, emb_new, k=k, n_queries=n_queries, seed=seed, device=device)
