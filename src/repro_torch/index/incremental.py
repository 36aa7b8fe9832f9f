"""Incremental admission of appended rows into a fitted §3.2 index.

The index half of ``partial_fit`` (the JAX package's
``index/incremental.py``): given the previous :class:`AnnIndex`, its
cluster-major θ and a batch of new rows already *placed* on the frozen map
by the serve path, produce the grown index without rebuilding it:

1. **admit** — each new row targets its placement cell. Cells whose
   ``counts + incoming`` stay within capacity take the rows into their
   free slots, in the order the rows come; their members, rows, kNN
   entries and centroid stay bit-untouched.
2. **split** — an overflowing cell is re-seeded: its members (old, then
   incoming) run a small LSH-init k-means (``kmeans_assign`` on the card)
   into enough sub-cells to restore the build's average fill, then the
   build's capacity-bounded bidding (:func:`capacity_assign_device`,
   ``pairwise`` on the card). The first non-empty sub-cell keeps the
   cell's id, so every other cell's rows stay put; the rest are appended
   at K, K+1, … — K grows, capacity C never changes.
3. **patch** — the in-cell kNN graph is recomputed for the affected cells
   only, by the build's own
   :func:`~repro_torch.index.build.chunked_cluster_knn` (``KNN_CELL_CHUNK``
   cells a ``pairwise`` launch); ``x_rows`` is patched
   by block copy, or, when it is a store, rewritten into a fresh sharded
   store by two ``write_sharded(commit=False)`` regions and one
   ``commit_sharded_meta``.

Rows of cells the append never touches are bit-identical in every output,
which is what lets the refinement epochs run over the affected cells only.
The plan and every order in it (slots of appended rows, members of a
sub-cell, new cell ids, self edges of new rows) follow the JAX package, so
the two admit the same rows to the same slots. The split's k-means draws
from ``seeded_generator(device, seed + 7, N, cell)`` in place of the JAX
package's ``fold_in`` keys.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.index import kmeans as km
from repro_torch.index.ann import AnnIndex, data_fingerprint
from repro_torch.index.build import capacity_assign_device, chunked_cluster_knn, seeded_generator


@dataclasses.dataclass
class PartialUpdate:
    """What one admission pass produced (the index half of partial_fit)."""

    index: AnnIndex  # grown index (K' ≥ K cells, same capacity)
    theta_rows: np.ndarray  # (K'·C, out_dim) patched cluster-major θ
    affected_cells: np.ndarray  # (A,) sorted global ids of cells that changed
    n_split_cells: int  # overflowing cells that were re-seeded
    n_new_cells: int  # cells appended to the layout (K' - K)
    stage_s: Dict[str, float]  # {"admit": s, "patch_knn": s, "patch_rows": s}


def chained_fingerprint(parent_fp: str, new_x: np.ndarray) -> str:
    """Version fingerprint of an append: hash(parent fp ∥ fp(new rows)).
    Content-derived and order-sensitive, and never re-reads the corpus."""
    h = hashlib.sha256()
    h.update(parent_fp.encode())
    h.update(data_fingerprint(new_x).encode())
    return h.hexdigest()[:16]


def _split_fill_target(cfg: NomadConfig, capacity: int) -> int:
    # the build's average fill (C = slack·N/K ⇒ N/K = C/slack): re-seeded
    # sub-cells keep the same headroom for the next append
    return max(1, min(capacity, int(capacity / cfg.capacity_slack)))


def _read_rows(x_rows, lo: int, hi: int) -> np.ndarray:
    from repro_torch.data.store import is_store

    if is_store(x_rows):
        return np.asarray(x_rows.read(lo, hi), np.float32)
    return np.asarray(x_rows[lo:hi], np.float32)


def _patch_store_x_rows(old_store, changed: Dict[int, np.ndarray], K: int, K2: int, C: int, dim: int,
                        out_dir: str, cfg: NomadConfig):
    """Rewrite a store-backed ``x_rows`` into ``out_dir`` with the patch.

    Shards are ``g·C`` rows with ``g`` a divisor of K, so the appended
    region starts on a shard boundary: region ``[0, K·C)`` (unchanged
    blocks read from the old store, changed ones from RAM) and region
    ``[K·C, K'·C)`` (the new cells) are written as two
    ``write_sharded(commit=False)`` ranges and published by one
    ``commit_sharded_meta``.
    """
    from repro_torch.core.strategy import largest_divisor_leq
    from repro_torch.data.store import commit_sharded_meta, write_sharded

    g = largest_divisor_leq(K, max(1, 65536 // C))
    for d in (d for d in range(g, K + 1) if K % d == 0):  # coarsen until the shard count fits
        g = d
        if -(-K2 // g) <= max(1, cfg.store_max_shards):
            break
    rps = g * C

    def old_region():
        c = 0
        while c < K:
            if c in changed:
                yield changed[c]
                c += 1
            else:
                end = c + 1
                while end < K and end not in changed and (end - c) < g:
                    end += 1
                yield _read_rows(old_store, c * C, end * C)
                c = end

    common = dict(rows_per_shard=rps, dtype=cfg.store_dtype, total_rows=K2 * C, commit=False)
    write_sharded(old_region(), out_dir, row_offset=0, **common)
    if K2 > K:
        write_sharded((changed[c] for c in range(K, K2)), out_dir, row_offset=K * C, **common)
    return commit_sharded_meta(out_dir, K2 * C, dim, rows_per_shard=rps, dtype=cfg.store_dtype)


def admit_and_patch(index: AnnIndex, theta_rows: np.ndarray, new_x: np.ndarray, new_cells: np.ndarray,
                    new_theta: np.ndarray, cfg: NomadConfig, *, device,
                    spill_dir: Optional[str] = None) -> PartialUpdate:
    """Admit ``new_x`` (placed at ``new_cells`` with initial positions
    ``new_theta``) into ``index``, patching kNN, ``x_rows`` and θ for the
    affected cells only. The split k-means, the split assignment and the
    kNN patch run on ``device``.

    ``spill_dir`` is where a store-backed ``x_rows`` patch is written
    (required exactly when ``index.x_rows`` is a store). Rows of cells the
    append never touches are bit-identical in every output.
    """
    from repro_torch.data.store import is_store

    device = torch.device(device)
    t0 = time.time()
    K, C = index.n_clusters, index.capacity
    dim = int(index.x_rows.shape[1])
    N, M = index.n_points, int(new_x.shape[0])
    k = int(index.knn_idx.shape[1])
    out_dim = int(theta_rows.shape[1])
    counts = np.asarray(index.counts).astype(np.int64)
    new_cells = np.asarray(new_cells).astype(np.int64)
    new_x = np.ascontiguousarray(new_x, np.float32)
    new_theta = np.asarray(new_theta, np.float32)
    theta_full = np.asarray(theta_rows, np.float32)

    if new_cells.shape != (M,):
        raise ValueError(f"new_cells {new_cells.shape} must be ({M},)")
    if new_cells.size and (new_cells.min() < 0 or new_cells.max() >= K):
        raise ValueError("new_cells must index the previous layout's cells")

    inc = np.bincount(new_cells, minlength=K)
    split_cells = np.flatnonzero(counts + inc > C)
    split_set = set(split_cells.tolist())

    # the new rows of each target cell, in row order (np.flatnonzero's)
    order = np.argsort(new_cells, kind="stable")
    uniq, starts = np.unique(new_cells[order], return_index=True)
    incoming = dict(zip(uniq.tolist(), np.split(order, starts[1:])))

    # original point id per row of the OLD layout (for re-permuting splits)
    row_owner = np.full(K * C, -1, np.int64)
    row_owner[np.asarray(index.perm)] = np.arange(N)

    # ---- plan: appends into free slots vs full cell re-seeds --------------
    appends = {c: j for c, j in incoming.items() if c not in split_set}
    rewrites: Dict[int, tuple] = {}  # cell -> (orig ids slot-ordered, x block, θ block)
    new_centroids: Dict[int, np.ndarray] = {}
    next_cell = K
    fill = _split_fill_target(cfg, C)
    for c in split_cells.tolist():
        cnt = int(counts[c])
        j_new = incoming[c]
        mem_x = np.concatenate([_read_rows(index.x_rows, c * C, c * C + cnt), new_x[j_new]], axis=0)
        mem_ids = np.concatenate([row_owner[c * C : c * C + cnt], N + j_new])
        mem_th = np.concatenate([theta_full[c * C : c * C + cnt], new_theta[j_new]], axis=0)
        n_sub = max(2, -(-mem_x.shape[0] // fill))
        cents = km.kmeans_centroids(
            seeded_generator(device, cfg.seed + 7, N, c),
            torch.from_numpy(mem_x).to(device),
            n_sub,
            n_iters=cfg.kmeans_iters,
            tol=cfg.kmeans_tol,
        ).cpu().numpy()
        sub = capacity_assign_device(
            mem_x, cents, C, device=device, max_rounds=cfg.build_max_rounds,
            n_cand=min(cfg.build_candidates, n_sub),
        )
        # non-empty sub-cells only; the first keeps the cell's id so every
        # other cell's global row numbering survives the split
        members = [m for m in (np.flatnonzero(sub == s) for s in range(n_sub)) if m.size]
        for s_i, m in enumerate(members):
            cell_id = c if s_i == 0 else next_cell
            if s_i > 0:
                next_cell += 1
            xb = np.zeros((C, dim), np.float32)
            xb[: m.size] = mem_x[m]
            tb = np.zeros((C, out_dim), np.float32)
            tb[: m.size] = mem_th[m]
            rewrites[cell_id] = (mem_ids[m], xb, tb)
            new_centroids[cell_id] = mem_x[m].mean(axis=0, dtype=np.float64).astype(np.float32)

    K2 = next_cell

    # ---- assemble the grown layout ----------------------------------------
    counts2 = np.zeros((K2,), counts.dtype)
    counts2[:K] = counts
    centroids2 = np.zeros((K2, dim), np.float32)
    centroids2[:K] = np.asarray(index.centroids, np.float32)
    perm2 = np.zeros((N + M,), np.int64)
    perm2[:N] = np.asarray(index.perm)
    theta2 = np.zeros((K2 * C, out_dim), np.float32)
    theta2[: K * C] = theta_full

    # blocks whose content changes: the affected cells, for both x_rows
    # paths and the kNN patch
    changed: Dict[int, np.ndarray] = {}
    for c, (ids, xb, tb) in rewrites.items():
        counts2[c] = ids.size
        centroids2[c] = new_centroids[c]
        perm2[ids] = c * C + np.arange(ids.size)
        theta2[c * C : (c + 1) * C] = tb
        changed[c] = xb
    for c, j_list in appends.items():
        base = int(counts[c])
        xb = np.zeros((C, dim), np.float32)
        xb[:base] = _read_rows(index.x_rows, c * C, c * C + base)
        xb[base : base + j_list.size] = new_x[j_list]
        changed[c] = xb
        rows = c * C + base + np.arange(j_list.size)
        perm2[N + j_list] = rows
        theta2[rows] = new_theta[j_list]
        counts2[c] = base + j_list.size
        # the centroid stays frozen: other cells' placements were computed
        # against it
    stage_admit = time.time() - t0

    # ---- kNN patch: recompute only the affected cells' blocks -------------
    t1 = time.time()
    affected = np.array(sorted(changed), np.int64)
    knn_idx2 = np.zeros((K2 * C, k), np.asarray(index.knn_idx).dtype)
    knn_idx2[: K * C] = index.knn_idx
    knn_idx2[K * C :] = np.arange(K * C, K2 * C)[:, None]  # self = dead edge
    knn_w2 = np.zeros((K2 * C, k), np.float32)
    knn_w2[: K * C] = index.knn_w
    if affected.size:
        knn_local, knn_w_aff = chunked_cluster_knn([changed[int(c)] for c in affected], counts2[affected], k,
                                                  device)
        base_rows = (affected * C)[:, None, None]
        self_rows = base_rows + np.arange(C)[None, :, None]
        knn_glob = np.where(knn_w_aff > 0, knn_local.astype(np.int64) + base_rows, self_rows)
        flat_rows = (affected[:, None] * C + np.arange(C)[None, :]).reshape(-1)
        knn_idx2[flat_rows] = knn_glob.reshape(-1, k)
        knn_w2[flat_rows] = knn_w_aff.reshape(-1, k)
    stage_knn = time.time() - t1

    # ---- x_rows patch -----------------------------------------------------
    t2 = time.time()
    if is_store(index.x_rows):
        if not spill_dir:
            raise ValueError(
                "admit_and_patch: index.x_rows is store-backed — pass spill_dir= for the patched store"
            )
        x_rows2 = _patch_store_x_rows(index.x_rows, changed, K, K2, C, dim, spill_dir, cfg)
    else:
        x_rows2 = np.zeros((K2 * C, dim), np.asarray(index.x_rows).dtype)
        x_rows2[: K * C] = index.x_rows
        for c, xb in changed.items():
            x_rows2[c * C : (c + 1) * C] = xb
    stage_rows = time.time() - t2

    grown = AnnIndex(
        x_rows=x_rows2,
        knn_idx=knn_idx2,
        knn_w=knn_w2,
        counts=counts2,
        centroids=centroids2,
        perm=perm2,
        capacity=C,
        n_points=N + M,
        fingerprint=chained_fingerprint(index.fingerprint, new_x),
    )
    return PartialUpdate(
        index=grown,
        theta_rows=theta2,
        affected_cells=affected,
        n_split_cells=int(split_cells.size),
        n_new_cells=K2 - K,
        stage_s={"admit": stage_admit, "patch_knn": stage_knn, "patch_rows": stage_rows},
    )
