"""LSH-initialised K-means (paper §3.2).

Every E-step goes through :func:`blocked_assign`, which runs the
``kmeans_assign`` registry kernel (the fused CUDA E-step on the card, its
plain version on the CPU) one row block at a time, so a live (block, K)
matrix exists only on the CPU path. EM is a Python loop with the JAX
scan's freeze-on-converge rule: once the largest centroid shift drops
under ``tol`` the *pre-update* centroids are kept. The M-step sums rows
with ``index_put_(accumulate=True)``, which on CUDA sorts the indices and
adds duplicates in a fixed order, so EM repeats bit for bit on the card.

:func:`kmeans_centroids_streamed` runs the same LSH init and EM over an
on-disk store, one chunk at a time (the streamed build's kmeans stage).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.data.store import stream_chunks
from repro_torch.kernels.kmeans_assign.ops import assign_nearest


def scatter_sum(n_out: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ values[index == i], deterministic on every device."""
    out = torch.zeros((n_out,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_put_((index.long(),), values, accumulate=True)


def lsh_planes(gen: torch.Generator, d: int, n_clusters: int, device) -> torch.Tensor:
    """b = ceil(log2 K) random hyperplanes (d, b): the LSH init's first draw."""
    b = max(1, int(np.ceil(np.log2(n_clusters))))
    return torch.randn((d, b), generator=gen, device=device)


def lsh_codes(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Each row's bucket: the bits of which side of each hyperplane it is on."""
    b = planes.shape[1]
    bits = (x.float() @ planes) > 0  # (n, b)
    return torch.sum(bits * (2 ** torch.arange(b, device=x.device))[None, :], 1)


def lsh_init_centroids(
    gen: torch.Generator, x: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    """Random-hyperplane LSH buckets → bucket means as initial centroids.

    b = ceil(log2 K) hyperplanes give 2^b ≥ K buckets; the K most populated
    buckets seed the centroids; empty seats fall back to random points.
    """
    n, d = x.shape
    planes = lsh_planes(gen, d, n_clusters, x.device)
    codes = lsh_codes(x, planes)
    n_buckets = 2 ** planes.shape[1]
    sums = scatter_sum(n_buckets, codes, x.float())
    cnts = scatter_sum(n_buckets, codes, torch.ones((n,), device=x.device))
    fallback = x[torch.randint(0, n, (n_clusters,), generator=gen, device=x.device)].float()
    return bucket_centroids(sums, cnts, n_clusters, fallback)


def bucket_centroids(sums, cnts, n_clusters: int, fallback) -> torch.Tensor:
    """The K most populated buckets' means (stable order among equal
    counts); empty seats take the ``fallback`` rows."""
    order = torch.argsort(-cnts, stable=True)  # most populated first
    top = order[:n_clusters]
    cents = sums[top] / torch.clamp_min(cnts[top], 1.0)[:, None]
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


# ---------------------------------------------------------------------------
# Streamed (out-of-core) EM
# ---------------------------------------------------------------------------


def pad_chunk(chunk: np.ndarray, chunk_rows: int):
    """Pad a (possibly ragged) host chunk to exactly ``chunk_rows`` rows and
    return its validity weights: every streamed chunk has one shape, and
    padding never enters a statistic."""
    c = chunk.shape[0]
    w = np.zeros((chunk_rows,), np.float32)
    w[:c] = 1.0
    if c < chunk_rows:
        chunk = np.concatenate([chunk, np.zeros((chunk_rows - c, chunk.shape[1]), chunk.dtype)])
    return chunk, w


def chunk_to_device(chunk: np.ndarray, device) -> torch.Tensor:
    """Rows from :meth:`~repro_torch.data.store.EmbeddingStore.read_encoded`
    → float32 on ``device``. bfloat16 bits cross as they are stored (half
    the bytes) and widen there, exactly as the host's decode would."""
    chunk = np.require(chunk, None, ["C", "W"])  # a read-only memmap view is copied
    if chunk.dtype == np.uint16:  # bfloat16 bits
        return torch.from_numpy(chunk.view(np.int16)).to(device).view(torch.bfloat16).float()
    return torch.from_numpy(chunk).to(device)


def device_chunks(store, chunk_rows: int, device):
    """One prefetched pass over ``store`` on ``device``: ``(start, xb, w)``
    with xb (chunk_rows, D) float32, the last chunk zero-padded, and w the
    rows' validity weights."""
    for s, chunk in stream_chunks(store, chunk_rows, encoded=True):
        xb, w = pad_chunk(chunk, chunk_rows)
        yield s, chunk_to_device(xb, device), torch.from_numpy(w).to(device)


def kmeans_centroids_streamed(
    gen: torch.Generator,
    store,
    n_clusters: int,
    *,
    chunk_rows: int,
    n_iters: int = 25,
    tol: float = 1e-4,
    block: int = 16384,
    device=None,
    cents0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Centroids-only EM over a :class:`repro_torch.data.store.EmbeddingStore`,
    the streamed twin of :func:`kmeans_centroids`.

    Each pass streams the store in ``chunk_rows``-row chunks
    (:func:`repro_torch.data.store.stream_chunks`, reads double-buffered);
    per chunk the ``kmeans_assign`` kernel runs the E-step and the (K, D+1)
    statistics accumulate on the device with ``index_put_(accumulate=True)``
    in chunk order, so host memory is O(chunk · D). The LSH init draws its
    planes and fallback rows from ``gen`` in the resident init's order and
    reads the fallback rows with ``read_rows``. Convergence keeps the
    *pre-update* centroids, as :func:`em_loop` does; the one host sync is
    the shift of each pass. Chunk boundaries depend only on (N,
    chunk_rows), so any two stores holding the same rows give the same
    centroids. ``cents0`` replaces the LSH init (the tests start both
    packages from the same centroids).
    """
    n, d = store.shape
    chunk_rows = max(1, min(chunk_rows, n))
    blk = max(1, min(block, chunk_rows))

    def chunks():
        return device_chunks(store, chunk_rows, device)

    if cents0 is None:
        planes = lsh_planes(gen, d, n_clusters, device)
        n_buckets = 2 ** planes.shape[1]
        sums = torch.zeros((n_buckets, d), dtype=torch.float32, device=device)
        cnts = torch.zeros((n_buckets,), dtype=torch.float32, device=device)
        for _s, xb, w in chunks():
            codes = lsh_codes(xb, planes)
            sums.index_put_((codes,), xb * w[:, None], accumulate=True)
            cnts.index_put_((codes,), w, accumulate=True)
        fb_rows = torch.randint(0, n, (n_clusters,), generator=gen, device=device).cpu().numpy()
        fallback = torch.from_numpy(store.read_rows(fb_rows)).to(device)
        cents0 = bucket_centroids(sums, cnts, n_clusters, fallback)

    cents = cents0.float()
    for _ in range(n_iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=device)
        cnts = torch.zeros((n_clusters,), dtype=torch.float32, device=device)
        for _s, xb, w in chunks():
            a, _ = blocked_assign(xb, cents, blk)
            sums.index_put_((a.long(),), xb * w[:, None], accumulate=True)
            cnts.index_put_((a.long(),), w, accumulate=True)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        new = torch.where((cnts > 0)[:, None], new, cents)
        if float(torch.max(torch.sum(torch.square(new - cents), -1))) < tol:
            break  # freeze-on-converge: keep the pre-update centroids
        cents = new
    return cents
