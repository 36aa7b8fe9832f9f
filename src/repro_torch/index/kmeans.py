"""LSH-initialised K-means (paper §3.2).

Every E-step goes through :func:`blocked_assign`, which runs the
``kmeans_assign`` registry kernel (the fused CUDA E-step on the card, its
plain version on the CPU) one row block at a time, so a live (block, K)
matrix exists only on the CPU path. EM is a Python loop with the JAX
scan's freeze-on-converge rule: once the largest centroid shift drops
under ``tol`` the *pre-update* centroids are kept. The M-step sums rows
with ``index_put_(accumulate=True)``, which on CUDA sorts the indices and
adds duplicates in a fixed order, so EM repeats bit for bit on the card.
Each full pass over the rows (the LSH seeding, every E-step, the one that
converges included) adds one to the counter ``kmeans.passes``
(:mod:`repro_torch.core.trace`).

:func:`kmeans_centroids_streamed` runs the same LSH init and EM over an
on-disk store, one chunk at a time (the streamed build's kmeans stage).
:func:`kmeans_fit` is the front door that also returns the assignment;
:func:`capacity_assign` is the JAX package's host oracle of the
capacity-bounded assignment, in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import trace
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
    trace.count("kmeans.passes")
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
        trace.count("kmeans.passes")
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


def kmeans_fit(
    seed_or_generator,
    x,
    n_clusters: int,
    n_iters: int = 25,
    tol: float = 1e-4,
    *,
    block: int = 16384,
    device=None,
):
    """Lloyd's EM from LSH init. Returns ``(centroids (K, D) float32,
    assign (N,) int32, counts (K,) float32)`` on ``device`` (the card
    unless the caller asks for the CPU).

    ``seed_or_generator`` is an int (seeded as the index build seeds its
    k-means) or a ``torch.Generator`` on ``device``; ``x`` an (N, D) array
    or tensor. EM is :func:`em_loop`, every E-step through the
    ``kmeans_assign`` kernel. The returned assignment is always the
    nearest-centroid assignment of the returned centroids (one more E-step
    on them) and ``counts`` its bincount, as the JAX package's alignment
    rule gives them.
    """
    from repro_torch.core.runtime import resolve_device
    from repro_torch.index.build import seeded_generator

    device = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = seeded_generator(device, int(gen))
    xd = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, np.float32)).to(device)
    blk = min(block, xd.shape[0])
    cents = em_loop(xd, lsh_init_centroids(gen, xd, n_clusters), n_clusters, n_iters, tol, blk)
    assign, _ = blocked_assign(xd, cents, blk)
    counts = torch.bincount(assign.long(), minlength=n_clusters).float()
    return cents, assign, counts


def kmeans_fit_sharded(gen: torch.Generator, x_local, n_clusters: int, mesh, n_iters: int = 25, tol: float = 0.0,
                       *, block: int = 16384, n_real: Optional[int] = None) -> torch.Tensor:
    """Distributed EM: rows sharded over the flat ``mesh`` of shard slots,
    one (K, D+1) partial-sum exchange a pass.

    ``x_local`` holds this process's slots' row blocks (equal lengths,
    slot i the global rows [i·len, (i+1)·len), on the slots' devices);
    rows from ``n_real`` on are padding and enter no statistic. The LSH
    init sums its buckets the same way, draws its planes and fallback rows
    from ``gen`` in the resident init's order, and takes each fallback row
    from the slot that holds it. Partials are all-gathered and added in
    slot order, so the centroids (replicated, on ``gen``'s device) do not
    depend on how processes hold the slots, and one slot reproduces
    :func:`kmeans_centroids` bit for bit. Convergence keeps the pre-update
    centroids, as :func:`em_loop` does."""
    local = mesh.local_indices()
    rows_per, d = x_local[0].shape
    n = rows_per * mesh.size if n_real is None else n_real
    real = [xl[: max(0, min(rows_per, n - i * rows_per))] for i, xl in zip(local, x_local)]
    home = gen.device

    def exchange(parts):  # (R, D+1) partials of the local slots → Σ over all slots, in slot order
        tot = None
        for p in mesh.all_gather(parts):
            tot = p.to(home) if tot is None else tot + p.to(home)
        return tot[:, :d], tot[:, d]

    def stats(n_out, index, xr):
        ones = torch.ones((xr.shape[0],), device=xr.device)
        return torch.cat([scatter_sum(n_out, index, xr.float()), scatter_sum(n_out, index, ones)[:, None]], 1)

    trace.count("kmeans.passes")
    planes = lsh_planes(gen, d, n_clusters, home)
    n_buckets = 2 ** planes.shape[1]
    sums, cnts = exchange([stats(n_buckets, lsh_codes(xr, planes.to(xr.device)), xr) for xr in real])
    fb = torch.randint(0, n, (n_clusters,), generator=gen, device=home)
    parts = []
    for i, xr in zip(local, real):
        at = fb.to(xr.device) - i * rows_per
        own = (at >= 0) & (at < xr.shape[0])
        rows = xr[at.clamp(0, max(xr.shape[0] - 1, 0))].float() if xr.shape[0] else torch.zeros(
            (n_clusters, d), device=xr.device)
        parts.append(torch.cat([rows, own[:, None].float()], 1))
    fallback = None
    for p in mesh.all_gather(parts):  # each fallback row from the slot that holds it
        p = p.to(home)
        fallback = p[:, :d] if fallback is None else torch.where(p[:, d:] > 0, p[:, :d], fallback)
    cents = bucket_centroids(sums, cnts, n_clusters, fallback)

    blk = max(1, min(block, rows_per))
    for _ in range(n_iters):
        trace.count("kmeans.passes")
        parts = []
        for xr in real:
            a, _ = blocked_assign(xr, cents.to(xr.device), blk) if xr.shape[0] else (
                torch.zeros((0,), dtype=torch.int32, device=xr.device), None)
            parts.append(stats(n_clusters, a, xr))
        sums, cnts = exchange(parts)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        new = torch.where((cnts > 0)[:, None], new, cents)
        if bool(torch.max(torch.sum(torch.square(new - cents), -1)) < tol):
            break  # freeze-on-converge: keep the pre-update centroids
        cents = new
    return cents


def capacity_assign(
    dist2_fn,
    x: np.ndarray,
    cents: np.ndarray,
    capacity: int,
    max_rounds: int = 12,
) -> np.ndarray:
    """Capacity-bounded nearest-centroid assignment, the JAX package's
    host oracle in numpy (the build runs
    :func:`repro_torch.index.build.capacity_assign_device`).

    Greedy rounds: each unassigned point bids for its nearest centroid
    with free capacity; each centroid admits its ``capacity`` closest
    bidders (stable order among equal distances). A rejected bidder's
    centroid is full from that round on, so the ``free <= 0`` mask covers
    every cluster it may not bid for again. After ``max_rounds`` the
    stragglers go, in row order, to their nearest centroid with space.
    ``dist2_fn(a, b)`` gives the (len(a), len(b)) squared distances.
    """
    n = x.shape[0]
    K = cents.shape[0]
    assign = np.full(n, -1, np.int64)
    free = np.full(K, capacity, np.int64)

    for _ in range(max_rounds):
        todo = np.flatnonzero(assign < 0)
        if todo.size == 0:
            return assign
        d2 = dist2_fn(x[todo], cents)  # (T, K)
        d2 = np.where(free[None, :] <= 0, np.inf, d2)
        pick = np.argmin(d2, 1)
        for c in range(K):
            if free[c] <= 0:
                continue
            bidders = todo[pick == c]
            if bidders.size == 0:
                continue
            if bidders.size > free[c]:
                order = np.argsort(d2[pick == c, c], kind="stable")
                admitted = bidders[order[: free[c]]]
            else:
                admitted = bidders
            assign[admitted] = c
            free[c] -= admitted.size
    todo = np.flatnonzero(assign < 0)
    if todo.size:
        d2 = dist2_fn(x[todo], cents)
        order = np.argsort(d2, axis=1)
        for t, row in zip(todo, order):
            for c in row:
                if free[c] > 0:
                    assign[t] = c
                    free[c] -= 1
                    break
    if (assign < 0).any():
        raise RuntimeError("capacity_assign: total capacity < N")
    return assign


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
        trace.count("kmeans.passes")
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
        trace.count("kmeans.passes")
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
