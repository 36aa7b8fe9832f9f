"""The index build (paper §3.2): on one device, streamed, or sharded over
a mesh of shard slots.

:class:`IndexBuilder` runs the JAX package's pipeline stage by stage:

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

A store input (:mod:`repro_torch.data.store`) or ``cfg.chunk_rows > 0``
selects the streamed build (:meth:`IndexBuilder._build_streamed`): the same
stages over ``cfg.resolved_chunk_rows()``-row chunks of the corpus, which
never lands whole in host or device memory. Chunk boundaries depend only on
(N, chunk_rows), so a store and an array holding the same rows build
bit-identical indices.

``build_strategy`` "sharded" (:meth:`IndexBuilder._build_slots`) runs the
same stages over a flat mesh of shard slots (``launch/mesh.py``): rows
sharded contiguously, k-means with one (K, D+1) partial-sum exchange a
pass (``kmeans.kmeans_fit_sharded``), each slot's candidate pass through
``pairwise`` and one exchange of the bids a round, and each slot's in-cell
kNN of its own contiguous cells. "distributed" is the same program over
every process of a ``torch.distributed`` run, each reading only its own
slots' rows of a store; with one process it is the sharded build bit for
bit, and one slot is the local build bit for bit.

Devices: :class:`IndexBuilder` runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.core import trace
from repro_torch.core.runtime import process_count, process_index, resolve_device
from repro_torch.core.strategy import largest_divisor_leq, sync_processes
from repro_torch.index import kmeans as km
from repro_torch.index.ann import AnnIndex, data_fingerprint
from repro_torch.index.knn import batched_cluster_knn, smallest_k_by_sort
from repro_torch.kernels.capacity_admit.ops import capacity_admit
from repro_torch.kernels.pairwise.ops import pairwise_dist2
from repro_torch.launch.mesh import devices, flat_mesh

KNN_CELL_CHUNK = 256  # cells per batched in-cell kNN launch
BUILD_AXIS = "build"
BUILD_STRATEGIES = ("auto", "local", "sharded", "distributed")


def generator_seed(*key: int) -> int:
    """The seed :func:`seeded_generator` gives its generator for ``key``:
    a CUDA graph's registered generator, seeded with it before a replay,
    draws what the fresh generator draws."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    return (int(seed[0]) << 31) ^ int(seed[1])


def seeded_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers (the
    port's stand-in for ``jax.random.fold_in`` keying)."""
    return torch.Generator(device=device).manual_seed(generator_seed(*key))


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


def streamed_candidates(store, cents: torch.Tensor, n_cand: int, chunk: int, block: int):
    """:func:`candidate_pass` over a store, chunk by chunk, into a
    device-resident (N_pad, R) cache, N_pad the row count rounded up to
    whole chunks. The padding rows' entries are the padded chunk's; the
    bidding rounds leave them out (``capacity_rounds(n_real=N)``)."""
    n = store.shape[0]
    r = min(n_cand, cents.shape[0])
    n_pad = -(-n // chunk) * chunk
    cand_idx = torch.zeros((n_pad, r), dtype=torch.int32, device=cents.device)
    cand_d2 = torch.full((n_pad, r), float("inf"), dtype=torch.float32, device=cents.device)
    for s, xb, _w in km.device_chunks(store, chunk, cents.device):
        cand_idx[s : s + chunk], cand_d2[s : s + chunk] = candidate_pass(xb, cents, n_cand, block)
    return cand_idx, cand_d2


def bid_from_candidates(cand_idx, cand_d2, free):
    """Each row's nearest centroid with free capacity (the first free
    candidate); rows whose every candidate is full (``has`` False) sit out."""
    ok = free[cand_idx.long()] > 0  # (N, R)
    has = torch.any(ok, 1)
    j = torch.argmax(ok.to(torch.uint8), 1)  # first free candidate
    rows = torch.arange(cand_idx.shape[0], device=cand_idx.device)
    return cand_idx[rows, j], cand_d2[rows, j], has


def capacity_rounds(cand_idx, cand_d2, n_clusters: int, capacity: int, max_rounds: int,
                    n_real: Optional[int] = None):
    """Bidding rounds over cached candidates → (assign (N,) int32, -1 for
    stragglers; free (K,) int32). Every round with bidders admits at least
    one, and the loop stops once no row can bid. Rows from ``n_real`` on
    are chunk padding of the streamed cache and never bid."""
    return bidding_rounds(lambda free: bid_from_candidates(cand_idx, cand_d2, free), cand_idx.shape[0],
                          n_clusters, capacity, max_rounds, cand_idx.device, n_real)


def bidding_rounds(bid, n: int, n_clusters: int, capacity: int, max_rounds: int, device,
                   n_real: Optional[int] = None):
    """The rounds of :func:`capacity_rounds` with the bids of all ``n``
    rows from ``bid(free) -> (pick, d2, has)``: the rows' own candidates,
    or every slot's gathered (:meth:`IndexBuilder._build_slots`)."""
    assign = torch.full((n,), -1, dtype=torch.int32, device=device)
    free = torch.full((n_clusters,), capacity, dtype=torch.int32, device=device)
    real = torch.arange(n, device=device) < (n if n_real is None else n_real)
    for _ in range(max_rounds):
        if not bool(torch.any((assign < 0) & real)):
            break
        pick, d2, has = bid(free)
        bidding = (assign < 0) & real & has
        if not bool(torch.any(bidding)):
            break
        admitted = capacity_admit(pick, d2, bidding, free)
        assign = torch.where(admitted, pick, assign)
        free = free - torch.bincount(pick[admitted].long(), minlength=n_clusters).to(torch.int32)
    return assign, free


def force_place_host(x, cents: np.ndarray, assign: np.ndarray, free: np.ndarray, chunk: int = 8192):
    """Place stragglers (rows unassigned after the rounds) into their
    nearest centroid with space, on the host, chunked to a (chunk, K)
    distance block. ``x`` is an array or a store (rows read with
    ``read_rows``: one sorted gather a block)."""
    from repro_torch.data.store import is_store

    todo = np.flatnonzero(assign < 0)
    if todo.size == 0:
        return assign, 0
    c = cents.astype(np.float32)
    for s in range(0, todo.size, chunk):
        block = todo[s : s + chunk]
        a = x.read_rows(block) if is_store(x) else x[block].astype(np.float32)
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


def capacity_assign_device(x: np.ndarray, cents: np.ndarray, capacity: int, *, device, block: int = 16384,
                           max_rounds: int = 16, n_cand: int = 32) -> np.ndarray:
    """Capacity-bounded assignment of host rows ``x`` to ``cents`` in one
    call (the JAX package's ``capacity_assign_device``): the candidate pass
    and the bidding rounds on ``device``, then the host straggler pass.
    Unassigned rows bid for their nearest centroid with free capacity; each
    centroid admits its ``free`` closest bidders, ties to the lower row.
    Returns ``assign`` (N,) int64."""
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    cd = torch.from_numpy(np.ascontiguousarray(cents, np.float32)).to(device)
    cand_idx, cand_d2 = candidate_pass(xd, cd, n_cand, block)
    assign, free = capacity_rounds(cand_idx, cand_d2, cd.shape[0], capacity, max_rounds)
    assign, _ = force_place_host(
        np.asarray(x), np.asarray(cents), assign.cpu().numpy().astype(np.int64), free.cpu().numpy().copy()
    )
    return assign


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


def chunked_cluster_knn(x_blocks, counts: np.ndarray, k: int, device: torch.device,
                        cells_per_launch: int = KNN_CELL_CHUNK):
    """In-cell kNN of a sliceable sequence of (C, D) cell blocks (a
    (K, C, D) array or a list of blocks) with host ``counts`` real rows
    each, ``cells_per_launch`` cells a batched launch, so the gathered
    blocks and their (cells, C, C) distances never exist for every cell at
    once. Each cell's result does not depend on the cells batched with it.
    Returns (knn_local (A, C, k) int32 in-cell slots, weights (A, C, k))."""
    C = x_blocks[0].shape[0]
    slots = torch.arange(C, device=device)
    cnt = torch.as_tensor(np.asarray(counts), dtype=torch.int64, device=device)
    idx, w = [], []
    for a0 in range(0, len(x_blocks), cells_per_launch):
        part = np.ascontiguousarray(x_blocks[a0 : a0 + cells_per_launch])
        xb = torch.from_numpy(part).to(device).float()
        valid = slots[None, :] < cnt[a0 : a0 + part.shape[0], None]
        i, ww = batched_cluster_knn(xb, valid, k)
        idx.append(i.cpu().numpy())
        w.append(ww.cpu().numpy())
    return np.concatenate(idx), np.concatenate(w)


# ---------------------------------------------------------------------------
# Streamed (out-of-core) stages
# ---------------------------------------------------------------------------


def resolve_spill_dir(cfg: NomadConfig, store) -> str:
    """Where a streamed build spills the cluster-major ``x_rows`` store.

    ``cfg.checkpoint_dir/x_rows_spill-<tag>`` when the fit owns a
    checkpoint directory, else a sibling of the input store
    (``<path>.x_rows-<tag>``). The tag hashes the whole config and the
    store's path, so a refit with the same config overwrites its own spill
    (whose bytes it reproduces) while another config gets its own directory
    and never corrupts the ``x_rows`` a live index reads. Only when neither
    place is writable does it fall back to a fresh temporary directory.
    """
    import hashlib
    import tempfile

    tag = hashlib.sha256(
        (repr(sorted(dataclasses.asdict(cfg).items())) + str(store.path)).encode()
    ).hexdigest()[:8]
    candidates = []
    if cfg.checkpoint_dir:
        candidates.append(os.path.join(cfg.checkpoint_dir, "x_rows_spill-" + tag))
    if store.path:
        candidates.append(str(store.path).rstrip("/\\") + ".x_rows-" + tag)
    for cand in candidates:
        try:
            os.makedirs(cand, exist_ok=True)
            probe = os.path.join(cand, f".write-probe-{os.getpid()}")
            with open(probe, "w"):
                pass
            os.remove(probe)
            return cand
        except OSError:
            continue
    return tempfile.mkdtemp(prefix="repro-torch-x-rows-")


def spill_sharded_scatter(store, perm: np.ndarray, n_rows: int, dim: int, out_dir: str, dtype: str,
                          chunk_rows: int, rows_per_shard: int = 65536, max_shards: int = 256):
    """Stream the input store once and scatter ``row i → perm[i]`` into a
    sharded on-disk store of ``n_rows`` rows in ``dtype``: the cluster-major
    ``x_rows`` without holding it (or the input) in host RAM. The shard
    files are created first; each chunk's rows are grouped by destination
    shard and written with one fancy-indexed slice through a memmap of that
    shard, unmapped right after, so the written pages leave this process's
    resident set for the page cache. ``max_shards`` caps the shard count
    (shards grow instead)."""
    from repro_torch.data.store import (
        SHARD_PATTERN,
        ShardedStore,
        _commit_meta,
        _disk_dtype,
        _encode,
        bf16_decode,
        stream_chunks,
    )

    os.makedirs(out_dir, exist_ok=True)
    rows_per_shard = max(rows_per_shard, -(-n_rows // max_shards))
    rows_per_shard = max(1, min(rows_per_shard, n_rows))
    n_shards = -(-n_rows // rows_per_shard)
    shard_rows = [min(rows_per_shard, n_rows - j * rows_per_shard) for j in range(n_shards)]
    starts = np.concatenate([[0], np.cumsum(shard_rows)])
    files = [SHARD_PATTERN.format(j) for j in range(n_shards)]
    paths = [os.path.join(out_dir, name) for name in files]
    for path, rows in zip(paths, shard_rows):  # zero-filled (sparse) shard files
        np.lib.format.open_memmap(path, mode="w+", dtype=_disk_dtype(dtype), shape=(rows, dim))
    for s, chunk in stream_chunks(store, chunk_rows, encoded=True):
        targets = perm[s : s + chunk.shape[0]]
        order = np.argsort(targets, kind="stable")
        t_sorted = targets[order]
        if chunk.dtype == np.uint16:  # bfloat16 bits: copied as they are into a bf16 spill
            chunk = chunk if dtype == "bfloat16" else bf16_decode(chunk)
        enc = (chunk if chunk.dtype == np.uint16 else _encode(chunk, dtype))[order]
        bounds = np.searchsorted(t_sorted, starts)
        for j in range(n_shards):
            lo, hi = bounds[j], bounds[j + 1]
            if lo < hi:
                mm = np.lib.format.open_memmap(paths[j], mode="r+")
                mm[t_sorted[lo:hi] - starts[j]] = enc[lo:hi]
                del mm
    _commit_meta(out_dir, n_rows, dim, dtype, files, shard_rows)
    return ShardedStore(out_dir)


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
    # the process's peak host RSS (MB) at the end of each stage
    stage_rss_mb: dict = dataclasses.field(default_factory=dict)
    # full passes of k-means over the rows: the LSH seeding and every E-step
    kmeans_passes: int = 0
    # host seconds the build waited on the chunk reader (``stream_chunks``)
    read_wait_s: float = 0.0


def resolve_build_strategy(spec: Optional[str], cfg: NomadConfig, mesh=None, device=None):
    """``"auto" | "local" | "sharded" | "distributed"`` → ("local", None) or
    ("sharded" | "distributed", a flat mesh of slots).

    The build mesh is one flat axis over the widest cluster-divisible
    prefix of the slots: ``mesh``'s (the estimator's training mesh), else
    the global pool on ``device``. ``"auto"`` builds sharded exactly when
    that mesh holds more than one slot. Under several processes every slot
    must join the ``"distributed"`` mesh, so ``n_clusters`` must divide
    the global slot count."""
    spec = spec or "auto"
    if spec not in BUILD_STRATEGIES:
        raise ValueError(f"unknown build_strategy {spec!r} (want 'auto'|'local'|'sharded'|'distributed')")
    if spec == "local":
        return "local", None
    devs = mesh.slots if mesh is not None else devices(device)
    width = largest_divisor_leq(cfg.n_clusters, len(devs))
    if spec == "distributed":
        if process_count() > 1 and width != len(devs):
            raise ValueError(
                f"build_strategy='distributed': n_clusters={cfg.n_clusters} must be divisible by the "
                f"global slot count {len(devs)} ({process_count()} processes): every process's slots "
                "must join the build mesh"
            )
        return "distributed", flat_mesh(BUILD_AXIS, devs[:width])
    if spec == "auto" and width == 1:
        return "local", None
    return "sharded", flat_mesh(BUILD_AXIS, devs[:width])


class IndexBuilder:
    """Builds the §3.2 :class:`AnnIndex` on one device or over shard slots.

    ``strategy`` (default ``cfg.build_strategy``) is "auto", "local",
    "sharded" or "distributed"; ``mesh`` (the estimator's training mesh)
    supplies the slots, else the global pool on ``device``. ``device``
    defaults to the first CUDA device (raising without one); pass
    ``device="cpu"`` for the plain path. ``build`` takes an array, or a
    store for the streamed (or distributed) build. After it the per-stage
    wall times (synchronised with the device) and peak host RSS sit in
    :attr:`report`.
    """

    def __init__(self, cfg: NomadConfig, *, strategy: Optional[str] = None, mesh=None, device=None):
        self.cfg = cfg
        self.spec = strategy if strategy is not None else cfg.build_strategy
        if self.spec not in BUILD_STRATEGIES:
            raise ValueError(f"unknown build_strategy {self.spec!r} (want 'auto'|'local'|'sharded'|'distributed')")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.report: Optional[BuildReport] = None

    def build(self, x) -> AnnIndex:
        """Build the index of ``x``: an (N, D) float32 array, or any
        :class:`repro_torch.data.store.EmbeddingStore`. A store, or
        ``cfg.chunk_rows > 0``, takes the streamed build, unless the build
        is "distributed" (or runs under several processes), whose slots
        read their own rows of the store."""
        from repro_torch.data.store import as_store, is_store

        cfg, device = self.cfg, self.device
        n = x.shape[0]
        K, C = cfg.n_clusters, cfg.cluster_capacity
        if K * C < n:
            raise ValueError(f"capacity {C}×{K} < N={n}; raise capacity_slack")
        if self.spec == "distributed" or process_count() > 1:
            name, mesh = resolve_build_strategy("distributed", cfg, self.mesh, device)
        elif is_store(x) or cfg.chunk_rows > 0:
            name, mesh = "streamed", None
        else:
            name, mesh = resolve_build_strategy(self.spec, cfg, self.mesh, device)
        stage_s: dict = {}
        stage_rss: dict = {}
        stage = functools.partial(trace.stage, "build", stage_s=stage_s, device=device, stage_rss=stage_rss)
        before = trace.counts()
        t0 = time.perf_counter()
        if name == "streamed":
            index, stragglers = self._build_streamed(as_store(x), stage)
        elif name == "local":
            index, stragglers = self._build_local(x, stage)
        else:
            index, stragglers = self._build_slots(as_store(x) if name == "distributed" else x, mesh, stage,
                                                  distributed=name == "distributed")
        total_s = time.perf_counter() - t0
        after = trace.counts()

        def added(counter):
            return after.get(counter, 0) - before.get(counter, 0)

        self.report = BuildReport(
            strategy=name, n_shards=1 if mesh is None else mesh.size,
            total_s=total_s, stage_s=stage_s, stragglers=stragglers,
            stage_rss_mb=stage_rss, kmeans_passes=int(added("kmeans.passes")),
            read_wait_s=float(added("stream.read_wait_s")),
        )
        return index

    def _build_local(self, x: np.ndarray, stage):
        cfg, device = self.cfg, self.device
        n, d = x.shape
        K, C, k = cfg.n_clusters, cfg.cluster_capacity, cfg.n_neighbors
        block = cfg.build_block_rows
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
            knn_local, knn_w = chunked_cluster_knn(x_rows.reshape(K, C, d), counts.cpu().numpy(), k, device)
        return self._assemble(x, x_rows, knn_local, knn_w, counts, cents_h, perm), stragglers

    def _build_streamed(self, store, stage):
        """The out-of-core build: every stage reads the corpus as a
        double-buffered stream of ``cfg.resolved_chunk_rows()``-row chunks
        (:func:`repro_torch.data.store.stream_chunks`), so host memory holds
        O(chunk + K·D) of it, plus the O(N·k) graph the build makes. The
        device holds the (N_pad, R) candidate cache of the assignment
        (R = ``cfg.build_candidates``), filled chunk by chunk through the
        ``pairwise`` kernel. A disk-backed input spills the cluster-major
        ``x_rows`` straight into a sharded store on disk (dtype
        ``cfg.store_dtype``); an in-memory one scatters into one host
        buffer. The in-cell kNN then streams ``x_rows`` in whole cells."""
        from repro_torch.data.store import ArrayStore, stream_chunks

        cfg, device = self.cfg, self.device
        n, d = store.shape
        K, C, k = cfg.n_clusters, cfg.cluster_capacity, cfg.n_neighbors
        chunk = max(1, min(cfg.resolved_chunk_rows(), n))
        blk = max(1, min(cfg.build_block_rows, chunk))

        with stage("kmeans"):
            cents = km.kmeans_centroids_streamed(
                seeded_generator(device, cfg.seed),
                store,
                K,
                chunk_rows=chunk,
                n_iters=cfg.kmeans_iters,
                tol=cfg.kmeans_tol,
                block=cfg.build_block_rows,
                device=device,
            )
        with stage("assign"):
            cand_idx, cand_d2 = streamed_candidates(store, cents, cfg.build_candidates, chunk, blk)
            assign_d, free_d = capacity_rounds(cand_idx, cand_d2, K, C, cfg.build_max_rounds, n_real=n)
            del cand_idx, cand_d2
        with stage("stragglers"):
            cents_h = cents.cpu().numpy()
            assign, stragglers = force_place_host(
                store, cents_h, assign_d[:n].cpu().numpy().astype(np.int64), free_d.cpu().numpy().copy()
            )
        with stage("permute"):
            perm_d, counts = permutation_from_assign(torch.from_numpy(assign).to(device), K, C)
            perm = perm_d.cpu().numpy()
            if store.path is not None:  # disk in, disk out
                x_rows = spill_sharded_scatter(
                    store, perm, K * C, d, resolve_spill_dir(cfg, store), cfg.store_dtype, chunk,
                    max_shards=cfg.store_max_shards,
                )
            else:  # an in-memory store: scatter chunk by chunk into one host buffer
                x_rows = np.zeros((K * C, d), np.float32)
                for s, ch in store.iter_chunks(chunk):
                    x_rows[perm[s : s + ch.shape[0]]] = ch
        with stage("knn"):
            kc = max(1, chunk // C)  # whole cells a read
            knn_local = np.empty((K, C, k), np.int32)
            knn_w = np.empty((K, C, k), np.float32)
            x_rows_store = x_rows if store.path is not None else ArrayStore(x_rows)
            slots = torch.arange(C, device=device)
            for s, rows in stream_chunks(x_rows_store, kc * C, encoded=True):
                c0, nb = s // C, rows.shape[0] // C
                xb = km.chunk_to_device(rows, device).reshape(nb, C, d)
                valid = slots[None, :] < counts[c0 : c0 + nb, None]
                i, w = batched_cluster_knn(xb, valid, k)
                knn_local[c0 : c0 + nb] = i.cpu().numpy()
                knn_w[c0 : c0 + nb] = w.cpu().numpy()
        return self._assemble(store, x_rows, knn_local, knn_w, counts, cents_h, perm), stragglers

    def _build_slots(self, x, mesh, stage, *, distributed: bool):
        """The build over the flat ``mesh`` of shard slots. Rows are padded
        to a multiple of the slot count and sharded contiguously (slot i
        holds rows [i·N_pad/n, (i+1)·N_pad/n)); padding enters no statistic
        and never bids. Stages: k-means (:func:`repro_torch.index.kmeans.
        kmeans_fit_sharded`), each slot's candidate pass, bidding rounds
        over the gathered bids (one exchange a round, admission the same on
        every process), the host straggler pass and the permutation, then
        each slot's in-cell kNN of its own K/n cells. ``distributed``: ``x``
        is a store and each slot reads only its rows ("place"); under
        several processes the cluster-major ``x_rows`` is spilled by every
        process for its own slots and committed by process 0."""
        from repro_torch.data.store import ShardedStore, commit_sharded_meta, write_sharded

        cfg = self.cfg
        n, d = x.shape
        K, C, k = cfg.n_clusters, cfg.cluster_capacity, cfg.n_neighbors
        block = cfg.build_block_rows
        slots, local = mesh.slots, mesh.local_indices()
        n_dev = mesh.size
        home = slots[local[0]].device
        rows_per = -(-n // n_dev)

        def rows_of(i):
            lo, hi = min(i * rows_per, n), min((i + 1) * rows_per, n)
            blk = x.read(lo, hi) if distributed else np.asarray(x[lo:hi], np.float32)
            if blk.shape[0] < rows_per:
                blk = np.concatenate([blk, np.zeros((rows_per - blk.shape[0], d), np.float32)])
            return torch.from_numpy(np.ascontiguousarray(blk)).to(slots[i].device)

        if distributed:
            with stage("place"):
                xs = [rows_of(i) for i in local]
        else:
            xs = [rows_of(i) for i in local]

        with stage("kmeans"):
            cents = km.kmeans_fit_sharded(seeded_generator(home, cfg.seed), xs, K, mesh, n_iters=cfg.kmeans_iters,
                                          tol=cfg.kmeans_tol, block=block, n_real=n)

        with stage("assign"):
            blk = max(1, min(block, rows_per))
            cands = [candidate_pass(xl, cents.to(xl.device), cfg.build_candidates, blk) for xl in xs]
            del xs

            def bid(free):
                packed = []
                for ci, cd in cands:
                    pick, d2, has = bid_from_candidates(ci, cd, free.to(ci.device))
                    packed.append(torch.stack([pick, d2.view(torch.int32), has.to(torch.int32)]))
                allp = torch.cat([p.to(home) for p in mesh.all_gather(packed)], 1)
                return allp[0], allp[1].view(torch.float32), allp[2].bool()

            assign_d, free_d = bidding_rounds(bid, rows_per * n_dev, K, C, cfg.build_max_rounds, home, n_real=n)
            del cands
        with stage("stragglers"):
            cents_h = cents.cpu().numpy()
            assign, stragglers = force_place_host(
                x, cents_h, assign_d[:n].cpu().numpy().astype(np.int64), free_d.cpu().numpy().copy()
            )
        Kl = K // n_dev
        rps = Kl * C
        with stage("permute"):
            perm_d, counts = permutation_from_assign(torch.from_numpy(assign).to(home), K, C)
            perm = perm_d.cpu().numpy()
            if not distributed:
                x_rows = np.zeros((K * C, d), x.dtype)
                x_rows[perm] = x
                blocks = [x_rows[i * rps : (i + 1) * rps] for i in local]
            else:  # each slot's cells, from the store rows mapped there
                blocks = []
                for i in local:
                    src = np.flatnonzero((perm >= i * rps) & (perm < (i + 1) * rps))
                    xloc = np.zeros((rps, d), np.float32)
                    xloc[perm[src] - i * rps] = x.read_rows(src)
                    blocks.append(xloc)
                if process_count() > 1:
                    if not (cfg.checkpoint_dir or x.path):
                        raise ValueError(
                            "distributed build: the x_rows spill needs a place every process resolves "
                            "alike: set cfg.checkpoint_dir or build from a store on disk"
                        )
                    spill_dir = resolve_spill_dir(cfg, x)
                    for i, xloc in zip(local, blocks):
                        write_sharded(xloc, spill_dir, rows_per_shard=rps, dtype=cfg.store_dtype,
                                      row_offset=i * rps, total_rows=K * C, commit=False)
                    sync_processes("x-rows-spill")
                    if process_index() == 0:
                        commit_sharded_meta(spill_dir, K * C, d, rows_per_shard=rps, dtype=cfg.store_dtype)
                    sync_processes("x-rows-commit")
                    x_rows = ShardedStore(spill_dir)
                else:
                    x_rows = np.concatenate(blocks)
        with stage("knn"):
            counts_h = counts.cpu().numpy()
            parts = [chunked_cluster_knn(xloc.reshape(Kl, C, d), counts_h[i * Kl : (i + 1) * Kl], k, slots[i].device)
                     for i, xloc in zip(local, blocks)]
            got_i = mesh.all_gather([torch.from_numpy(p[0]).to(home) for p in parts])
            got_w = mesh.all_gather([torch.from_numpy(p[1]).to(home) for p in parts])
            knn_local = np.concatenate([t.cpu().numpy() for t in got_i])
            knn_w = np.concatenate([t.cpu().numpy() for t in got_w])
        return self._assemble(x, x_rows, knn_local, knn_w, counts, cents_h, perm), stragglers

    def _assemble(self, x, x_rows, knn_local, knn_w, counts, cents_h, perm) -> AnnIndex:
        K, C = self.cfg.n_clusters, self.cfg.cluster_capacity
        knn_idx, knn_w = finalize_knn(knn_local, knn_w, K, C)
        return AnnIndex(
            x_rows=x_rows,
            knn_idx=knn_idx,
            knn_w=knn_w,
            counts=counts.cpu().numpy().astype(np.int64),
            centroids=cents_h,
            perm=perm,
            capacity=C,
            n_points=x.shape[0],
            fingerprint=data_fingerprint(x),
        )
