"""NOMAD Projection front end (paper §3, end to end), on one device or
sharded over a mesh of shard slots (``core/strategy.py``,
``core/distributed.py``).

Method selection:
* ``"nomad"``  — Eq. 3: remote cells via means (M̃), own cell sampled (M).
* ``"infonc"`` — Eq. 2: the InfoNC-t-SNE baseline; all negatives drawn
  uniformly from the full support.

Sampling conventions (paper §3.3): heads i uniform over points; noise tails
uniform over points; |M| = n_noise. Sampling (:func:`sample_step_rows`) is
kept apart from the update (:func:`step_update`), so a test can hand both
frameworks the same rows. Random numbers come from ``torch.Generator``s
seeded from (seed, epoch, step) in place of ``jax.random.fold_in`` keys, so
a fit repeats bit for bit on one device (and a resumed fit equals the
uninterrupted one) but draws other rows than the JAX package does.

Fault tolerance and serving: with ``cfg.checkpoint_dir`` set the fit caches
its index there (``index.npz``) and writes θ every
``checkpoint_every_epochs`` epochs in the JAX package's checkpoint format;
``fit(resume=True)`` and :meth:`NomadProjection.from_checkpoint` continue
from the latest one, and :meth:`NomadProjection.transform` serves the map
(``repro_torch.serve``). :meth:`NomadProjection.partial_fit` grows a fitted
map in place with appended rows (:func:`sample_partial_rows` draws the
refinement epochs' heads from the cells the append touched), and with a
``checkpoint_dir`` records each grown map as a version of its lineage
(``repro_torch.checkpoint.lineage``).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig
from repro_torch.core import losses
from repro_torch.core.pca import pca_init, pca_init_streamed
from repro_torch.core.runtime import process_count, process_index, resolve_device
from repro_torch.core.trace import span, stage
from repro_torch.index.ann import AnnIndex, data_fingerprint, index_cache_path, load_index, save_index
from repro_torch.index.build import IndexBuilder, seeded_generator

# ---------------------------------------------------------------------------
# Sampling helpers (cluster-major layout)
# ---------------------------------------------------------------------------


def sample_points(gen: torch.Generator, n: int, cum_counts: torch.Tensor, capacity: int, total: int):
    """n uniform valid points among ``total``. Returns (rows, cluster_ids)."""
    u = torch.randint(0, total, (n,), generator=gen, device=cum_counts.device, dtype=cum_counts.dtype)
    cluster = torch.searchsorted(cum_counts, u, right=True)
    start = torch.where(cluster > 0, cum_counts[(cluster - 1).clamp_min(0)], 0)
    return cluster * capacity + (u - start), cluster


def sample_in_cluster(gen: torch.Generator, cluster_ids: torch.Tensor, counts: torch.Tensor, capacity: int, s: int):
    """(B,) cluster ids → (B, s) uniform valid rows within each cluster."""
    c = counts[cluster_ids]  # (B,)
    u = torch.rand((cluster_ids.shape[0], s), generator=gen, device=counts.device)
    slot = torch.floor(u * c[:, None]).to(torch.int64)
    slot = torch.minimum(slot, (c - 1)[:, None])
    return cluster_ids[:, None] * capacity + slot


def local_means(theta_rows: torch.Tensor, counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """Masked per-cluster means of positions: (K·C, d) → (K, d)."""
    K = counts.shape[0]
    th = theta_rows.reshape(K, capacity, -1).float()
    valid = (torch.arange(capacity, device=counts.device)[None, :] < counts[:, None]).float()
    sums = torch.sum(th * valid[:, :, None], 1)
    return sums / torch.clamp_min(counts.float(), 1.0)[:, None]


# ---------------------------------------------------------------------------
# The SGD step
# ---------------------------------------------------------------------------


def sample_step_rows(gen: torch.Generator, idx: dict, cfg: NomadConfig, method: str):
    """The rows one step draws: (rows (B,), clusters (B,), neg_rows (B, S)
    for "nomad" or (B, n_noise) for "infonc")."""
    B, C = cfg.batch_size, cfg.cluster_capacity
    rows, cl = sample_points(gen, B, idx["cum_counts"], C, idx["total"])
    if method == "infonc":
        neg_rows, _ = sample_points(gen, B * cfg.n_noise, idx["cum_counts"], C, idx["total"])
        return rows, cl, neg_rows.reshape(B, cfg.n_noise)
    return rows, cl, sample_in_cluster(gen, cl, idx["counts"], C, cfg.n_exact_negatives)


def step_update(theta, idx, means, counts_f, lr, rows, cl, neg_rows, *, cfg, method="nomad", n_total=None,
                cell_w=None, own_base: int = 0):
    """One sparse SGD step on the given rows; updates ``theta`` in place
    (only the touched rows move) and returns the batch-mean loss.
    ``cell_w``/``own_base``: a shard's exchanged weights and the row of its
    first cell among ``means`` (``core/distributed.py``).

    The three scatters sum duplicate rows in the JAX package's order
    (heads, then positives, then negatives) with ``index_put_(accumulate=
    True)``, whose CUDA path sorts the indices and adds in a fixed order:
    no float atomics, so a step repeats bit for bit. Its phases are the
    spans ``nomad.step.gather``, ``nomad.step.k1`` and
    ``nomad.step.scatter``.
    """
    n_total = n_total or cfg.n_points
    with span("nomad.step.gather"):
        pos_rows = idx["knn_idx"][rows]  # (B, k)
        pos_w = idx["knn_w"][rows]
        th_i = theta[rows].requires_grad_()
        th_pos = theta[pos_rows].requires_grad_()
        th_neg = theta[neg_rows].requires_grad_()
    # K1 forward and backward. On the card the backward runs on autograd's
    # device thread; this span, on the caller's, is what is open while the
    # caller waits in ``autograd.grad``, so it keys those idle gaps
    with span("nomad.step.k1"):
        if method == "infonc":
            loss = losses.infonc_tsne_loss(th_i, th_pos, pos_w, th_neg)
        else:
            loss = losses.nomad_loss(
                th_i, th_pos, pos_w, means, counts_f, cl, th_neg,
                n_noise=cfg.n_noise, n_total=n_total, cell_w=cell_w, own_base=own_base,
            )
        g_i, g_pos, g_neg = torch.autograd.grad(loss, (th_i, th_pos, th_neg))
    with span("nomad.step.scatter"):
        d = theta.shape[1]
        theta.index_put_((rows,), g_i * -lr, accumulate=True)
        theta.index_put_((pos_rows.reshape(-1),), g_pos.reshape(-1, d) * -lr, accumulate=True)
        theta.index_put_((neg_rows.reshape(-1),), g_neg.reshape(-1, d) * -lr, accumulate=True)
    return loss.detach()


def sample_partial_rows(gen: torch.Generator, idx: dict, cfg: NomadConfig, method: str):
    """:func:`sample_step_rows` with heads restricted to a cell subset (the
    JAX package's ``make_partial_step_fn``): heads uniform over the points
    of ``idx["aff_cells"]`` (their cumulative counts ``aff_cum_counts``,
    ``aff_total`` points), mapped to global rows through the affected →
    global cell ids. Negatives are in the head's cell, or for "infonc"
    uniform over all points."""
    B, C = cfg.batch_size, cfg.cluster_capacity
    rows_a, a = sample_points(gen, B, idx["aff_cum_counts"], C, idx["aff_total"])
    cell = idx["aff_cells"][a]
    rows = rows_a + (cell - a) * C
    if method == "infonc":
        neg_rows, _ = sample_points(gen, B * cfg.n_noise, idx["cum_counts"], C, idx["total"])
        return rows, cell, neg_rows.reshape(B, cfg.n_noise)
    return rows, cell, sample_in_cluster(gen, cell, idx["counts"], C, cfg.n_exact_negatives)


def make_step_fn(cfg: NomadConfig, *, method: str = "nomad", cluster_offset: int = 0,
                 n_total: Optional[int] = None, sampler=sample_step_rows):
    """``step(theta, idx, means, global_counts, lr, gen) -> (theta, loss)``,
    the JAX package's step factory: draw the step's rows with ``sampler``
    from the generator ``gen`` (in place of a JAX key) and apply
    :func:`step_update`. ``cluster_offset`` is the row of cell 0 of
    ``idx["counts"]`` among ``means`` (``step_update``'s ``own_base``)."""

    def step(theta, idx, means, global_counts, lr, gen):
        with span("nomad.step.sample"):
            rows, cl, neg_rows = sampler(gen, idx, cfg, method)
        loss = step_update(theta, idx, means, global_counts, lr, rows, cl, neg_rows, cfg=cfg, method=method,
                           n_total=n_total, own_base=cluster_offset)
        return theta, loss

    return step


def make_epoch_fn(cfg: NomadConfig, step_fn, steps_per_epoch: int):
    """``epoch(theta, idx, lr0, lr1, epoch_key) -> (theta, mean loss)``, the
    JAX package's epoch factory: means refreshed every
    ``cfg.mean_refresh_steps`` (default: once, at the start), lr annealed
    linearly from lr0 towards lr1, and step t's generator seeded from
    (*epoch_key, t) in place of ``fold_in(epoch_key, t)``. Spans
    (:mod:`repro_torch.core.trace`): ``nomad.epoch``, ``nomad.means`` at
    each refresh, ``nomad.step`` at each step, and within the step
    ``nomad.step.sample`` (twice: the generator here, the draw in
    ``step_fn``) and :func:`step_update`'s three."""
    refresh = cfg.mean_refresh_steps or steps_per_epoch

    def epoch(theta, idx, lr0, lr1, epoch_key):
        with span("nomad.epoch"):
            counts_f = idx["counts"].float()
            means, step_losses = None, []
            for t in range(steps_per_epoch):
                if t % refresh == 0:
                    with span("nomad.means"):
                        means = local_means(theta, idx["counts"], cfg.cluster_capacity)
                lr = lr0 + (lr1 - lr0) * (t / steps_per_epoch)
                with span("nomad.step"):
                    with span("nomad.step.sample"):  # the step's draw continues in ``step_fn``
                        gen = seeded_generator(theta.device, *epoch_key, t)
                    theta, loss = step_fn(theta, idx, means, counts_f, lr, gen)
                step_losses.append(loss)
            return theta, torch.stack(step_losses).mean()

    return epoch


def run_epoch(theta, idx, cfg: NomadConfig, method: str, steps: int, lr0: float, lr1: float, epoch: int,
              *, sampler=sample_step_rows, key: Optional[tuple] = None, n_total: Optional[int] = None):
    """One epoch of ``steps`` steps (:func:`make_epoch_fn` over
    :func:`make_step_fn`): step t draws its rows with ``sampler`` from a
    generator seeded from (*key, epoch, t), ``key`` (seed + 1,) by
    default. Returns (theta, mean loss as a 0-d tensor)."""
    key = (cfg.seed + 1,) if key is None else key
    step = make_step_fn(cfg, method=method, n_total=n_total, sampler=sampler)
    return make_epoch_fn(cfg, step, steps)(theta, idx, lr0, lr1, (*key, epoch))


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    embedding: np.ndarray  # (N, out_dim) in the original point order
    index: AnnIndex
    losses: list
    wall_time_s: float
    epoch_times: list
    strategy: str = "local"
    n_shards: int = 1
    mesh_shape: Optional[tuple] = None
    mesh_axes: Optional[tuple] = None
    # "local" | "streamed" | "sharded" | "distributed" (IndexBuilder ran),
    # "cache" (checkpoint_dir/index.npz) or "provided" (index= argument)
    index_build_strategy: str = ""
    index_build_s: float = 0.0
    index_build_stragglers: int = 0
    # wall seconds per stage, synchronised with the device: the build's
    # kmeans / assign / stragglers / permute / knn, then init and epochs;
    # and the process's peak host RSS (MB) at the end of each
    stage_s: dict = dataclasses.field(default_factory=dict)
    stage_rss_mb: dict = dataclasses.field(default_factory=dict)
    device: str = ""
    # fault tolerance: the first epoch this call ran, whether θ came from a
    # checkpoint, and the epochs checkpointed
    start_epoch: int = 0
    resumed: bool = False
    checkpoint_dir: str = ""
    checkpoint_epochs: list = dataclasses.field(default_factory=list)
    # multi-process provenance (torch.distributed; 1 and 0 in one process)
    process_count: int = 1
    process_index: int = 0


@dataclasses.dataclass
class PartialFitResult:
    """What one :meth:`NomadProjection.partial_fit` call produced."""

    embedding: np.ndarray  # (N_old + M, out_dim) in original ∥ appended order
    index: AnnIndex  # grown index (K' cells, capacity unchanged)
    n_new: int  # appended rows admitted this call
    n_points: int  # total rows after the append
    losses: list  # refinement epoch mean losses
    wall_time_s: float = 0.0
    epoch_times: list = dataclasses.field(default_factory=list)
    refine_epochs: int = 0
    # admission provenance
    affected_cells: np.ndarray = None  # (A,) cells placed into or re-seeded
    n_split_cells: int = 0  # cells that overflowed and were re-seeded
    n_new_cells: int = 0  # layout growth (K' - K)
    # wall seconds of place / admit / patch_knn / patch_rows / refine
    # (/ version), synchronised with the device
    stage_s: dict = dataclasses.field(default_factory=dict)
    # lineage provenance (empty when cfg.checkpoint_dir is unset)
    version: str = ""
    parent_version: str = ""
    checkpoint_dir: str = ""  # the self-contained version directory


def _config_digest(cfg: NomadConfig) -> dict:
    """The config fields a checkpoint must agree on to resume bit-exactly."""
    d = dataclasses.asdict(cfg)
    for transient in (
        "checkpoint_dir",
        "checkpoint_every_epochs",
        # serve-side knobs never change what a fit computes
        "serve_strategy",
        "serve_microbatch",
        "serve_knn_block",
        "transform_steps",
        "transform_lr",
        "partial_refine_epochs",
    ):
        d.pop(transient, None)
    return d


def _reject_float64(caller: str, is_float64: bool) -> None:
    if is_float64:
        raise ValueError(
            f"{caller}: x is float64 — the whole pipeline (index build, "
            "kernels, serving) runs float32; pass x.astype(np.float32) "
            "explicitly so the precision cut is your call, not a silent one"
        )


def _check_dim(caller: str, got: int, dim: Optional[int]) -> None:
    if dim is not None and got != dim:
        raise ValueError(
            f"{caller}: x has dim {got} but the fitted map expects "
            f"dim {dim} — queries must live in the training feature space"
        )


def _check_finite(caller: str, n_bad: int) -> None:
    if n_bad:
        raise ValueError(
            f"{caller}: x contains {n_bad} non-finite values (NaN/Inf) — "
            "clean or impute before projecting; a single NaN poisons the "
            "k-means statistics and every distance downstream"
        )


def prepare_inputs(x, dim: Optional[int] = None, caller: str = "fit", chunk_rows: int = 0):
    """The validation/dtype gate of ``fit`` and ``transform``: integer and
    half inputs are upcast to float32, float64 is rejected, NaN/Inf fail
    with an actionable error.

    Out-of-core inputs (a :class:`repro_torch.data.store.EmbeddingStore`,
    an ``np.memmap``, or the path of a ``.npy`` file or a sharded-store
    directory) are validated **per chunk** (``chunk_rows`` rows at a time,
    default 8192) and returned as a store the caller streams from: neither
    the cast nor the NaN scan allocates a full-size temporary. In-memory
    arrays are returned as a float32 ``np.ndarray``.
    """
    from repro_torch.data.store import DEFAULT_CHUNK_ROWS, as_store, is_store

    if is_store(x) or isinstance(x, (np.memmap, str, os.PathLike)):
        st = as_store(x)
        _reject_float64(caller, st.dtype_name == "float64")
        _check_dim(caller, st.dim, dim)
        n_bad = 0
        for _s, chunk in st.iter_chunks(chunk_rows if chunk_rows > 0 else DEFAULT_CHUNK_ROWS):
            n_bad += int(chunk.size - np.count_nonzero(np.isfinite(chunk)))
        _check_finite(caller, n_bad)
        return st

    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"{caller}: expected a 2-D (n_points, dim) array, got shape {x.shape}")
    _reject_float64(caller, x.dtype == np.float64)
    if x.dtype != np.float32:
        x = x.astype(np.float32)
    _check_finite(caller, int(np.size(x) - np.count_nonzero(np.isfinite(x))))
    _check_dim(caller, x.shape[1], dim)
    return x


class NomadProjection:
    """The scikit-style front end: ``NomadProjection(cfg).fit(x)``, then
    ``transform(q)``.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; with no card and no
    device named it raises rather than fall back to the CPU. ``strategy``
    (default ``cfg.strategy``) is ``"auto"``, ``"local"``, ``"sharded"``,
    ``"hierarchical"`` or a strategy instance (``core/strategy.py``);
    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh` of shard slots),
    ``shard_axes`` and ``pod_axis`` place the sharded ones, and ``mesh``
    also sizes the index build's slots. The fit takes an in-memory array
    or streams from an on-disk store (a store, a memmap, a ``.npy`` path or
    a store directory). Under ``torch.distributed`` every process runs the
    same fit over one global mesh; process 0 alone writes the index cache
    and the checkpoints (synchronously, everyone waiting on each). With
    ``cfg.checkpoint_dir`` set, ``from_checkpoint(dir).transform(q)`` serves
    the map without the training array, and ``partial_fit(y)`` grows it by
    appended rows. Progress streams through the event API
    (:class:`repro_torch.core.strategy.FitCallbacks`).
    """

    def __init__(self, cfg: NomadConfig, method: Optional[str] = None, *, strategy=None, mesh=None,
                 shard_axes=None, pod_axis=None, device=None):
        self.cfg = cfg
        self.method = method or cfg.method
        self.strategy = strategy if strategy is not None else cfg.strategy
        self.mesh = mesh
        self.shard_axes = shard_axes
        self.pod_axis = pod_axis
        self.device = resolve_device(device)
        self._resume_default = False
        self._fit_result: Optional[FitResult] = None
        self._frozen = None
        self._server = None

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, cfg: Optional[NomadConfig] = None, *,
                        device=None, **overrides) -> "NomadProjection":
        """The estimator a checkpoint directory was written by (the port's
        or the JAX package's). It resumes by default: ``.fit(x)`` restores
        the latest θ and epoch and continues to ``cfg.n_epochs``; with no
        fit, ``transform`` serves the checkpointed map. Field ``overrides``
        (or a full ``cfg``) alter the continuation."""
        from repro_torch.checkpoint import load_metadata

        meta = load_metadata(checkpoint_dir)
        if cfg is None:
            if "config" not in meta:
                raise ValueError(
                    f"checkpoint under {checkpoint_dir} has no stored config: "
                    "pass cfg= to resume it"
                )
            cfg = NomadConfig.from_stored(meta["config"], checkpoint_dir=checkpoint_dir, **overrides)
        est = cls(cfg, method=meta.get("method"), device=device)
        est._resume_default = True
        return est

    def fit(self, x, index: Optional[AnnIndex] = None, callback=None, *, callbacks=None,
            resume: Optional[bool] = None, theta0=None) -> FitResult:
        """Fit the map. ``x`` is an in-memory array or a disk-backed corpus
        (a :class:`repro_torch.data.store.EmbeddingStore`, an ``np.memmap``,
        or the path of a ``.npy`` file or a store directory); a store input
        streams through the build and the PCA init, and the epochs never
        read the corpus. With ``cfg.chunk_rows`` set, ``fit(store)`` and
        ``fit(ndarray)`` of the same rows are bit-equal. ``index`` (an
        :class:`AnnIndex`, e.g. loaded from the JAX package's ``index.npz``)
        skips the build; ``theta0`` (a (K·C, out_dim) array in the index's
        row layout) replaces the init; ``resume=True`` continues from the
        latest checkpoint under ``cfg.checkpoint_dir``. Progress streams
        through ``callbacks`` (a :class:`repro_torch.core.strategy.
        FitCallbacks` or a sequence of them); ``callback`` is the
        deprecated bare ``fn(epoch, embedding, loss)``."""
        from repro_torch.checkpoint import Checkpointer, latest_step
        from repro_torch.core.strategy import (
            CheckpointEvent,
            EpochEndEvent,
            EpochStartEvent,
            MeansRefreshEvent,
            as_callbacks,
            resolve_strategy,
            sync_processes,
        )

        cfg, device = self.cfg, self.device
        x = prepare_inputs(x, caller="fit", chunk_rows=cfg.chunk_rows)
        t0 = time.perf_counter()
        events = as_callbacks(callbacks, callback)
        resume = self._resume_default if resume is None else resume
        ckdir = cfg.checkpoint_dir
        if resume and not ckdir:
            raise ValueError("resume=True needs cfg.checkpoint_dir to be set")
        stage_s: dict = {}
        stage_rss: dict = {}

        # ---- index: argument > on-disk cache > fresh build ----------------
        index_cache = index_cache_path(ckdir) if ckdir else ""
        cache_stale = False
        build_strategy, build_s, stragglers = "provided", 0.0, 0
        if index is None and index_cache and os.path.exists(index_cache):
            cached = load_index(index_cache)
            # a cache left by another dataset must not replace the caller's
            # data, neither by shape nor, at the same shape, by content
            if cached.n_points != x.shape[0] or cached.x_rows.shape[1] != x.shape[1]:
                cache_stale = True
                warnings.warn(
                    f"ignoring index cache {index_cache}: built for "
                    f"({cached.n_points}, {cached.x_rows.shape[1]}) data, got {x.shape} — rebuilding"
                )
            elif cached.fingerprint and cached.fingerprint != data_fingerprint(x):
                cache_stale = True
                warnings.warn(
                    f"ignoring index cache {index_cache}: same shape but different "
                    "data content (fingerprint mismatch) — rebuilding"
                )
            else:
                index, build_strategy = cached, "cache"
        multiprocess = process_count() > 1
        if index is None:
            builder = IndexBuilder(cfg, mesh=self.mesh, device=device)
            index = builder.build(x)
            build_strategy, build_s = builder.report.strategy, builder.report.total_s
            stragglers = builder.report.stragglers
            stage_s.update(builder.report.stage_s)
            stage_rss.update(builder.report.stage_rss_mb)
        if index_cache:
            # every process holds the same index: process 0 alone decides and
            # writes, and everyone waits on it (a peer deciding by the file
            # could find it already written and skip the barrier)
            if process_index() == 0 and (cache_stale or not os.path.exists(index_cache)):
                os.makedirs(ckdir, exist_ok=True)
                save_index(index, index_cache)
            sync_processes("index-cache")

        # ---- θ: checkpoint > warm start > fresh init ----------------------
        start_epoch, resumed = 0, False
        with stage("fit", "init", stage_s, device, stage_rss):
            if resume and latest_step(ckdir) is not None:
                tree, meta = Checkpointer(ckdir).restore({"theta": None})
                theta0 = tree["theta"]
                want = (index.n_clusters * index.capacity, cfg.out_dim)
                if theta0.shape != want:
                    raise ValueError(f"checkpointed θ {theta0.shape} does not match the index layout {want}")
                start_epoch, resumed = int(meta["epoch"]) + 1, True
                stored = meta.get("config")
                digest = _config_digest(cfg)
                if stored is not None and {k: v for k, v in stored.items() if k in digest} != digest:
                    warnings.warn(
                        "resuming with a config that differs from the one the checkpoint "
                        "was written with: the continued run will not match an "
                        "uninterrupted one"
                    )
            if theta0 is None:
                theta0 = self._init_theta(x, index)
            strategy = resolve_strategy(self.strategy, cfg, method=self.method, mesh=self.mesh,
                                        shard_axes=self.shard_axes, pod_axis=self.pod_axis)
            theta = strategy.prepare(cfg, self.method, index, theta0, device)

        # the writer thread commits epoch e's θ while epoch e + 1 runs; save
        # takes θ's host copy first, so the in-place epoch cannot reach it.
        # Several processes: process 0 writes synchronously and everyone
        # waits on the commit (a writer thread would race the barrier)
        ckpt = None
        if ckdir:
            ckpt = Checkpointer(ckdir, n_shards=strategy.n_shards, keep=3, async_save=not multiprocess,
                                primary=process_index() == 0)
        every = max(1, cfg.checkpoint_every_epochs)
        lr0 = cfg.resolved_lr0()
        losses_, epoch_times, checkpoint_epochs = [], [], []
        with stage("fit", "epochs", stage_s, device, stage_rss):
            try:
                for e in range(start_epoch, cfg.n_epochs):
                    te = time.perf_counter()
                    f0 = 1.0 - e / cfg.n_epochs
                    f1 = 1.0 - (e + 1) / cfg.n_epochs
                    if events is not None:
                        events.on_epoch_start(EpochStartEvent(e, cfg.n_epochs, lr0 * f0, lr0 * f1, strategy.name))
                    theta, mloss = strategy.run_epoch(theta, e, lr0 * f0, lr0 * f1)
                    losses_.append(mloss)
                    epoch_times.append(time.perf_counter() - te)
                    if ckpt is not None and ((e + 1) % every == 0 or e == cfg.n_epochs - 1):
                        # fetch is collective: every process gathers θ, one writes it
                        ckpt.save(
                            e,
                            {"theta": strategy.fetch(theta)},
                            sharded_keys=("theta",),
                            metadata={
                                "epoch": e,
                                "config": dataclasses.asdict(cfg),
                                "method": self.method,
                                "strategy": strategy.name,
                                "losses": list(losses_),
                            },
                        )
                        if multiprocess:
                            sync_processes(f"ckpt-{e}")
                        checkpoint_epochs.append(e)
                        if events is not None:
                            events.on_checkpoint(CheckpointEvent(e, e, ckdir, strategy.n_shards))
                    if events is not None:
                        events.on_means_refresh(MeansRefreshEvent(e, strategy.refreshes_per_epoch(), strategy.name))
                        emb_e = index.unpermute(strategy.fetch(theta)) if events.wants_embedding else None
                        events.on_epoch_end(
                            EpochEndEvent(e, cfg.n_epochs, mloss, epoch_times[-1], strategy.name, emb_e)
                        )
            finally:
                if ckpt is not None:
                    ckpt.wait()  # commit the save in flight, even on interruption

        emb = index.unpermute(strategy.fetch(theta))
        meta = strategy.describe()
        result = FitResult(
            embedding=emb,
            index=index,
            losses=losses_,
            wall_time_s=time.perf_counter() - t0,
            epoch_times=epoch_times,
            strategy=meta["strategy"],
            n_shards=meta["n_shards"],
            mesh_shape=meta["mesh_shape"],
            mesh_axes=meta["mesh_axes"],
            index_build_strategy=build_strategy,
            index_build_s=build_s,
            index_build_stragglers=stragglers,
            stage_s=stage_s,
            stage_rss_mb=stage_rss,
            device=str(device),
            start_epoch=start_epoch,
            resumed=resumed,
            checkpoint_dir=ckdir,
            checkpoint_epochs=checkpoint_epochs,
            process_count=meta["process_count"],
            process_index=meta["process_index"],
        )
        self._fit_result = result
        self._frozen = None  # a refit invalidates any frozen state
        self._server = None
        return result

    # -- incremental growth (append-only corpora) ----------------------------

    def _previous_state(self):
        """(index, theta_rows) of the map being grown: the fit (or partial
        fit) of this process, else the newest lineage version under
        ``cfg.checkpoint_dir`` (the root itself for a checkpoint written
        before any ``partial_fit``). Growing from a checkpoint needs no
        access to the original corpus: its rows are the index's
        ``x_rows``."""
        from repro_torch.checkpoint import MapLineage, latest_step, load_theta

        cfg = self.cfg
        if self._fit_result is not None:
            index = self._fit_result.index
            theta_rows = np.zeros((index.n_clusters * index.capacity, cfg.out_dim), np.float32)
            theta_rows[index.perm] = self._fit_result.embedding
            return index, theta_rows
        if not cfg.checkpoint_dir:
            raise RuntimeError(
                "partial_fit needs a fitted map: call fit(x) first, or load one with "
                "NomadProjection.from_checkpoint(dir)"
            )
        base = MapLineage(cfg.checkpoint_dir).latest()
        base_dir = base.path if base is not None else cfg.checkpoint_dir
        cache = index_cache_path(base_dir)
        if not os.path.exists(cache) or latest_step(base_dir) is None:
            raise RuntimeError(
                f"partial_fit: {base_dir} holds no fitted map (need both index.npz and a "
                "step_*/ checkpoint): run fit(x) with cfg.checkpoint_dir set first"
            )
        theta_rows, _meta = load_theta(base_dir)
        return load_index(cache), theta_rows

    def partial_fit(self, new_x, *, callbacks=None, refine_epochs: Optional[int] = None,
                    seed: Optional[int] = None) -> PartialFitResult:
        """Grow the fitted map in place with appended rows (no refit).

        **Place** ``new_x`` on the frozen map through the serve path
        (initial positions and nearest-centroid target cells) → **admit**
        them into capacity-bounded cells, re-seeding only cells that
        overflow, and **patch** the in-cell kNN graph and ``x_rows`` of the
        affected cells (:mod:`repro_torch.index.incremental`) → **refine**
        with ``refine_epochs`` (default ``cfg.partial_refine_epochs``)
        cheap epochs whose heads are drawn from the affected cells only
        (:class:`repro_torch.core.strategy.PartialRefineStrategy`) →
        **version**: with ``cfg.checkpoint_dir`` set, a self-contained
        ``vN/`` directory (θ checkpoint and index cache) recorded in the
        ``versions.json`` lineage. Afterwards the estimator serves (and
        grows) the new map.

        Rows in cells the append never touches keep bit-identical
        positions; appending 0 rows changes nothing and writes nothing.
        ``seed`` seeds the placement (default ``cfg.seed``). Single-process:
        grow the map on one process and serve the version anywhere.
        """
        if process_count() > 1:
            raise RuntimeError(
                "partial_fit is single-process: grow the map on one process, then serve "
                "the version from any process"
            )
        from repro_torch.checkpoint import Checkpointer, MapLineage
        from repro_torch.core.strategy import EpochEndEvent, EpochStartEvent, PartialRefineStrategy, as_callbacks
        from repro_torch.data.store import is_store
        from repro_torch.index.incremental import admit_and_patch
        from repro_torch.serve import FrozenMap, MapServer

        cfg, device = self.cfg, self.device
        t0 = time.perf_counter()
        events = as_callbacks(callbacks, None)
        index, theta_rows = self._previous_state()
        if index.capacity != cfg.cluster_capacity:
            raise ValueError(
                f"partial_fit: index capacity {index.capacity} != cfg.cluster_capacity "
                f"{cfg.cluster_capacity}: partial_fit runs with the config the map was fitted "
                "with (capacity is fixed for the life of a map)"
            )
        new_x = prepare_inputs(new_x, dim=int(index.x_rows.shape[1]), caller="partial_fit")
        if is_store(new_x):
            new_x = new_x.materialize()  # appends are batch-sized, not corpus-sized
        M, n_old = int(new_x.shape[0]), index.n_points
        lineage = MapLineage(cfg.checkpoint_dir) if cfg.checkpoint_dir else None

        if M == 0:  # the no-op: nothing changes, nothing is written
            latest = lineage.latest() if lineage is not None else None
            name = latest.name if latest is not None else ""
            return PartialFitResult(
                embedding=index.unpermute(theta_rows), index=index, n_new=0, n_points=n_old,
                losses=[], wall_time_s=time.perf_counter() - t0, affected_cells=np.zeros((0,), np.int64),
                version=name, parent_version=name,
            )

        # ---- place: the frozen map's serve path ---------------------------
        stage_s: dict = {}
        with stage("fit", "place", stage_s, device):
            placed = MapServer(FrozenMap.from_index_theta(index, theta_rows, cfg, device=device)).transform(
                new_x, seed=cfg.seed if seed is None else seed, return_neighbors=False
            )

        # ---- version bookkeeping (the directory precedes a store spill) ---
        version_name, parent_name, version_dir = "", "", ""
        if lineage is not None:
            if not lineage.exists():  # a checkpoint from before any partial_fit becomes v0
                lineage.record(name="v0", dirname=".", parent="", fingerprint=index.fingerprint,
                               n_points=n_old, kind="fit")
            parent_name = lineage.latest().name
            version_name = lineage.next_name()
            version_dir = os.path.join(cfg.checkpoint_dir, version_name)
            os.makedirs(version_dir, exist_ok=True)

        # ---- admit and patch ---------------------------------------------
        spill_dir = None
        if is_store(index.x_rows):
            if version_dir:
                spill_dir = os.path.join(version_dir, "x_rows_store")
            else:
                import tempfile

                spill_dir = tempfile.mkdtemp(prefix="repro-torch-partial-spill-")
        upd = admit_and_patch(index, theta_rows, new_x, placed.cells, placed.embedding, cfg,
                              device=device, spill_dir=spill_dir)
        stage_s.update(upd.stage_s)

        # ---- refine: cheap epochs over the affected cells -----------------
        refine_epochs = cfg.partial_refine_epochs if refine_epochs is None else refine_epochs
        losses_, epoch_times = [], []
        with stage("fit", "refine", stage_s, device):
            if refine_epochs > 0 and upd.affected_cells.size:
                strategy = PartialRefineStrategy(upd.affected_cells)
                theta = strategy.prepare(cfg, self.method, upd.index, upd.theta_rows, device)
                # from the last fit epoch's lr scale, annealed to 0 again
                lr_r = cfg.resolved_lr0() / max(cfg.n_epochs, 1)
                for e in range(refine_epochs):
                    te = time.perf_counter()
                    f0 = 1.0 - e / refine_epochs
                    f1 = 1.0 - (e + 1) / refine_epochs
                    if events is not None:
                        events.on_epoch_start(EpochStartEvent(e, refine_epochs, lr_r * f0, lr_r * f1, strategy.name))
                    theta, mloss = strategy.run_epoch(theta, e, lr_r * f0, lr_r * f1)
                    losses_.append(mloss)
                    epoch_times.append(time.perf_counter() - te)
                    if events is not None:
                        emb_e = upd.index.unpermute(strategy.fetch(theta)) if events.wants_embedding else None
                        events.on_epoch_end(
                            EpochEndEvent(e, refine_epochs, mloss, epoch_times[-1], strategy.name, emb_e)
                        )
                theta_new = strategy.fetch(theta)
            else:
                theta_new = upd.theta_rows

        # ---- version: a self-contained directory and its lineage entry ----
        if lineage is not None:
            with stage("fit", "version", stage_s, device):
                step = max(refine_epochs - 1, 0)
                ckpt = Checkpointer(version_dir, keep=2, async_save=False)
                ckpt.save(
                    step,
                    {"theta": theta_new},
                    metadata={
                        "epoch": step,
                        "config": dataclasses.asdict(cfg),
                        "method": self.method,
                        "strategy": "partial",
                        "losses": list(losses_),
                        "parent_version": parent_name,
                    },
                )
                ckpt.wait()
                save_index(upd.index, index_cache_path(version_dir))
                lineage.record(name=version_name, dirname=version_name, parent=parent_name,
                               fingerprint=upd.index.fingerprint, n_points=upd.index.n_points,
                               kind="partial_fit")

        emb = upd.index.unpermute(theta_new)
        result = PartialFitResult(
            embedding=emb,
            index=upd.index,
            n_new=M,
            n_points=upd.index.n_points,
            losses=losses_,
            wall_time_s=time.perf_counter() - t0,
            epoch_times=epoch_times,
            refine_epochs=refine_epochs,
            affected_cells=upd.affected_cells,
            n_split_cells=upd.n_split_cells,
            n_new_cells=upd.n_new_cells,
            stage_s=stage_s,
            version=version_name,
            parent_version=parent_name,
            checkpoint_dir=version_dir,
        )
        # the estimator now serves (and grows) the new map
        self._fit_result = FitResult(
            embedding=emb, index=upd.index, losses=losses_, wall_time_s=result.wall_time_s,
            epoch_times=epoch_times, strategy="partial", index_build_strategy="incremental",
            device=str(device), checkpoint_dir=version_dir,
        )
        self._frozen = None
        self._server = None
        return result

    def fit_transform(self, x, **kwargs) -> np.ndarray:
        """``fit(...)`` and return just the ``(N, out_dim)`` embedding."""
        return self.fit(x, **kwargs).embedding

    # -- out-of-sample serving (repro_torch.serve) ---------------------------

    def map_server(self, **overrides):
        """The :class:`repro_torch.serve.MapServer` this estimator serves
        from, on its device. The frozen map comes from the last ``fit`` in
        this process, else from ``cfg.checkpoint_dir`` (θ and the cached
        index: no training data needed). The default server is cached;
        ``overrides`` (``strategy=``, ``mesh=``, ``microbatch=``, ``steps=``, ``lr=``)
        give a fresh, uncached one, so a one-off override never changes what
        ``transform()`` does later."""
        from repro_torch.checkpoint import latest_step
        from repro_torch.serve import FrozenMap, MapServer

        if self._server is not None and not overrides:
            return self._server
        if self._frozen is None:
            if self._fit_result is not None:
                self._frozen = FrozenMap.from_fit(self._fit_result, self.cfg, device=self.device)
            elif self.cfg.checkpoint_dir and latest_step(self.cfg.checkpoint_dir) is not None:
                self._frozen = FrozenMap.from_checkpoint(self.cfg.checkpoint_dir, self.cfg, device=self.device)
            else:
                raise RuntimeError(
                    "transform needs a fitted map: call fit(x) first, or load one "
                    "with NomadProjection.from_checkpoint(dir)"
                )
        if overrides:
            return MapServer(self._frozen, **overrides)
        self._server = MapServer(self._frozen)
        return self._server

    def transform(self, x, *, seed: int = 0) -> np.ndarray:
        """Place unseen rows on the frozen fitted map: the (n_queries,
        out_dim) placements. ``map_server().transform(x)`` returns the full
        :class:`repro_torch.serve.TransformResult` (cells, neighbour ids and
        distances, per-batch latency). Never moves the fitted positions."""
        return self.map_server().transform(x, seed=seed).embedding

    def _init_theta(self, x, index: AnnIndex) -> np.ndarray:
        """PCA (or seeded random) init, scattered into the row layout. A
        store input, or ``cfg.chunk_rows > 0``, takes the streamed PCA with
        the build's chunks, so fit(store) ≡ fit(ndarray) stays bit-exact."""
        from repro_torch.data.store import as_store, is_store

        cfg = self.cfg
        if cfg.init == "pca" and (is_store(x) or cfg.chunk_rows > 0):
            th0 = pca_init_streamed(as_store(x), cfg.out_dim, cfg.init_scale,
                                    chunk_rows=cfg.resolved_chunk_rows(), device=self.device)
        elif cfg.init == "pca":
            xd = torch.from_numpy(x).to(self.device)
            th0 = pca_init(xd, cfg.out_dim, cfg.init_scale).cpu().numpy()
            del xd
        else:
            rng = np.random.default_rng(cfg.seed)
            th0 = rng.normal(0, cfg.init_scale, (x.shape[0], cfg.out_dim)).astype(np.float32)
        rows = np.zeros((index.n_clusters * index.capacity, cfg.out_dim), np.float32)
        rows[index.perm] = th0
        return rows
