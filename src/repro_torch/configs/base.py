"""The NOMAD run configuration, the port's own copy.

Field for field the JAX package's ``NomadConfig`` minus its kernel-impl
switches (``kernel_impl``, ``use_pallas``): the port picks a kernel by the
device a tensor lives on, never by a flag. ``dataclasses.asdict`` of this
config is therefore accepted by the JAX config's constructor, which is how
the tests build both frameworks from one set of values.

The port runs the local fit (``strategy`` "auto"/"local",
``build_strategy`` "auto"/"local") from memory or streamed from an on-disk
store (``chunk_rows``, ``store_dtype``, ``store_max_shards``), its
checkpoints (``checkpoint_dir``, ``checkpoint_every_epochs``) and local
serving (``serve_strategy`` "auto"/"local" and the other serve fields).
The remaining fields are kept so later slices (streaming, multi-GPU, the
service layer, incremental maps) read the same configuration; the entry
points raise for values they do not run yet. :meth:`NomadConfig.from_stored`
reads a config a checkpoint stored, the JAX package's included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# fields of the JAX package's config that the port deliberately lacks
JAX_ONLY_FIELDS = ("kernel_impl", "use_pallas")


@dataclass(frozen=True)
class NomadConfig:
    """A NOMAD Projection run: data, index, loss, schedule, distribution."""

    name: str = "nomad"
    # data
    n_points: int = 100_000
    dim: int = 256
    out_dim: int = 2

    # estimator (repro_torch.core.nomad.NomadProjection)
    method: str = "nomad"  # "nomad" (Eq. 3) | "infonc" (Eq. 2 baseline)
    strategy: str = "auto"  # "auto" | "local" (others: not ported yet)

    # ANN index (paper §3.2): LSH-initialised K-means, exact kNN in-cluster
    n_clusters: int = 64
    kmeans_iters: int = 25
    kmeans_tol: float = 1e-4
    capacity_slack: float = 1.25  # cluster capacity = slack * N / K
    n_neighbors: int = 15  # k of the kNN graph

    # index-build execution (repro_torch.index.build.IndexBuilder)
    build_strategy: str = "auto"  # "auto" | "local" (others: not ported yet)
    build_block_rows: int = 16384  # row block of the E-step / candidate pass
    build_max_rounds: int = 16  # bidding rounds before host fallback
    build_candidates: int = 32  # nearest-centroid candidates cached per row

    # out-of-core ingestion (repro_torch.data.store): rows a streamed stage
    # reads at once (0 => DEFAULT_CHUNK_ROWS for store inputs, and the
    # in-memory path for arrays); the dtype and shard cap of the x_rows spill
    chunk_rows: int = 0
    store_dtype: str = "float32"
    store_max_shards: int = 256

    # loss (paper §3.3)
    n_noise: int = 64  # |M| noise samples per head
    n_exact_negatives: int = 16  # samples drawn from non-approximated cells
    approximate_remote_only: bool = True  # R̃ = every cell except the head's own
    batch_size: int = 4_096  # heads sampled per step

    # schedule (paper §3.4): lr0 = n/10, linear anneal to 0, PCA init
    n_epochs: int = 40
    steps_per_epoch: int = 0  # 0 => ceil(N / batch_size)
    lr0: float = 0.0  # 0 => n_points / 10 (paper convention)
    init: str = "pca"  # "pca" | "random"
    init_scale: float = 1e-4  # per-dim std of the initial projection
    seed: int = 0

    # distribution (not ported yet beyond mean_refresh_steps)
    mean_refresh_steps: int = 0  # 0 => once per epoch (paper); else every T steps
    hierarchical: bool = False
    n_cluster_groups: int = 0

    # out-of-sample serving (repro_torch.serve; "sharded" not ported yet)
    serve_strategy: str = "auto"
    serve_microbatch: int = 1024
    serve_knn_block: int = 256
    transform_steps: int = 24
    transform_lr: float = 0.0

    # HTTP service front end (not ported yet)
    service_max_delay_s: float = 0.005
    service_cache_entries: int = 1024

    # incremental growth (not ported yet)
    partial_refine_epochs: int = 3

    # fault tolerance (repro_torch.checkpoint)
    checkpoint_every_epochs: int = 5
    checkpoint_dir: str = ""

    def __post_init__(self) -> None:
        if self.method not in ("nomad", "infonc"):
            raise ValueError(f"unknown method {self.method!r} (want 'nomad'|'infonc')")
        if self.strategy not in ("auto", "local", "sharded", "hierarchical"):
            raise ValueError(
                f"unknown strategy {self.strategy!r} "
                "(want 'auto'|'local'|'sharded'|'hierarchical')"
            )
        if self.build_strategy not in ("auto", "local", "sharded", "distributed"):
            raise ValueError(
                f"unknown build_strategy {self.build_strategy!r} "
                "(want 'auto'|'local'|'sharded'|'distributed')"
            )
        if (
            self.build_block_rows < 1
            or self.build_max_rounds < 1
            or self.build_candidates < 1
        ):
            raise ValueError(
                "build_block_rows, build_max_rounds and build_candidates "
                "must be >= 1"
            )
        if self.chunk_rows < 0:
            raise ValueError("chunk_rows must be >= 0 (0 = auto)")
        if self.store_max_shards < 1:
            raise ValueError("store_max_shards must be >= 1")
        if self.store_dtype not in ("float32", "float16", "bfloat16"):
            raise ValueError(
                f"unknown store_dtype {self.store_dtype!r} "
                "(want 'float32'|'float16'|'bfloat16')"
            )
        if self.serve_strategy not in ("auto", "local", "sharded"):
            raise ValueError(
                f"unknown serve_strategy {self.serve_strategy!r} "
                "(want 'auto'|'local'|'sharded')"
            )
        if self.serve_microbatch < 1 or self.serve_knn_block < 1:
            raise ValueError("serve_microbatch and serve_knn_block must be >= 1")
        if self.transform_steps < 0 or self.transform_lr < 0:
            raise ValueError("transform_steps and transform_lr must be >= 0")
        if self.service_max_delay_s < 0:
            raise ValueError("service_max_delay_s must be >= 0")
        if self.service_cache_entries < 0:
            raise ValueError("service_cache_entries must be >= 0 (0 disables)")
        if self.partial_refine_epochs < 0:
            raise ValueError("partial_refine_epochs must be >= 0 (0 = place only)")

    def resolved_lr0(self) -> float:
        return self.lr0 if self.lr0 > 0 else self.n_points / 10.0

    def resolved_transform_lr(self) -> float:
        """Per-row serve lr. Fit's mean-of-batch update gives each touched
        row an effective step of lr/batch_size, and by the last epoch the
        linear anneal has scaled lr down by ~1/n_epochs — the regime the
        frozen equilibrium was reached in, so that is where a new point's
        refinement starts (the serve steps anneal it further to 0)."""
        if self.transform_lr > 0:
            return self.transform_lr
        return self.resolved_lr0() / self.batch_size / max(self.n_epochs, 1)

    def resolved_chunk_rows(self) -> int:
        """The row-chunk size streamed pipeline stages read stores with."""
        if self.chunk_rows > 0:
            return self.chunk_rows
        from repro_torch.data.store import DEFAULT_CHUNK_ROWS

        return DEFAULT_CHUNK_ROWS

    def resolved_steps_per_epoch(self) -> int:
        if self.steps_per_epoch:
            return self.steps_per_epoch
        return max(1, -(-self.n_points // self.batch_size))

    @property
    def cluster_capacity(self) -> int:
        cap = int(self.capacity_slack * self.n_points / self.n_clusters)
        return max(cap, self.n_neighbors + 2)

    def replace(self, **kw) -> "NomadConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_stored(cls, stored: dict, **overrides) -> "NomadConfig":
        """The config a checkpoint stored (``dataclasses.asdict`` of either
        package's config), with ``overrides`` applied. The JAX package's
        kernel-impl switches are dropped: the port has no such fields."""
        fields = {k: v for k, v in dict(stored).items() if k not in JAX_ONLY_FIELDS}
        fields.update(overrides)
        return cls(**fields)
