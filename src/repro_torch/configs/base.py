"""The run configurations, the port's own copies.

* :class:`ArchConfig`, :class:`ShapeConfig`, :data:`SHAPES` and
  :func:`reduced`: the model zoo's architectures (exact published dims,
  ``configs/<id>.py``), copied from the JAX package field for field. The
  port runs their sequence forward (``repro_torch.models``) as the embed
  pipeline's embedder.
* :class:`NomadConfig`: a NOMAD Projection run. Field for field the JAX
  package's ``NomadConfig`` minus its kernel-impl switches
  (``kernel_impl``, ``use_pallas``): the port picks a kernel by the device
  a tensor lives on, never by a flag. ``dataclasses.asdict`` of this
  config is therefore accepted by the JAX config's constructor, which is
  how the tests build both frameworks from one set of values.

The port runs the fit on one device or sharded over shard slots
(``strategy``, ``hierarchical``, ``build_strategy``), from memory or
streamed from an on-disk store (``chunk_rows``, ``store_dtype``,
``store_max_shards``), its checkpoints (``checkpoint_dir``,
``checkpoint_every_epochs``) and serving (``serve_strategy`` and the other
serve fields). ``n_cluster_groups`` is kept so both packages read the same
configuration; no entry point of either reads it. :meth:`NomadConfig.from_stored`
reads a config a checkpoint stored, the JAX package's included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment.

    ``kind`` selects which step gets lowered in the dry-run:

    * ``train``   → ``train_step``   (fwd + bwd + optimizer update)
    * ``prefill`` → ``prefill_step`` (inference forward, returns KV/SSM state)
    * ``decode``  → ``decode_step``  (one new token against a seq_len cache)
    """

    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    def __post_init__(self) -> None:
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown shape kind {self.kind!r}")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# LM architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """An assigned architecture, with exact published dimensions.

    The same dataclass describes dense, MoE, SSM (attention-free), hybrid
    (Mamba + attention interleave), encoder-only audio, and VLM-backbone
    models; unused blocks are disabled with zeros.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int  # 0 => no dense MLP (mamba2's block has none)
    vocab_size: int
    head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1  # a layer is MoE iff (layer_idx % moe_period == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # "sort" (gather/scatter, production default — §Perf iteration 1) or
    # "einsum" (GShard one-hot dense dispatch — the naive baseline; its
    # dispatch einsums cost 2·T·E·C·D FLOPs and dominated the MoE cells)
    moe_dispatch: str = "sort"

    # --- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256  # SSD chunk length (training/prefill)

    # --- hybrid (Jamba) -------------------------------------------------------
    attn_period: int = 0  # >0: layer l uses attention iff l % attn_period == 0

    # --- attention details ------------------------------------------------------
    sliding_window: int = 0  # >0: Mistral/Mixtral-style SWA
    qk_norm: bool = False  # Qwen3-style per-head RMS norm of q,k
    rope_theta: float = 1e4

    # --- modality ----------------------------------------------------------------
    encoder_only: bool = False  # HuBERT: bidirectional, no decode step
    n_vision_patches: int = 0  # InternVL2: stub patch embeds prepended to text

    # --- TPU sharding padding ----------------------------------------------------
    # pjit requires explicitly-sharded dims to divide the mesh axis. Heads are
    # padded per-kv-group with inert (masked) heads; vocab is padded with
    # -inf-masked logit columns. Both are exact-math-preserving; the waste is
    # visible in the roofline useful_ratio. reduced() disables both.
    head_pad_to: int = 16  # model-axis size the (padded) head count must divide by
    vocab_pad_to: int = 256

    # --- numerics / memory policy ---------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "int8"  # int8-quantized Adam moments by default
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator dtype
    remat: str = "full"  # "none" | "full" | "dots"
    accum_steps: int = 8  # gradient-accumulation microbatches for train_4k
    attn_chunk: int = 1024  # KV-chunk for memory-efficient (online-softmax) attn
    # "flash" = custom-VJP recompute backward (§Perf iteration 2);
    # "chunked" = plain online-softmax whose AD saves every tile (baseline)
    attn_impl: str = "flash"

    # --- provenance ------------------------------------------------------------
    source: str = ""

    # -- derived -----------------------------------------------------------------

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1) if self.n_heads else 0

    @property
    def n_heads_padded(self) -> int:
        """Heads incl. per-kv-group padding so TP over ``head_pad_to`` ways
        divides evenly AND every real head keeps its published kv group."""
        if not self.n_heads or self.head_pad_to <= 1:
            return self.n_heads
        import math

        kv = max(self.n_kv_heads, 1)
        g = self.n_heads // kv
        m = self.head_pad_to // math.gcd(kv, self.head_pad_to)
        g_pad = -(-g // m) * m
        return kv * g_pad

    @property
    def vocab_padded(self) -> int:
        if self.vocab_pad_to <= 1:
            return self.vocab_size
        return -(-self.vocab_size // self.vocab_pad_to) * self.vocab_pad_to

    def layer_is_attention(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return layer_idx % self.attn_period == 0
        return True

    def layer_is_moe(self, layer_idx: int) -> bool:
        if not self.n_experts:
            return False
        return layer_idx % self.moe_period == self.moe_offset

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run 512k-token contexts (assignment rule)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def supported_shapes(self) -> list[str]:
        out = []
        for s in SHAPES.values():
            if s.kind == "decode" and self.encoder_only:
                continue  # encoder-only: no autoregressive decode
            if s.name == "long_500k" and not self.sub_quadratic:
                continue  # needs sub-quadratic attention
            out.append(s.name)
        return out

    # -- parameter counts (for roofline MODEL_FLOPS) ------------------------------

    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and active-per-token."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # embedding (tied with the LM head)
        active = V * D
        per_layer_total = 0.0
        per_layer_active = 0.0
        for l in range(self.n_layers):
            lt = la = 0.0
            if self.layer_is_attention(l):
                qdim = self.n_heads * self.head_dim
                kvdim = self.n_kv_heads * self.head_dim
                attn = D * (qdim + 2 * kvdim) + qdim * D
                lt += attn
                la += attn
            elif self.family in ("ssm", "hybrid"):
                di, ds = self.d_inner, self.ssm_state
                ng = 1  # single B/C group
                in_proj = D * (2 * di + 2 * ng * ds + self.ssm_heads)
                out_proj = di * D
                conv = (di + 2 * ng * ds) * self.ssm_conv
                lt += in_proj + out_proj + conv + 2 * self.ssm_heads
                la += in_proj + out_proj + conv + 2 * self.ssm_heads
            if F:
                ffn = 3 * D * F  # SwiGLU
                if self.layer_is_moe(l):
                    lt += ffn * self.n_experts + D * self.n_experts
                    la += ffn * (self.top_k + self.n_shared_experts)
                    lt += ffn * self.n_shared_experts
                else:
                    lt += ffn
                    la += ffn
            lt += 2 * D  # norms
            la += 2 * D
            per_layer_total += lt
            per_layer_active += la
        total += per_layer_total + D  # final norm
        active += per_layer_active + D
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# NOMAD workload config
# ---------------------------------------------------------------------------


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
    strategy: str = "auto"  # "auto" | "local" | "sharded" | "hierarchical"

    # ANN index (paper §3.2): LSH-initialised K-means, exact kNN in-cluster
    n_clusters: int = 64
    kmeans_iters: int = 25
    kmeans_tol: float = 1e-4
    capacity_slack: float = 1.25  # cluster capacity = slack * N / K
    n_neighbors: int = 15  # k of the kNN graph

    # index-build execution (repro_torch.index.build.IndexBuilder)
    build_strategy: str = "auto"  # "auto" | "local" | "sharded" | "distributed"
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

    # distribution (core/strategy.py, core/distributed.py)
    mean_refresh_steps: int = 0  # 0 => once per epoch (paper); else every T steps
    hierarchical: bool = False
    n_cluster_groups: int = 0

    # out-of-sample serving (repro_torch.serve)
    serve_strategy: str = "auto"
    serve_microbatch: int = 1024
    serve_knn_block: int = 256
    transform_steps: int = 24
    transform_lr: float = 0.0

    # HTTP service front end (repro_torch.service)
    service_max_delay_s: float = 0.005
    service_cache_entries: int = 1024

    # incremental growth (NomadProjection.partial_fit)
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


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test-sized config of the same family (assignment requirement).

    Keeps the family topology (MoE period, attn interleave, SWA, qk-norm …)
    but shrinks widths/depths/vocab so one train step runs on CPU in <1 s.
    """

    kw: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 16),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else cfg.head_dim,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        # capacity ≥ E/k ⇒ drop-free routing, so tests comparing runs of
        # different lengths (prefill vs full forward) see identical math
        capacity_factor=8.0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=32,
        sliding_window=min(cfg.sliding_window, 16),
        n_vision_patches=min(cfg.n_vision_patches, 8),
        head_pad_to=1,
        vocab_pad_to=1,
        param_dtype="float32",
        compute_dtype="float32",
        opt_moment_dtype="float32",
        accum_steps=1,
        attn_chunk=64,
        remat="none",
    )
    if cfg.family == "hybrid":
        # keep the 1:7 interleave with two meta-blocks
        kw["attn_period"] = cfg.attn_period
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
