"""NOMAD Projection workload configs — the paper's own experiments (port copy).

* ``nomad_quickstart`` — CPU-sized synthetic workload used by examples/tests.
* ``nomad_pubmed``     — Table-1-scale workload (PubMed: ~24M abstracts,
  768-d BERT embeddings in the paper; sized for the production mesh here).
* ``nomad_wiki60m``    — the paper's flagship: 60M-point Multilingual
  Wikipedia map (BGE-M3, 1024-d), the largest published data map.

End-to-end *pipeline* workloads (:data:`PIPELINE_WORKLOADS`) pair a zoo
architecture with a token corpus and a map config: the paper's headline
result maps embeddings produced by a real model, and these are the named
embed→store→fit→serve→explore runs ``repro_torch.pipeline`` drives across
the architecture families (dense attention, SSM, MoE). Sizes here are
CPU-smoke defaults.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import NomadConfig

QUICKSTART = NomadConfig(
    name="nomad_quickstart",
    n_points=20_000,
    dim=64,
    n_clusters=16,
    n_neighbors=15,
    n_noise=64,
    n_exact_negatives=8,
    batch_size=2_048,
    n_epochs=200,  # epochs are cheap; quality scales with them (Fig. 3)
)

PUBMED = NomadConfig(
    name="nomad_pubmed",
    n_points=24_000_000,
    dim=768,
    n_clusters=4_096,
    n_neighbors=15,
    n_noise=128,
    n_exact_negatives=16,
    batch_size=8_192,
    n_epochs=60,
    kmeans_iters=50,
)

WIKI60M = NomadConfig(
    name="nomad_wiki60m",
    n_points=60_000_000,
    dim=1024,
    n_clusters=8_192,
    n_neighbors=15,
    n_noise=128,
    n_exact_negatives=16,
    batch_size=8_192,
    n_epochs=80,
    kmeans_iters=50,
)

NOMAD_WORKLOADS = {c.name: c for c in (QUICKSTART, PUBMED, WIKI60M)}


# ---------------------------------------------------------------------------
# End-to-end embed→map→explore pipeline workloads
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineWorkload:
    """One named embed→store→fit→serve→explore run.

    ``arch`` keys :data:`repro_torch.configs.ARCHS`; the embedder is the
    CPU-reduced form of that architecture (``reduced(...)`` with the
    overrides below), so every family's *real forward pass* — attention,
    SSD scan, MoE routing — produces the vectors, not a stand-in matrix.
    The token corpus is :func:`repro_torch.data.synthetic.class_token_corpus`
    at ``(n_docs, seq_len, n_classes)``; the map config comes from
    :meth:`nomad_config` with ``n_points``/``dim`` filled in by the
    pipeline (``dim`` is only known after the embedder is built).
    """

    name: str
    arch: str  # repro_torch.configs.ARCHS key
    # corpus
    n_docs: int = 2_048
    seq_len: int = 64
    n_classes: int = 8
    doc_batch: int = 128  # token rows per embed forward (divides n_docs)
    pool: str = "mean"  # "mean" | "last"
    # embedder reduction (CPU-sized; family topology is preserved)
    n_layers: int = 2
    d_model: int = 128
    vocab_size: int = 512
    # map
    n_clusters: int = 16
    n_neighbors: int = 15
    n_epochs: int = 15
    batch_size: int = 512

    def arch_config(self, **overrides):
        """The reduced :class:`ArchConfig` of this workload's embedder."""
        from repro_torch.configs import ARCHS, reduced

        kw = dict(
            n_layers=self.n_layers,
            d_model=self.d_model,
            vocab_size=self.vocab_size,
        )
        kw.update(overrides)
        return reduced(ARCHS[self.arch], **kw)

    def nomad_config(self, n_points: int, dim: int, **overrides) -> NomadConfig:
        """The map config for a corpus of ``n_points`` ``dim``-d vectors."""
        kw = dict(
            name=self.name,
            n_points=n_points,
            dim=dim,
            n_clusters=self.n_clusters,
            n_neighbors=self.n_neighbors,
            n_epochs=self.n_epochs,
            batch_size=min(self.batch_size, n_points),
        )
        kw.update(overrides)
        return NomadConfig(**kw)


# ≥3 architecture families: dense attention (phi4), SSM/SSD (mamba2),
# MoE (mixtral). The embed stage is family-agnostic by construction —
# anything ARCHS carries slots in as a fourth entry with one line.
PIPELINE_WORKLOADS = {
    w.name: w
    for w in (
        PipelineWorkload(name="pipeline_phi4_mini", arch="phi4-mini-3.8b"),
        PipelineWorkload(name="pipeline_mamba2_2_7b", arch="mamba2-2.7b"),
        PipelineWorkload(name="pipeline_mixtral_8x7b", arch="mixtral-8x7b"),
    )
}
