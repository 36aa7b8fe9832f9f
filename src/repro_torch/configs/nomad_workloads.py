"""NOMAD workload configs from the paper's own experiments (port copy).

* ``QUICKSTART`` — CPU-sized synthetic workload used by examples/tests.
* ``PUBMED``     — Table-1-scale workload: ~24M PubMed abstracts as 768-d
  BERT embeddings in the paper.
"""

from __future__ import annotations

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
    n_epochs=200,
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
