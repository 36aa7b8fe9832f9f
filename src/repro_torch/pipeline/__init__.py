"""The end-to-end embed→store→fit→serve→explore pipeline.

* :mod:`repro_torch.pipeline.embed`   — stage 1: streaming model embedding
  (pooled forwards land directly in a sharded store; the ``(N, D)``
  matrix never materialises on host).
* :mod:`repro_torch.pipeline.inverse` — stage 2: the parametric inverse
  projection (2D → embedding MLP) checkpointed beside the map.
* :mod:`repro_torch.pipeline.run`     — the driver tying them to a fit; its
  output directory is exactly what ``MapRegistry.load`` serves, giving
  stage 3 (the service's ``explore``) its data.

Named workloads across the architecture families live in
:data:`repro_torch.configs.PIPELINE_WORKLOADS`.
"""

from repro_torch.pipeline.embed import (
    corpus_for,
    embed_chunks,
    embed_dim,
    embed_to_store,
    init_embedder,
    make_embed_fn,
)
from repro_torch.pipeline.inverse import (
    INVERSE_FILE,
    InverseProjection,
    inverse_from_frozen,
    inverse_path,
    load_inverse,
    roundtrip_score,
    save_inverse,
    train_inverse,
)
from repro_torch.pipeline.run import PipelineResult, run_pipeline

__all__ = [
    "corpus_for",
    "embed_chunks",
    "embed_dim",
    "embed_to_store",
    "init_embedder",
    "make_embed_fn",
    "INVERSE_FILE",
    "InverseProjection",
    "inverse_from_frozen",
    "inverse_path",
    "load_inverse",
    "roundtrip_score",
    "save_inverse",
    "train_inverse",
    "PipelineResult",
    "run_pipeline",
]
