"""The pipeline's ported stage: the parametric inverse projection (2D →
embedding) checkpointed beside a map, which the service's ``explore``
decodes with. The embedding stage and `run_pipeline` are not ported
yet."""

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

__all__ = [
    "INVERSE_FILE",
    "InverseProjection",
    "inverse_from_frozen",
    "inverse_path",
    "load_inverse",
    "roundtrip_score",
    "save_inverse",
    "train_inverse",
]
