"""Checkpoints of the fit and the lineage of a grown map: the JAX package's
on-disk formats, the port's own code (pure numpy; the port imports nothing
of ``repro``)."""

from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    latest_step,
    load_metadata,
    load_theta,
)
from repro_torch.checkpoint.lineage import VERSIONS_FILE, MapLineage, MapVersion

__all__ = [
    "Checkpointer",
    "MapLineage",
    "MapVersion",
    "VERSIONS_FILE",
    "latest_step",
    "load_metadata",
    "load_theta",
]
