"""Checkpoints of the fit: the JAX package's on-disk format, the port's own
code (pure numpy; the port imports nothing of ``repro``)."""

from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    latest_step,
    load_metadata,
    load_theta,
)

__all__ = ["Checkpointer", "latest_step", "load_metadata", "load_theta"]
