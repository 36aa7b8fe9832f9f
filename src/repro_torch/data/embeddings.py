"""Embedding-extraction bridge: model zoo → NOMAD Projection (port of the
JAX package's ``data/embeddings.py``).

Any zoo architecture plays the role of the paper's external embedding
models: run it over token batches, pool the final hidden states, and the
vectors feed ``NomadProjection``. The forward runs under
``torch.inference_mode`` on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.layers import rms_norm


def hidden_states(params: lm.LM, cfg: ArchConfig, tokens=None, embeds=None, patches=None) -> torch.Tensor:
    """Forward pass returning the final-norm hidden states (B, S, D), in the
    compute dtype, on the model's device."""
    with torch.inference_mode():
        x = lm.embed_in(params, cfg, tokens=tokens, embeds=embeds, patches=patches)
        x, _, _ = lm.body(params, cfg, x)
        return rms_norm(x, params.final_ln)


def pool_hidden(h: torch.Tensor, pool: str) -> torch.Tensor:
    """(B, S, D) hidden states → (B, D) float32: the mean over S taken in
    the compute dtype then widened (the reference's casts), or the last
    position."""
    if pool == "mean":
        v = torch.mean(h, dim=1)
    elif pool == "last":
        v = h[:, -1, :]
    else:
        raise ValueError(f"unknown pool {pool!r} (want 'mean'|'last')")
    return v.float()


def embed_corpus(params: lm.LM, cfg: ArchConfig, token_batches, *, pool: str = "mean") -> np.ndarray:
    """Iterate token batches (B, S) → pooled vectors (N, D) float32 on host."""
    outs = [pool_hidden(hidden_states(params, cfg, tokens=toks), pool).cpu().numpy() for toks in token_batches]
    return np.concatenate(outs, axis=0)
