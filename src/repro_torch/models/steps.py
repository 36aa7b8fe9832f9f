"""Step functions for serving: prefill and decode (port of the JAX
package's ``models/steps.py``).

Batch conventions (as the reference's):
  LM / MoE / SSM / hybrid: {"tokens": (B,S) int}
  audio (HuBERT):          {"embeds": (B,S,D)}
  VLM (InternVL2):         {"tokens": (B,S−P) int, "patches": (B,P,D)}   (P = n_vision_patches)

The training step (``cross_entropy``, ``make_loss_fn``, ``make_train_step``)
and the ``jax.eval_shape`` dry-run helpers (``batch_specs``,
``cache_specs``, ``input_specs``) are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.layers import rms_norm


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (logits (B, 1, V) fp32, cache)``:
    the last position's logits, which serving wants, and the cache
    stacked over layers (None for an encoder-only model). Only the last
    position goes through the final norm and the vocabulary product: the
    same values as the reference's full logits sliced, without the
    (B, S, V) float32 tensor. Runs under ``torch.inference_mode``."""

    def prefill_step(params: lm.LM, batch: dict):
        with torch.inference_mode():
            x = lm.embed_in(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                            patches=batch.get("patches"))
            x, _, cache = lm.body(params, cfg, x, with_cache=not cfg.encoder_only)
            x = rms_norm(x[:, -1:], params.final_ln)
            return lm.logits_out(params, cfg, x), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, token) -> (logits (B, 1, V), cache)``;
    the cache passed in is consumed (``lm.decode_step``)."""

    def decode_step(params: lm.LM, cache: dict, token):
        return lm.decode_step(params, cfg, cache, token)

    return decode_step
