"""Step functions: train (forward, backward, update, microbatched),
prefill and decode (port of the JAX package's ``models/steps.py``).

Batch conventions (as the reference's; labels are pre-shifted targets):
  LM / MoE / SSM / hybrid: {"tokens": (B,S) int, "labels": (B,S) int}
  audio (HuBERT):          {"embeds": (B,S,D), "labels": (B,S) int}
  VLM (InternVL2):         {"tokens": (B,S−P) int, "patches": (B,P,D),
                            "labels": (B,S−P) int}   (P = n_vision_patches)
A batch's arrays may be numpy arrays or tensors; they go to the model's
device. Prefill and decode take no labels.

The dry run's input specs (``batch_specs``, ``cache_specs``,
``input_specs``) are the reference's ``jax.eval_shape`` structures as meta
tensors: the same keys, shapes and dtypes, nothing allocated.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.layers import dtype_of, rms_norm

MOE_AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE: the log-sum-exp of the float32 logits (B, S, V) minus
    the picked logit, over all (B, S) labels."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)


def make_loss_fn(cfg: ArchConfig):
    """``loss_fn(params, batch) -> (loss, {"ce", "moe_aux"})``: the
    cross-entropy over the full float32 logits (the VLM's text positions
    only), plus ``MOE_AUX_COEF``·aux when the config has experts."""

    def loss_fn(params: lm.LM, batch: dict):
        logits, aux, _ = lm.forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                                    patches=batch.get("patches"))
        if cfg.family == "vlm":  # loss on text positions only
            logits = logits[:, cfg.n_vision_patches :, :]
        ce = cross_entropy(logits, lm._on(batch["labels"], logits.device))
        loss = ce + MOE_AUX_COEF * aux if cfg.n_experts else ce
        return loss, {"ce": ce, "moe_aux": aux}

    return loss_fn


# ---------------------------------------------------------------------------
# Train step (with gradient accumulation)
# ---------------------------------------------------------------------------


def _leading(batch: dict, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


def _split(batch: dict, accum: int) -> list:
    """The batch cut into ``accum`` microbatches along its first axis: the
    reference's reshape to (accum, B / accum, …)."""
    out = [dict() for _ in range(accum)]
    for k, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split into {accum} microbatches")
        m = v.shape[0] // accum
        for i in range(accum):
            out[i][k] = v[i * m : (i + 1) * m]
    return out


def make_train_step(cfg: ArchConfig, optimizer, *, microbatched: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    With ``cfg.accum_steps`` A > 1 the batch is A microbatches: cut from
    its first axis, or, with ``microbatched=True``, passed pre-split as
    (A, micro, …) (the production layout; the reference's loader emits
    it). Each microbatch's gradients come from ``torch.autograd.grad`` in
    the weights' dtype, as ``jax.value_and_grad`` gives them, and are
    added into buffers of ``cfg.grad_accum_dtype`` (float32 by default:
    repeated ``.backward()`` would sum bf16 weights' gradients in bf16);
    the sum is divided by A in float32, and the loss is the mean of the
    microbatch losses. With A = 1 (the first of a pre-split batch when
    ``microbatched``) the gradients go to the optimiser as they come.

    The update is in place: ``optimizer.update_`` writes each weight's new
    value into ``params``' parameter a leaf at a time and drops its
    gradient, so the step never holds a second copy of the model. The
    ``params`` returned is the module passed in; ``opt_state`` is new. The
    step runs on the weights' device, under ``lm.trainable``."""
    loss_fn = make_loss_fn(cfg)
    accum = max(cfg.accum_steps, 1)
    acc_dt = dtype_of(cfg.grad_accum_dtype)

    def train_step(params: lm.LM, opt_state, batch: dict):
        with lm.trainable(params) as leaves:
            if accum == 1:
                mb = _leading(batch, 0) if microbatched else batch
                loss, _ = loss_fn(params, mb)
                grads = list(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
                loss = loss.detach()
            else:
                if microbatched:
                    lead = {k: v.shape[0] for k, v in batch.items() if v.shape[0] != accum}
                    if lead:
                        raise ValueError(f"pre-split batch with leading axes {lead}, the config accumulates {accum}")
                    micro = [_leading(batch, i) for i in range(accum)]
                else:
                    micro = _split(batch, accum)
                gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
                lsum = torch.zeros((), dtype=torch.float32, device=params.device)
                for mb in micro:
                    l, _ = loss_fn(params, mb)
                    g = list(torch.autograd.grad(l, leaves, allow_unused=True, materialize_grads=True))
                    for i, a in enumerate(gsum):
                        a.add_(g[i].to(acc_dt))
                        g[i] = None
                    lsum = lsum + l.detach()
                    del g, l
                grads = [a.div_(accum) if a.dtype == torch.float32 else a.float() / accum for a in gsum]
                del gsum
                loss = lsum / accum
        opt_state = optimizer.update_(leaves, grads, opt_state)
        return params, opt_state, loss

    return train_step


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


# ---------------------------------------------------------------------------
# Input specs (dry run): meta tensors
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *, with_labels: bool, microbatched: bool = False) -> dict:
    """The batch of a shape cell as meta tensors, in the reference's keys;
    ``microbatched`` train batches lead with ``accum_steps``."""
    B, S = shape.global_batch, shape.seq_len
    cd = dtype_of(cfg.compute_dtype)
    lead: tuple = ()
    if microbatched and shape.kind == "train" and cfg.accum_steps > 1:
        if B % cfg.accum_steps:
            raise ValueError(f"global batch {B} does not split into {cfg.accum_steps} microbatches")
        lead = (cfg.accum_steps,)
        B = B // cfg.accum_steps
    spec: dict = {}
    if cfg.family == "audio":
        spec["embeds"] = _meta(lead + (B, S, cfg.d_model), cd)
    elif cfg.family == "vlm":
        P = cfg.n_vision_patches
        spec["tokens"] = _meta(lead + (B, S - P), torch.int32)
        spec["patches"] = _meta(lead + (B, P, cfg.d_model), cd)
    else:
        spec["tokens"] = _meta(lead + (B, S), torch.int32)
    if with_labels:
        lab_len = S - cfg.n_vision_patches if cfg.family == "vlm" else S
        spec["labels"] = _meta(lead + (B, lab_len), torch.int32)
    return spec


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The decode cache of a shape cell on the meta device (``idx`` a
    Python int, as the port keeps it)."""
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, optimizer=None) -> tuple:
    """The step's positional arguments as meta tensors: ``(params,
    opt_state, batch)`` for train (``optimizer.init`` of the meta weights,
    microbatched), ``(params, batch)`` for prefill and ``(params, cache,
    token)`` for decode."""
    params = lm.abstract_params(cfg)
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train cell's specs need the optimizer")
        opt_state = optimizer.init(list(params.parameters()))
        return params, opt_state, batch_specs(cfg, shape, with_labels=True, microbatched=True)
    if shape.kind == "prefill":
        return params, batch_specs(cfg, shape, with_labels=False)
    return params, cache_specs(cfg, shape), _meta((shape.global_batch, 1), torch.int32)
