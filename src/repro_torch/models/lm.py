"""Model composition for all zoo architectures (port of the JAX package's
``models/lm.py``, the sequence forward).

One code path per *family topology*:

* homogeneous decoder (dense / moe / ssm): an ``nn.ModuleList`` of L
  identical :class:`Layer` blocks (the reference scans stacked leaves);
* hybrid (Jamba): a list of M = L/8 :class:`MetaBlock`, each an
  [attention, mamba×7] stack with MoE on odd positions (1:7 interleave,
  MoE every second layer);
* encoder (HuBERT): bidirectional homogeneous stack over stub frame
  embeddings, untied classification head;
* VLM (InternVL2): stub patch embeddings prepended to text embeddings,
  causal LM over the combined sequence.

The caches, ``decode_step`` and the activation-sharding hint are not
ported: this is the forward the embed pipeline runs.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dtype_of, frozen, init_embedding, init_linear, init_swiglu, leaf_dtype, rms_norm


class Layer(torch.nn.Module):
    """One homogeneous layer: ``ln1`` and attention or a Mamba-2 block,
    then (when ``d_ff``) ``ln2`` and an MoE or a dense SwiGLU."""

    def __init__(self, ln1, *, attn=None, ssm=None, ln2=None, moe=None, mlp=None):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.attn, self.ssm = attn, ssm
        self.ln2 = None if ln2 is None else frozen(ln2)
        self.moe, self.mlp = moe, mlp

    def forward(self, x, aux, positions, cfg: ArchConfig, causal: bool):
        h = rms_norm(x, self.ln1)
        if self.attn is not None:
            x = x + self.attn(h, positions, cfg, causal=causal)
        else:
            x = x + self.ssm(h, cfg)[0]
        if cfg.d_ff:
            h = rms_norm(x, self.ln2)
            if self.moe is not None:
                y, moe_aux = self.moe(h, cfg)
                aux = aux + moe_aux
            else:
                y = self.mlp(h)
            x = x + y
        return x, aux


class MetaBlock(torch.nn.Module):
    """One Jamba meta-block: position 0 attention, positions 1..7 Mamba-2;
    an MLP at every position, MoE on the positions ``moe_period`` and
    ``moe_offset`` pick, dense on the others. The Mamba, MoE and dense
    weights are separate lists, indexed by their own counters as the
    reference indexes its stacked leaves."""

    def __init__(self, attn_ln, attn, mamba_ln, mamba, moe_ln, moe, dense_ln, dense):
        super().__init__()
        self.attn_ln, self.attn = frozen(attn_ln), attn
        self.mamba_ln, self.mamba = frozen(mamba_ln), torch.nn.ModuleList(mamba)  # (n_mamba, D)
        self.moe_ln, self.moe = frozen(moe_ln), torch.nn.ModuleList(moe)  # (n_moe, D)
        self.dense_ln, self.dense = frozen(dense_ln), torch.nn.ModuleList(dense)  # (n_dense, D)

    def _mlp_at(self, x, pos: int, counters, aux, cfg: ArchConfig):
        moe_i, dense_i = counters
        if pos % cfg.moe_period == cfg.moe_offset:
            y, moe_aux = self.moe[moe_i](rms_norm(x, self.moe_ln[moe_i]), cfg)
            return x + y, (moe_i + 1, dense_i), aux + moe_aux
        y = self.dense[dense_i](rms_norm(x, self.dense_ln[dense_i]))
        return x + y, (moe_i, dense_i + 1), aux

    def forward(self, x, aux, positions, cfg: ArchConfig, causal: bool):
        x = x + self.attn(rms_norm(x, self.attn_ln), positions, cfg, causal=causal)
        counters = (0, 0)
        x, counters, aux = self._mlp_at(x, 0, counters, aux, cfg)
        for pos in range(1, cfg.attn_period):
            x = x + self.mamba[pos - 1](rms_norm(x, self.mamba_ln[pos - 1]), cfg)[0]
            x, counters, aux = self._mlp_at(x, pos, counters, aux, cfg)
        return x, aux


class LM(torch.nn.Module):
    """A zoo model's weights and its configuration. ``embed`` (Vp, D), or
    for the audio family ``in_ln`` and an untied ``head`` (D, Vp);
    ``layers`` (homogeneous) or ``blocks`` (hybrid); ``final_ln``.
    :meth:`forward` is :func:`forward`."""

    def __init__(self, cfg: ArchConfig, *, final_ln, layers=None, blocks=None, embed=None, in_ln=None,
                 head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = None if embed is None else frozen(embed)
        self.in_ln = None if in_ln is None else frozen(in_ln)
        self.head = None if head is None else frozen(head)
        self.layers = None if layers is None else torch.nn.ModuleList(layers)
        self.blocks = None if blocks is None else torch.nn.ModuleList(blocks)
        self.final_ln = frozen(final_ln)

    @property
    def device(self) -> torch.device:
        return self.final_ln.device

    def forward(self, tokens=None, embeds=None, patches=None):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds, patches=patches)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _ones(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)


def _init_homogeneous_layer(gen: torch.Generator, cfg: ArchConfig, is_moe: bool, is_attn: bool) -> Layer:
    dt = dtype_of(cfg.param_dtype)
    kw = {"attn": attn_lib.init_attention(gen, cfg)} if is_attn else {"ssm": ssm_lib.init_ssm(gen, cfg)}
    if cfg.d_ff:
        kw["ln2"] = _ones(gen, (cfg.d_model,), dt)
        if is_moe:
            kw["moe"] = moe_lib.init_moe(gen, cfg)
        else:
            kw["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dt)
    return Layer(_ones(gen, (cfg.d_model,), dt), **kw)


def _init_meta_block(gen: torch.Generator, cfg: ArchConfig) -> MetaBlock:
    """One Jamba meta-block: pos 0 = attention, pos 1..7 = mamba.

    MLP at every position; MoE on odd positions (1,3,5,7), dense on even.
    """
    P = cfg.attn_period  # 8
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    n_mamba = P - 1
    n_moe = sum(1 for i in range(P) if i % cfg.moe_period == cfg.moe_offset)
    n_dense = P - n_moe
    return MetaBlock(
        attn_ln=_ones(gen, (D,), dt),
        attn=attn_lib.init_attention(gen, cfg),
        mamba_ln=_ones(gen, (n_mamba, D), dt),
        mamba=[ssm_lib.init_ssm(gen, cfg) for _ in range(n_mamba)],
        moe_ln=_ones(gen, (n_moe, D), dt),
        moe=[moe_lib.init_moe(gen, cfg) for _ in range(n_moe)],
        dense_ln=_ones(gen, (n_dense, D), dt),
        dense=[init_swiglu(gen, D, cfg.d_ff, dt) for _ in range(n_dense)],
    )


def init_params(cfg: ArchConfig, *, generator: torch.Generator) -> LM:
    """A randomly initialised model on the generator's device, drawn in a
    fixed order from ``generator`` (the reference's distributions; the
    draws are PyTorch's)."""
    gen = generator
    dt = dtype_of(cfg.param_dtype)
    kw = {}
    if cfg.family == "audio":
        # stub frontend supplies frame embeddings; no token embedding table
        kw["in_ln"] = _ones(gen, (cfg.d_model,), dt)
        kw["head"] = init_linear(gen, cfg.d_model, cfg.vocab_padded, dt)
    else:
        kw["embed"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt)
    if cfg.family == "hybrid":
        kw["blocks"] = [_init_meta_block(gen, cfg) for _ in range(cfg.n_layers // cfg.attn_period)]
    else:
        is_moe, is_attn = cfg.layer_is_moe(0), cfg.layer_is_attention(0)
        kw["layers"] = [_init_homogeneous_layer(gen, cfg, is_moe, is_attn) for _ in range(cfg.n_layers)]
    return LM(cfg, final_ln=_ones(gen, (cfg.d_model,), dt), **kw)


def n_params(params: LM) -> int:
    """The model's parameter count, as allocated."""
    return sum(p.numel() for p in params.parameters())


def cast(params: LM, cfg: ArchConfig) -> LM:
    """A copy of ``params`` holding ``cfg``, each weight in its
    ``layers.leaf_dtype`` for ``cfg.param_dtype`` (the float32 leaves stay
    float32)."""
    out = copy.deepcopy(params)
    out.cfg = cfg
    for name, p in out.named_parameters():
        p.data = p.data.to(leaf_dtype(name.rsplit(".", 1)[-1], cfg.param_dtype))
    return out


# ---------------------------------------------------------------------------
# Embedding in / logits out
# ---------------------------------------------------------------------------


def _on(t, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    t = torch.as_tensor(t)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def embed_in(params: LM, cfg: ArchConfig, tokens=None, embeds=None, patches=None) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    dev = params.device
    if cfg.family == "audio":
        return rms_norm(_on(embeds, dev).to(cd), params.in_ln)
    x = params.embed[_on(tokens, dev).long()].to(cd)  # the gather stays on the model's device
    if cfg.family == "vlm":
        x = torch.cat([_on(patches, dev).to(cd), x], dim=1)
    return x


def logits_out(params: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        logits = (x @ params.head).float()
    else:
        logits = (x @ params.embed.t().to(x.dtype)).float()
    if cfg.vocab_padded != cfg.vocab_size:  # inert pad columns
        pad_ok = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_ok, logits, torch.full((), -1e30, device=x.device))
    return logits


# ---------------------------------------------------------------------------
# Sequence forward
# ---------------------------------------------------------------------------


def body(params: LM, cfg: ArchConfig, x: torch.Tensor):
    """The layers over embedded inputs x (B, S, D) → (x, moe aux) before
    the final norm: the homogeneous stack or the Jamba meta-blocks."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    causal = not cfg.encoder_only
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.blocks if cfg.family == "hybrid" else params.layers:
        x, aux = block(x, aux, positions, cfg, causal)
    return x, aux


def forward(params: LM, cfg: ArchConfig, tokens=None, embeds=None, patches=None):
    """Sequence forward. Returns (logits fp32, moe_aux)."""
    x = embed_in(params, cfg, tokens=tokens, embeds=embeds, patches=patches)
    x, aux = body(params, cfg, x)
    x = rms_norm(x, params.final_ln)
    return logits_out(params, cfg, x), aux
