"""Carry the JAX package's model weights into the port.

:func:`from_reference` takes the tree ``repro.models.lm.init_params``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), and a port
:class:`~repro_torch.configs.base.ArchConfig`, and returns the port's
:class:`~repro_torch.models.lm.LM` holding the same values. The port keeps
the reference's layouts (``wq (D, H, hd)``, ``wo (H, hd, D)``, experts
``(E, D, F)``), so each leaf is a copy: the stacked ``(L, …)`` leaves are
cut into one block per layer, a Jamba meta-block's stacked ``mamba``/
``moe``/``dense`` leaves into their lists, and padded heads and vocabulary
columns (``head_pad_to``/``vocab_pad_to``) come across as they are, checked
against the config. bfloat16 leaves widen to float32 exactly on the way and
land in the config's dtypes (``layers.leaf_dtype``: the router and the
SSM's A_log/D/dt_bias stay float32).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import AttnParams
from repro_torch.models.layers import SwiGLU, leaf_dtype
from repro_torch.models.lm import LM, Layer, MetaBlock
from repro_torch.models.moe import MoEParams
from repro_torch.models.ssm import SSMParams


def _get(node, name: str):
    """A field of a reference node: a dict key or a NamedTuple attribute."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


class _Leaves:
    """Cuts the reference's stacked leaves: ``at(i)`` indexes every leaf's
    leading axis, ``t(name)`` reads one leaf as a tensor."""

    def __init__(self, node, index: tuple, device, param_dtype: str):
        self.node, self.index, self.device, self.param_dtype = node, index, device, param_dtype

    def at(self, name: str, *i: int) -> "_Leaves":
        return _Leaves(_get(self.node, name), self.index + i, self.device, self.param_dtype)

    def has(self, name: str) -> bool:
        try:
            return _get(self.node, name) is not None
        except (KeyError, AttributeError):
            return False

    def t(self, name: str) -> torch.Tensor:
        a = np.array(np.asarray(_get(self.node, name))[self.index], np.float32)  # bfloat16 → float32 is exact
        return torch.from_numpy(a).to(self.device).to(leaf_dtype(name, self.param_dtype))


def _attention(n: _Leaves) -> AttnParams:
    return AttnParams(n.t("wq"), n.t("wk"), n.t("wv"), n.t("wo"),
                      n.t("q_norm") if n.has("q_norm") else None,
                      n.t("k_norm") if n.has("k_norm") else None)


def _swiglu(n: _Leaves) -> SwiGLU:
    return SwiGLU(n.t("w_gate"), n.t("w_up"), n.t("w_down"))


def _ssm(n: _Leaves) -> SSMParams:
    return SSMParams(**{f: n.t(f) for f in SSMParams.FIELDS})


def _moe(n: _Leaves) -> MoEParams:
    shared = _swiglu(n.at("shared")) if n.has("shared") else None
    return MoEParams(n.t("router"), n.t("w_gate"), n.t("w_up"), n.t("w_down"), shared)


def _layer(n: _Leaves) -> Layer:
    kw: dict[str, Any] = {"attn": _attention(n.at("attn"))} if n.has("attn") else {"ssm": _ssm(n.at("ssm"))}
    if n.has("ln2"):
        kw["ln2"] = n.t("ln2")
        kw["moe" if n.has("moe") else "mlp"] = _moe(n.at("moe")) if n.has("moe") else _swiglu(n.at("mlp"))
    return Layer(n.t("ln1"), **kw)


def _meta_block(n: _Leaves, cfg: ArchConfig) -> MetaBlock:
    n_moe = sum(1 for i in range(cfg.attn_period) if i % cfg.moe_period == cfg.moe_offset)
    return MetaBlock(
        attn_ln=n.t("attn_ln"),
        attn=_attention(n.at("attn")),
        mamba_ln=n.t("mamba_ln"),
        mamba=[_ssm(n.at("mamba", j)) for j in range(cfg.attn_period - 1)],
        moe_ln=n.t("moe_ln"),
        moe=[_moe(n.at("moe", j)) for j in range(n_moe)],
        dense_ln=n.t("dense_ln"),
        dense=[_swiglu(n.at("dense", j)) for j in range(cfg.attn_period - n_moe)],
    )


def from_reference(tree: dict, cfg: ArchConfig, *, device=None) -> LM:
    """The port's model holding the reference tree's values (see the module
    docstring); on ``device`` (default: the card, as every entry point of
    the port; the CPU only when asked for, and without a card this raises
    as ``index.build.resolve_device`` does)."""
    from repro_torch.index.build import resolve_device

    device = resolve_device(device)
    root = _Leaves(tree, (), device, cfg.param_dtype)
    vocab = np.shape(tree["head"])[1] if cfg.family == "audio" else np.shape(tree["embed"])[0]
    if vocab != cfg.vocab_padded:
        raise ValueError(f"vocabulary of {vocab} rows, the config pads to {cfg.vocab_padded}")
    if cfg.n_heads:
        stack = tree["blocks" if cfg.family == "hybrid" else "layers"]
        heads = np.shape(_get(_get(stack, "attn"), "wq"))[-2]
        if heads != cfg.n_heads_padded:
            raise ValueError(f"{heads} query heads, the config pads to {cfg.n_heads_padded}")
    kw: dict[str, Any] = {}
    if cfg.family == "audio":
        kw.update(in_ln=root.t("in_ln"), head=root.t("head"))
    else:
        kw["embed"] = root.t("embed")
    if cfg.family == "hybrid":
        kw["blocks"] = [_meta_block(root.at("blocks", m), cfg) for m in range(cfg.n_layers // cfg.attn_period)]
    else:
        kw["layers"] = [_layer(root.at("layers", i)) for i in range(cfg.n_layers)]
    return LM(cfg, final_ln=root.t("final_ln"), **kw)
