"""Per-architecture sharding rules (port of the JAX package's
``launch/sharding.py``) as placement specs over a mesh's named axes.

Conventions on the production mesh (``pod``?, ``data``, ``model``), the
reference's:

* FSDP (zero-3): every weight matrix shards its d_model-ish dim over
  ``data``; optimizer moments follow their parameter.
* TP over ``model``: attention's H dim (wq/wo), the MLP's hidden F, the
  vocabulary V. kv projections are replicated over ``model``.
* EP over ``model`` for MoE when E % model == 0, else TP inside the
  experts (F over ``model``).
* The batch shards over (pod, data); a decode cell whose batch is smaller
  than those axes puts the cache length on ``model`` (and on every axis for
  batch 1): the length-sharded flash-decode.
* ``pod`` is pure data parallelism for weights.

A spec is a :class:`P`: one entry per dimension of the tensor, each an axis
name, a tuple of axis names (folded first-outermost) or None (not split).
The functions read only ``mesh.shape``, so a shape-only mesh (an object
with a ``shape`` dict) works as well as a :class:`repro_torch.launch.mesh.
Mesh` of shard slots.

The reference's rules are trailing-dimension specs matched on each leaf's
path, its scan-stacked ``(L, …)`` leading dims padded with None. The port's
LM keeps one module per layer (``models/convert.py``), so the same rules
match on ``named_parameters()``'s names (``layers.3.attn.wq``,
``blocks.0.moe.1.w_up``) and a leaf's spec is the reference's stacked spec
without its leading Nones. :func:`repro_torch.launch.mesh.local_block`
cuts a slot's block of a global tensor under a spec; the sharded MoE,
decode and pipeline modules cut their weights, caches and batches with
it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import P, assemble, axis_size, block_range, local_block, without  # noqa: F401
from repro_torch.optim.quantized import QTensor


def _fit(trailing: Sequence, ndim: int) -> P:
    """A trailing-dims rule on an ``ndim`` leaf: Nones before it, or its
    last ``ndim`` entries when it is longer (the reference pads its stacked
    leaves the same way, so the two agree past the leading dims)."""
    t = list(trailing)
    return P(*([None] * (ndim - len(t)) + t)) if len(t) <= ndim else P(*t[len(t) - ndim:])


def _expert_parallel(cfg: ArchConfig, mesh) -> bool:
    return cfg.n_experts > 0 and cfg.n_experts % mesh.shape["model"] == 0


def serving_weights_resident(cfg: ArchConfig, mesh, budget_gib: float = 12.0) -> bool:
    """Can bf16 weights live TP-only (no per-token FSDP gathers) on this mesh?"""
    total = cfg.param_counts()["total"] * 2 / mesh.shape["model"]
    return total <= budget_gib * 2**30


def _param_rules(cfg: ArchConfig, mesh, serving: bool = False) -> list:
    """Ordered (substrings, trailing-dims spec) rules, the reference's.

    ``serving``: decode wants weights resident, so the dense weights drop
    the ``data`` axis; the experts too when the whole model fits TP-only,
    else (the 100B+ MoE archs) the weights-stationary layout: E over
    ``model``, F over ``data`` (``models/moe.py:set_ep_mesh(stationary=
    True)``)."""
    ep = _expert_parallel(cfg, mesh)
    dd = None if serving else "data"
    if serving and not serving_weights_resident(cfg, mesh) and ep:
        moe_gu = ["model", None, "data"]
        moe_d = ["model", "data", None]
    else:
        ed = None if (serving and serving_weights_resident(cfg, mesh)) else "data"
        moe_gu = ["model", ed, None] if ep else [None, ed, "model"]
        moe_d = ["model", None, ed] if ep else [None, "model", ed]
    return [
        # MoE (before the generic MLP rules; 'moe' is in the path)
        (("moe", "router"), [dd, None]),
        (("moe", "w_gate"), moe_gu),
        (("moe", "w_up"), moe_gu),
        (("moe", "w_down"), moe_d),
        (("moe", "shared", "w_gate"), [dd, "model"]),
        (("moe", "shared", "w_up"), [dd, "model"]),
        (("moe", "shared", "w_down"), ["model", dd]),
        # attention
        (("wq",), [dd, "model", None]),
        (("wk",), [dd, None, None]),
        (("wv",), [dd, None, None]),
        (("wo",), ["model", None, dd]),
        # dense MLP
        (("w_gate",), [dd, "model"]),
        (("w_up",), [dd, "model"]),
        (("w_down",), ["model", dd]),
        # SSM (split projections)
        (("w_z",), [dd, "model"]),
        (("w_x",), [dd, "model"]),
        (("w_b",), [dd, None]),
        (("w_c",), [dd, None]),
        (("w_dt",), [dd, "model"]),
        (("w_out",), ["model", dd]),
        (("conv_x",), [None, "model"]),
        (("conv_b",), [None, None]),
        (("conv_c",), [None, None]),
        # embeddings and heads
        (("embed",), ["model", dd]),
        (("head",), [dd, "model"]),
    ]


def _sorted_rules(cfg, mesh, serving=False) -> list:
    # the shared-expert rule must win over the generic MoE rule: most
    # specific (most substrings) first, stable otherwise
    return sorted(_param_rules(cfg, mesh, serving), key=lambda r: -len(r[0]))


def _rule_for(name: str, rules) -> Optional[list]:
    for keys, trailing in rules:
        if all(k in name for k in keys):
            return list(trailing)
    return None


def _leaf_spec(name: str, ndim: int, rules) -> P:
    t = _rule_for(name, rules)
    return P(*([None] * ndim)) if t is None else _fit(t, ndim)  # norms, biases: replicated


def param_pspec_tree(cfg: ArchConfig, mesh, params, serving: bool = False) -> dict:
    """``{name: P}`` over ``params.named_parameters()`` (meta tensors work)."""
    rules = _sorted_rules(cfg, mesh, serving)
    return {name: _leaf_spec(name, t.dim(), rules) for name, t in params.named_parameters()}


def opt_state_pspec_tree(cfg: ArchConfig, mesh, opt_state: dict, params) -> dict:
    """Specs of an :class:`repro_torch.optim.AdamW` state for ``params``
    (the module whose ``parameters()`` it was made from): each moment
    follows its parameter. An int8 payload keeps the parameter's shape, so
    its spec; its per-row ``scale`` drops the last axis, so the spec minus
    its last entry. ``count`` is replicated."""
    rules = _sorted_rules(cfg, mesh)
    names = [n for n, _ in params.named_parameters()]

    def moment(name, x):
        if isinstance(x, QTensor):
            t = _rule_for(name, rules)
            q = _leaf_spec(name, x.q.dim(), rules)
            scale = P(*([None] * x.scale.dim())) if t is None else _fit(t[:-1], x.scale.dim())
            return QTensor(q=q, scale=scale, sqrt_scaled=x.sqrt_scaled)
        return _leaf_spec(name, x.dim(), rules)

    mu = [{k: moment(name, mv[k]) for k in mv} for name, mv in zip(names, opt_state["mu"])]
    return {"mu": mu, "count": P()}


def _dp(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in _dp(mesh)]))


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Input-batch specs. Train batches arrive pre-split into (accum,
    micro, …), so the microbatch loop never reshapes a sharded dim."""
    dp = _dp(mesh)
    micro = shape.global_batch // (cfg.accum_steps if shape.kind == "train" else 1)
    bdim = dp if micro % _dp_size(mesh) == 0 else ("data" if micro % mesh.shape["data"] == 0 else None)
    lead = (None,) if shape.kind == "train" and cfg.accum_steps > 1 else ()
    spec: dict = {}
    if cfg.family == "audio":
        spec["embeds"] = P(*lead, bdim, None, None)
    elif cfg.family == "vlm":
        spec["tokens"] = P(*lead, bdim, None)
        spec["patches"] = P(*lead, bdim, None, None)
    else:
        spec["tokens"] = P(*lead, bdim, None)
    if shape.kind == "train":
        spec["labels"] = P(*lead, bdim, None)
    return spec


def decode_axes(shape: ShapeConfig, mesh) -> tuple:
    """(batch entry, cache-length entry) of a decode cell: the batch over
    the data-parallel axes and the length over ``model`` when the batch
    divides them, else the length over every axis and the batch whole."""
    dp = _dp(mesh)
    if shape.global_batch % _dp_size(mesh) == 0:
        return dp, "model"
    return None, dp + ("model",)


def cache_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh, cache: dict) -> dict:
    """Decode-cache specs (``lm.init_cache``'s keys)."""
    bspec, sspec = decode_axes(shape, mesh)
    specs: dict = {"idx": P()}
    if "k" in cache:
        # (L or M, B, Sc, KV, hd)
        specs["k"] = P(None, bspec, sspec, None, None)
        specs["v"] = P(None, bspec, sspec, None, None)
        specs["pos"] = P(sspec)
    if "ssm_h" in cache:
        # (L, B, H, P, N) or (M, n_mamba, B, H, P, N): heads over model
        specs["ssm_h"] = P(*[None] * (cache["ssm_h"].dim() - 4), bspec, "model", None, None)
        lead = [None] * (cache["ssm_tx"].dim() - 3)
        # the x tail's channels are d_inner (model-divisible); the B/C tails are N wide
        specs["ssm_tx"] = P(*lead, bspec, None, "model")
        specs["ssm_tb"] = P(*lead, bspec, None, None)
        specs["ssm_tc"] = P(*lead, bspec, None, None)
    return specs


def step_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, specs) -> tuple:
    """(in specs, out specs) of the step of this shape cell; ``specs`` is
    ``models.steps.input_specs``' positional tuple (its first entry the
    LM, whose parameter names key the weights' specs)."""
    params = specs[0]
    p_specs = param_pspec_tree(cfg, mesh, params)
    bdim = _dp(mesh) if shape.global_batch % _dp_size(mesh) == 0 else None
    if shape.kind == "train":
        o_specs = opt_state_pspec_tree(cfg, mesh, specs[1], params)
        b_specs = batch_pspecs(cfg, shape, mesh)
        return (p_specs, o_specs, b_specs), (p_specs, o_specs, P())
    if shape.kind == "prefill":
        # logits (B, 1, V): batch over dp, vocabulary over model; the cache unconstrained
        return (p_specs, batch_pspecs(cfg, shape, mesh)), (P(bdim, None, "model"), None)
    # decode, the serving layout: weights TP-resident where they fit; the
    # big MoE archs take the stationary expert layout; dense batch-1 decode
    # keeps FSDP (its per-token gathers beat reading resident weights)
    serving = (
        shape.global_batch >= mesh.shape["data"]
        or (cfg.n_experts > 0 and cfg.n_experts % mesh.shape["model"] == 0)
        or (cfg.n_experts > 0 and serving_weights_resident(cfg, mesh))
    )
    p_specs = param_pspec_tree(cfg, mesh, params, serving=serving)
    c_specs = cache_pspecs(cfg, shape, mesh, specs[1])
    return (p_specs, c_specs, P()), (P(bdim, None, "model"), c_specs)
