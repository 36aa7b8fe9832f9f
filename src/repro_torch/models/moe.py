"""Mixture-of-Experts FFN: top-k routing with capacity, GShard-style (port
of the JAX package's ``models/moe.py``, its expert-parallel dispatch over a
mesh of shard slots included).

Routing follows GShard/Switch: softmax router in fp32, top-k experts per
token, per-expert position via a cumulative sum, tokens beyond capacity are
dropped (their combine weight is zero — the residual path carries them).

Exactness against the reference:

* the router's top-k returns ``jax.lax.top_k``'s order on ties (equal
  probabilities: the lower expert id first), through the port's
  tie-ordered selection on ``-probs``;
* capacity slots are given choice-major, over the flattened ``(k, T)``
  order, so a token's drop depends on its batch-mates exactly as in the
  reference;
* the combine gathers each token's k slots and sums them in choice order,
  each add rounded in the compute dtype as the reference's scatter-add
  rounds; no atomic add, so a rerun on the card is bit-equal.
"""

from __future__ import annotations

import contextlib
import threading
import types
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.index.knn import smallest_k_by_sort
from repro_torch.launch.mesh import P, assemble, local_block, without
from repro_torch.models.layers import dtype_of, frozen, init_swiglu, leaf_dtype, normal


class MoEParams(torch.nn.Module):
    """One MoE FFN's weights: the router (D, E) kept fp32, experts
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), and the shared
    expert(s) as one :class:`SwiGLU`, or None. :meth:`forward` is
    :func:`moe_block`."""

    def __init__(self, router, w_gate, w_up, w_down, shared=None):
        super().__init__()
        self.router = frozen(router)
        self.w_gate, self.w_up, self.w_down = frozen(w_gate), frozen(w_up), frozen(w_down)
        self.shared = shared

    def forward(self, x, cfg, dispatch=None):
        return moe_block(self, x, cfg, dispatch)


def init_moe(gen: torch.Generator, cfg) -> MoEParams:
    dt = dtype_of(cfg.param_dtype)
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / np.sqrt(D), 1.0 / np.sqrt(F_)
    return MoEParams(
        router=normal(gen, (D, E), s_in, leaf_dtype("router", cfg.param_dtype)),
        w_gate=normal(gen, (E, D, F_), s_in, dt),
        w_up=normal(gen, (E, D, F_), s_in, dt),
        w_down=normal(gen, (E, F_, D), s_out, dt),
        shared=init_swiglu(gen, D, F_ * cfg.n_shared_experts, dt) if cfg.n_shared_experts else None,
    )


def expert_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(np.ceil(n_tokens * top_k * factor / n_experts))
    return max(cap, 4)


def _route(x_flat: torch.Tensor, p: MoEParams, top_k: int):
    """Return (probs (T,E) fp32, topk gate weights (T,k), topk expert ids (T,k))."""
    logits = x_flat.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    _, idx = smallest_k_by_sort(-probs, top_k)  # jax.lax.top_k(probs)'s order on ties
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)  # renormalise over chosen
    return probs, gate, idx


_ROUTE_HOOKS: list[Callable] = []
_SILENCED = threading.local()  # depth of routes_silenced() on this thread


@contextlib.contextmanager
def route_hook(fn: Callable):
    """Inside the block, call ``fn(probs, idx, keep)`` with every routing
    decision an MoE block makes: probs (T, E) fp32, expert ids (T, k), and
    whether each choice found a capacity slot (T, k); T in the block's
    (B, S) order. For checks that compare the routes of two runs."""
    _ROUTE_HOOKS.append(fn)
    try:
        yield
    finally:
        _ROUTE_HOOKS.remove(fn)


@contextlib.contextmanager
def routes_silenced():
    """Inside the block, this thread's MoE blocks report no routes: the
    recompute of a rematerialised layer (``lm.body`` under ``cfg.remat``)
    makes the forward's decisions again, and a hook must see each once."""
    depth = getattr(_SILENCED, "depth", 0)
    _SILENCED.depth = depth + 1
    try:
        yield
    finally:
        _SILENCED.depth = depth


def _report_routes(probs, idx, keep) -> None:
    if getattr(_SILENCED, "depth", 0):
        return
    for fn in _ROUTE_HOOKS:
        fn(probs, idx, keep)


def capacity_positions(idx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice)'s slot within its expert, given choice-major
    (all tokens' first choices before any second choice), and whether it
    fits: (pos (T, k) int64, keep (T, k) bool)."""
    T, k = idx.shape
    flat = F.one_hot(idx.t().reshape(k * T), n_experts)  # (k*T, E), the (k, T) order
    pos = torch.cumsum(flat, dim=0) - flat
    pos_tok = (pos * flat).sum(-1).reshape(k, T).t()
    return pos_tok, pos_tok < capacity


def _experts(xe: torch.Tensor, p: MoEParams) -> torch.Tensor:
    """(E, C, D) slots → (E, C, D): each expert's SwiGLU, batched over E."""
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    return torch.bmm(h, p.w_down)


def moe_einsum(p: MoEParams, x: torch.Tensor, cfg):
    """GShard dense-dispatch MoE through (T, E, C) one-hots. x: (B, S, D) →
    (B, S, D), aux loss. The naive baseline; same decisions as
    :func:`moe_sort`."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    x_flat = x.reshape(T, D)

    probs, gate, idx = _route(x_flat, p, k)
    pos_tok, keep = capacity_positions(idx, E, C)
    _report_routes(probs, idx, keep)
    gate = gate * keep.to(gate.dtype)

    slot = F.one_hot(torch.where(keep, pos_tok, C), C + 1)[..., :C]  # (T, k, C); dropped → none
    expert = F.one_hot(idx, E)  # (T, k, E)
    disp = (expert.to(x.dtype)[..., None] * slot.to(x.dtype)[:, :, None, :]).sum(1)  # (T, E, C)
    comb = (expert.float()[..., None] * slot.float()[:, :, None, :] * gate[..., None, None].float()).sum(1)

    xe = torch.einsum("tec,td->ecd", disp, x_flat)  # (E, C, D)
    ye = _experts(xe, p)
    y = torch.einsum("tec,ecd->td", comb.to(ye.dtype), ye)

    if p.shared is not None:
        y = y + p.shared(x_flat)

    aux = load_balance_loss(probs, idx, E)
    return y.reshape(B, S, D), aux


def moe_sort(p: MoEParams, x: torch.Tensor, cfg):
    """Sort-based dispatch: gather tokens into (E, C) slots.

    Same routing decisions as :func:`moe_einsum` (identical keep/drop set);
    avoids the (T, E, C) one-hots at the price of data-dependent gathers.
    """
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    x_flat = x.reshape(T, D)

    probs, gate, idx = _route(x_flat, p, k)
    pos_tok, keep = capacity_positions(idx, E, C)
    _report_routes(probs, idx, keep)
    gate = gate * keep.to(gate.dtype)

    # kept (token, choice) assignments own distinct slots: a plain index
    # write, no duplicates, so the fill is deterministic. Dropped choices
    # write to one spare slot past the end, cut off after: the write's
    # shape does not depend on the routing (it runs on meta tensors too)
    slot = idx * C + pos_tok  # (T, k), meaningful where keep
    dest = torch.where(keep, slot, E * C).reshape(-1)
    tok_ids = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    slot_to_tok = torch.zeros(E * C + 1, dtype=torch.int64, device=x.device).index_put_((dest,), tok_ids)[: E * C]
    slot_filled = torch.zeros(E * C + 1, dtype=torch.bool, device=x.device).index_put_(
        (dest,), torch.ones((), dtype=torch.bool, device=x.device))[: E * C]

    xe = x_flat[slot_to_tok.reshape(E, C)] * slot_filled.reshape(E, C, 1).to(x.dtype)  # (E, C, D)
    ye = _experts(xe, p).reshape(E * C, D)

    # combine: each token's k slots, weighted by the gate, summed in choice order
    contrib = ye[torch.where(keep, slot, 0)] * gate.to(ye.dtype)[..., None]  # (T, k, D)
    contrib = torch.where(keep[..., None], contrib, torch.zeros((), dtype=ye.dtype, device=x.device))
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    if p.shared is not None:
        y = y + p.shared(x_flat)

    aux = load_balance_loss(probs, idx, E)
    return y.reshape(B, S, D), aux


def load_balance_loss(probs: torch.Tensor, expert_of: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * Σ_e f_e · P_e. The gradient reaches
    the router through P alone: f is a count (the reference stops its
    gradient)."""
    e = expert_of.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=e.device).index_add_(0, e, torch.ones_like(e))
    f = counts.float() / max(expert_of.numel(), 1)
    P = probs.mean(0)
    return n_experts * torch.sum(f * P)


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a mesh of shard slots
# ---------------------------------------------------------------------------
# The reference's shard_map block: each (data i, model j) slot dispatches
# locally. It takes its token block, routes it, keeps its capacity
# positions, selects the tokens routed to the experts it holds, runs them
# and scatters back; one sum over ``model`` completes the combine.
#
# E % model == 0  → true EP (E/model experts a slot, the full F);
# model % E == 0  → every slot runs all experts on its columns of F
#                   (exact in real arithmetic: SwiGLU is elementwise in F;
#                   the sum adds the column partials).
#
# The partials are all-gathered and added in mesh order
# (``launch/mesh.py:Mesh.reduce``), so the answer does not depend on which
# processes hold the slots. With top-k ≤ 2 and one token block (data 1) a
# token's output is at most two nonzero terms, so true EP equals
# :func:`moe_sort` bit for bit.

_EP_MESH: "tuple | None" = None  # (mesh, dp_axes, token_axes, model_axis, stationary)


def set_ep_mesh(mesh, dp_axes, token_axes=..., model_axis: str = "model", stationary: bool = False) -> None:
    """Send ``moe_block``'s ``"ep"`` and ``"sort"`` dispatch to
    :func:`moe_ep` on ``mesh`` (None turns it off). ``token_axes``: the
    mesh axes of the batch dim (None: tokens replicated, e.g. batch-1
    decode); default ``dp_axes``. ``dp_axes`` names the FSDP axis the
    expert weights' d_model dim is split over (gathered back before use).

    ``stationary`` (serving the 100B+ MoE archs): weights never move.
    Experts split E over ``model`` and F over the last of ``dp_axes``; the
    token batch is replicated to every slot, each slot computes its
    (experts, F slice) partials, and one sum over (model, data) combines."""
    global _EP_MESH
    if mesh is None:
        _EP_MESH = None
        return
    if token_axes is ...:
        token_axes = tuple(dp_axes)
    _EP_MESH = (mesh, tuple(dp_axes), token_axes, model_axis, stationary)


def _ep_weight_specs(cfg, msize: int, fsdp):
    """(w_gate/w_up spec, w_down spec, true EP?) of the expert weights."""
    if cfg.n_experts % msize == 0:
        return P("model", fsdp, None), P("model", None, fsdp), True
    if msize % cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts on a model axis of {msize}: neither divides the other")
    return P(None, fsdp, "model"), P(None, "model", fsdp), False


def _ep_slot(x_loc, router, wg, wu, wd, cfg, e0: int, E_loc: int, true_ep: bool, report: bool):
    """One slot's block: (its partial y (T_loc, D), its aux loss)."""
    B_loc, S, D = x_loc.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B_loc * S
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    x_flat = x_loc.reshape(T, D)
    probs, gate, idx = _route(x_flat, types.SimpleNamespace(router=router), k)
    pos_tok, keep = capacity_positions(idx, E, C)
    if report:
        _report_routes(probs, idx, keep)
    gate = gate * keep.to(gate.dtype)
    spare = E_loc * C
    if true_ep:  # only this slot's experts
        mine = (idx >= e0) & (idx < e0 + E_loc)
        slot = torch.where(keep & mine, (idx - e0) * C + pos_tok, spare)
    else:  # every slot runs all experts on its F columns
        slot = torch.where(keep, idx * C + pos_tok, spare)
    dest = slot.reshape(-1)
    tok_ids = torch.arange(T, device=x_loc.device)[:, None].expand(T, k).reshape(-1)
    slot_to_tok = torch.zeros(spare + 1, dtype=torch.int64, device=x_loc.device).index_put_((dest,), tok_ids)[:spare]
    filled = torch.zeros(spare + 1, dtype=torch.bool, device=x_loc.device).index_put_(
        (dest,), torch.ones((), dtype=torch.bool, device=x_loc.device))[:spare]
    xe = x_flat[slot_to_tok.reshape(E_loc, C)] * filled.reshape(E_loc, C, 1).to(x_loc.dtype)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd).reshape(spare, D)  # a partial over F unless true EP
    used = slot < spare
    contrib = ye[torch.where(used, slot, 0)] * gate.to(ye.dtype)[..., None]  # (T, k, D)
    contrib = torch.where(used[..., None], contrib, torch.zeros((), dtype=ye.dtype, device=x_loc.device))
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, load_balance_loss(probs, idx, E)


def moe_ep(p: MoEParams, x: torch.Tensor, cfg):
    """:func:`moe_sort` over the mesh set by :func:`set_ep_mesh`. Global
    view in and out: x (B, S, D) → (y (B, S, D), aux), so ``lm.forward``
    and ``decode_step`` reach it unchanged. This process runs its own
    slots on their blocks (:func:`repro_torch.launch.mesh.local_block`
    under the reference's specs); the partials are summed over ``model``
    (stationary: ``model`` and ``data``) in mesh order; the aux loss is
    the mean over the token axes; the shared expert is added after the
    combine."""
    mesh, dp_axes, token_axes, maxis, stationary = _EP_MESH
    msize = mesh.shape[maxis]
    E, D = cfg.n_experts, cfg.d_model
    fsdp = dp_axes[-1] if dp_axes else None
    if stationary:
        if fsdp is None or E % msize:
            raise ValueError(f"the stationary layout needs a data axis and E % model == 0, got {E} on {msize}")
        gu_spec, d_spec, true_ep = P("model", None, fsdp), P("model", fsdp, None), True
        gathered = None  # the weights stay split over data too
        x_spec = P(None, None, None)
        sum_axes = (maxis, fsdp)
    else:
        gu_spec, d_spec, true_ep = _ep_weight_specs(cfg, msize, fsdp)
        gathered = fsdp  # zero-3: each slot gathers the FSDP split back
        x_spec = P(token_axes, None, None) if token_axes else P(None, None, None)
        sum_axes = (maxis,)
    gu_spec, d_spec = without(gu_spec, gathered), without(d_spec, gathered)
    E_loc = E // msize if true_ep else E
    ys, auxes = [], []
    for i in mesh.local_indices():
        c = mesh.coords(i)
        e0 = int(c[maxis]) * E_loc if true_ep else 0
        report = int(c[maxis]) == 0 and (not stationary or i == 0)  # each token block's routes once
        y, aux = _ep_slot(local_block(x, x_spec, mesh, i), p.router, local_block(p.w_gate, gu_spec, mesh, i),
                          local_block(p.w_up, gu_spec, mesh, i), local_block(p.w_down, d_spec, mesh, i),
                          cfg, e0, E_loc, true_ep, report)
        ys.append(y.reshape(-1, x.shape[1], D))
        auxes.append(aux)
    y = assemble(mesh.reduce(mesh.all_gather(ys), sum_axes), x_spec, mesh, x.shape).to(x.device)
    aux_all = mesh.all_gather(auxes)
    if token_axes:
        group = mesh.group(0, token_axes)
        aux = mesh.reduce(aux_all, token_axes, at=[0])[0] / torch.full((), float(len(group)), device=aux_all[0].device)
    else:
        aux = aux_all[0]
    if p.shared is not None:
        B, S, _ = x.shape
        y = y + p.shared(x.reshape(B * S, D)).reshape(B, S, D)
    return y, aux.to(x.device)


def moe_block(p: MoEParams, x: torch.Tensor, cfg, dispatch: str | None = None):
    dispatch = dispatch or getattr(cfg, "moe_dispatch", "sort")
    if _EP_MESH is not None and dispatch in ("ep", "sort"):
        return moe_ep(p, x, cfg)
    if dispatch == "sort":
        return moe_sort(p, x, cfg)
    if dispatch == "einsum":
        return moe_einsum(p, x, cfg)
    if dispatch == "ep":
        raise ValueError("MoE dispatch 'ep' needs a mesh: call set_ep_mesh first")
    raise ValueError(f"unknown MoE dispatch {dispatch!r} (want 'sort'|'einsum'|'ep')")
