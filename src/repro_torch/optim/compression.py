"""Gradient compression for a data-parallel all-reduce (port of the JAX
package's ``optim/compression.py``).

int8 block-quantised mean with error feedback (the 1-bit Adam / PowerSGD
lineage): each slot keeps the residual of its quantisation error and folds
it into the next step's gradient, so the compression's bias telescopes
away instead of accumulating.

The arithmetic is the reference's: blocks of 256, scale = max(|block| /
127, 1e-12), round half to even (``torch.round`` and ``jnp.round`` both
do), clip to ±127. The divisors are 0-d tensors: the card divides by a
Python scalar as a product with its reciprocal, which rounds otherwise
than the division. The slots' dequantised gradients are all-gathered and
added in mesh order (``launch/mesh.py:Mesh.reduce``), then divided by the
slot count, so P processes give one process's answer bit for bit.
"""

from __future__ import annotations

import torch

BLOCK = 256


def _quant(x: torch.Tensor):
    """x → (int8 blocks (n, BLOCK), float32 scales (n, 1), pad)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype, device=flat.device)])
    blocks = flat.reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), -1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full((), 127.0, dtype=blocks.dtype, device=blocks.device), 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequant(q: torch.Tensor, scale: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _leaves(tree) -> tuple:
    """(leaves, rebuild): a tensor, or a list/tuple/dict of them (nested)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_leaves(v) for v in tree]
    else:
        raise TypeError(f"compressed_psum: a leaf of type {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(xs):
        out, at = [], 0
        for (_l, rb), n in zip(parts, sizes):
            out.append(rb(xs[at : at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


def compressed_psum(grads, mesh, axis: str, residuals):
    """The mean over ``axis`` of int8-quantised gradients, with error
    feedback. ``grads`` and ``residuals`` hold one tree (a tensor, or a
    list/tuple/dict of them) for each of this process's slots
    (``mesh.local_indices()``); the residuals start as zeros like the
    gradients. Returns (the reduced float32 trees, the new residuals), one
    each a local slot."""
    ids = mesh.local_indices()
    if len(grads) != len(ids) or len(residuals) != len(ids):
        raise ValueError(f"{len(grads)} gradients and {len(residuals)} residuals for {len(ids)} local slots")
    flat = [_leaves(g) for g in grads]
    res = [_leaves(r)[0] for r in residuals]
    n = len(mesh.group(ids[0], axis))
    reduced = [[] for _ in ids]
    new_res = [[] for _ in ids]
    for j in range(len(flat[0][0])):
        sent = []
        for s, ((leaves, _rb), r) in enumerate(zip(flat, res)):
            g = leaves[j].float() + r[j]
            q, scale, pad = _quant(g)
            sent.append(_dequant(q, scale, pad, g.shape))
            new_res[s].append(g - sent[-1])  # what the slot failed to send
        totals = mesh.psum(sent, axis)
        for s, t in enumerate(totals):
            reduced[s].append(t / torch.full((), float(n), device=t.device))
    return ([rb(x) for (_l, rb), x in zip(flat, reduced)],
            [rb(x) for (_l, rb), x in zip(flat, new_res)])
