"""``capacity_admit``: one capacity-bounded bidding round's admission.

Port of ``src/repro/kernels/capacity_admit/ref.py``. The JAX package never
had a TPU kernel for it (registered ``pallas=None``): the step is two
stable sorts and a searchsorted, so it runs as plain PyTorch ops on every
device. Per centroid it admits the ``free[c]`` closest bidders, ties broken
by original index, carrying O(N + K) state and never an (N, K) matrix.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import registry


def capacity_admit(pick, d2, bidding, free):
    """pick (N,) int32 bids, d2 (N,) their distances, bidding (N,) bool,
    free (K,) int32 remaining capacity → admitted (N,) bool."""
    n = pick.shape[0]
    k = free.shape[0]
    # non-bidders sort into a sentinel segment k past every real centroid
    pick_eff = torch.where(bidding, pick, k).to(torch.int32)
    d2_eff = torch.where(bidding, d2.float(), torch.inf)
    # stable two-pass sort == lexicographic (centroid, distance, index)
    order = torch.argsort(d2_eff, stable=True)
    order = order[torch.argsort(pick_eff[order], stable=True)]
    p_sorted = pick_eff[order].contiguous()
    seg_start = torch.searchsorted(p_sorted, p_sorted, side="left")
    rank = torch.arange(n, device=pick.device) - seg_start
    free_ext = torch.cat([free.to(torch.int32), free.new_zeros((1,), dtype=torch.int32)])
    admitted_sorted = bidding[order] & (rank < free_ext[p_sorted.long()])
    admitted = torch.zeros((n,), dtype=torch.bool, device=pick.device)
    admitted[order] = admitted_sorted
    return admitted


# ---------------------------------------------------------------------------
# Registry spec: plain-only (cuda=None), as the reference's is jnp-only
# ---------------------------------------------------------------------------


def _make_inputs(gen, sig):
    (ps, _), (ds, _), (bs, _), (fs, _) = sig
    K = fs[0]
    pick = registry.draw(gen, ps, "int32", high=K)
    d2 = registry.draw(gen, ds, "float32", uniform=True)
    bidding = torch.rand(bs, generator=gen, device=gen.device) < 0.7
    free = registry.draw(gen, fs, "int32", high=max(2, ps[0] // K))
    return pick, d2, bidding, free


def _sig(n, k):
    return (((n,), "int32"), ((n,), "float32"), ((n,), "bool"), ((k,), "int32"))


SPEC = registry.register_spec(registry.KernelSpec(
    name="capacity_admit",
    reference="capacity_admit",
    plain=capacity_admit,
    cuda=None,  # plain-only: two stable sorts and a searchsorted on every device
    plan_candidates=lambda sig: (),
    default_plan=lambda sig, device=None: {},
    make_inputs=_make_inputs,
    check_shapes=(_sig(512, 16), _sig(1000, 7)),
    bench_shapes=_sig(100_000, 256),
    dtype_grid=(),
))
