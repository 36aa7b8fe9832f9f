"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``bench/reference.py``) at float64.

Every comparison returns plain numbers under short names; a run is correct
when each is finite and at most its limit (``bench/limits/<workload>.json``).
Where two answers are both right because distances tie to rounding (which
centroid, which k-th neighbour), the number is the relative distance by
which the program's answer lies beyond the reference's best, so rounding
reads ~1e-6 and a wrong answer reads ~1e-2 or more.

* the index (``index_numbers``): ``layout`` counts broken promises of the
  layout exactly (capacity, the permutation, ``x_rows[perm] == x``, each
  kept edge inside its cell, a weight one of Eq. 6's values);
  ``kmeans_gap`` how far k-means' objective (the mean squared distance of
  a row to its nearest centroid) lies above the reference's k-means from
  the same seed; ``assign_gap`` how much nearer a centroid with room lies
  than the one a row was given; ``knn_gap`` how far a kept neighbour lies
  beyond the row's k-th nearest in its cell; ``knn_w_gap`` how far the
  head lies from the rank that its edge's weight states, in the tail's
  order;
* the training epochs (``train_numbers``): the gap of each checked
  epoch's mean loss and of the norm of θ's change over it, against the
  reference following the same epoch from the same θ and index;
* serving (``map_numbers``, ``query_numbers``): the frozen map against the
  fit and index it was frozen from, the cell and the neighbours of each
  checked query against the reference's nearest, the reported distances,
  and each placement against the reference's placement from the same
  neighbours.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench import reference as ref

F64 = torch.float64


def _rel_gap(over, base):
    """max(0, over) / base, as a float64 tensor."""
    return torch.clamp_min(over, 0.0) / torch.clamp_min(base, 1e-300)


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def _on(a, dev, dtype=None) -> torch.Tensor:
    """A host array or tensor as a tensor on ``dev``."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def index_numbers(x: torch.Tensor, index: dict, cfg: dict, seed: int, block: int = 16384) -> dict:
    """``x`` (N, D) the build's input on the device; ``index`` its arrays
    (x_rows, knn_idx, knn_w, counts, centroids, perm) on the host, x_rows
    possibly on the device; ``seed`` the build's."""
    out = {"layout": 0, "kmeans_gap": math.inf, "assign_gap": math.inf, "knn_gap": math.inf,
           "knn_w_gap": math.inf}
    dev = x.device
    N, D = x.shape
    K, cap, k = cfg["n_clusters"], ref.capacity(cfg), cfg["n_neighbors"]
    bad = 0
    counts = _on(index["counts"], dev, torch.int64)
    perm = _on(index["perm"], dev, torch.int64)
    bad += int(counts.shape[0] != K) + int((counts > cap).sum()) + int((counts < 0).sum())
    bad += abs(int(counts.sum()) - N) + int(perm.shape[0] != N)
    if bad:
        return dict(out, layout=bad)
    cell, slot = perm // cap, perm % cap
    in_range = (perm >= 0) & (perm < K * cap)
    bad += int((~in_range).sum()) + int((slot >= counts[cell.clamp(0, K - 1)]).sum())
    bad += int(N - torch.unique(perm).numel())
    x_rows = _on(index["x_rows"], dev)
    bad += int((x_rows.shape != (K * cap, D)))
    if bad:
        return dict(out, layout=bad)
    bad += int((x_rows[perm] != x).any(1).sum())
    real = torch.zeros(K * cap, dtype=torch.bool, device=dev)
    real[perm] = True
    bad += int((x_rows[~real] != 0).any(1).sum())
    cents = _on(index["centroids"], dev, F64)
    bad += int(~torch.isfinite(cents).all()) + int(cents.shape != (K, D))

    # the capacity-bounded assignment: no centroid with room nearer than the row's
    full = counts >= cap
    gaps = []
    for s in range(0, N, block):
        xb = x[s : s + block].double()
        d2 = ref.sq_dist(xb, cents)
        mine = d2.gather(1, cell[s : s + block, None])[:, 0]
        best_free = torch.where(full[None, :], math.inf, d2).min(1).values
        gaps.append(_max(_rel_gap(mine - best_free, mine)))
    assign_gap = max(gaps)

    # the in-cell kNN and its weights, cell block by cell block
    knn_idx = _on(index["knn_idx"], dev, torch.int64)
    knn_w = _on(index["knn_w"], dev, F64)
    Z = ref.normalizer(k)
    slots = torch.arange(cap, device=dev)
    knn_gap = knn_w_gap = 0.0
    step = ref.cells_per_block(cap)
    for a in range(0, K, step):
        b = min(K, a + step)
        nc = b - a
        rows = torch.arange(a * cap, b * cap, device=dev)
        xb = x_rows[a * cap : b * cap].view(nc, cap, D).double()
        d2 = ref.sq_dist(xb, xb)
        valid = slots[None, :] < counts[a:b, None]  # (nc, cap)
        eye = torch.eye(cap, dtype=torch.bool, device=dev)[None]
        d2 = torch.where(eye, 0.0, d2)
        pairs = valid[:, :, None] & valid[:, None, :]
        # row i's order, self first, to rank k
        srt = torch.topk(torch.where(pairs, d2, math.inf), min(k + 1, cap), -1, largest=False, sorted=True).values
        kth = srt[:, :, -1]
        kth = torch.where(torch.isfinite(kth), kth, srt.masked_fill(~torch.isfinite(srt), -1).max(-1).values)
        idx = knn_idx[rows].view(nc, cap, k)
        w = knn_w[rows].view(nc, cap, k)
        own = rows.view(nc, cap)[:, :, None]
        live = w > 0
        dead_ok = (idx == own) | live
        bad += int((~dead_ok & valid[:, :, None]).sum()) + int((live & ~valid[:, :, None]).sum())
        local = idx - (a * cap + torch.arange(nc, device=dev)[:, None, None] * cap)
        in_cell = (local >= 0) & (local < cap)
        loc = local.clamp(0, cap - 1)
        ok_edge = in_cell & torch.gather(valid[:, None, :].expand(-1, cap, -1), 2, loc) & (idx != own)
        bad += int((live & ~ok_edge).sum())
        srt_idx = torch.sort(loc, -1).values
        dup = (srt_idx[..., 1:] == srt_idx[..., :-1]) & torch.gather(live, 2, torch.sort(loc, -1).indices)[..., 1:]
        bad += int(dup.sum())
        r = torch.where(live, 1.0 / torch.log(torch.clamp_min(w * Z, 1.0 + 1e-12)), 0.0)
        rank = torch.round(r)
        bad += int((live & ((r - rank).abs() > 1e-3 * rank.clamp_min(1) + 1e-3)).sum())
        bad += int((live & ((rank < 1) | (rank > k))).sum())
        d_ij = torch.gather(d2, 2, loc)  # (nc, cap, k)
        knn_gap = max(knn_gap, _max(_rel_gap(d_ij - kth[:, :, None], kth[:, :, None])[live & ok_edge]))
        # the tail j's order: the distance at the weight's rank against d(j, i)
        at_rank = srt[torch.arange(nc, device=dev)[:, None, None], loc, rank.clamp(0, srt.shape[-1] - 1).long()]
        g = (d_ij - at_rank).abs() / torch.clamp_min(torch.minimum(d_ij, at_rank), 1e-300)
        knn_w_gap = max(knn_w_gap, _max(g[live & ok_edge]))
    del x_rows, d2, srt

    # k-means: its objective against the reference's from the same seed
    want = ref.objective(x, ref.kmeans(x.double(), K, cfg["kmeans_iters"], cfg["kmeans_tol"],
                                       ref.seeded_generator(dev, seed)))
    kmeans_gap = max(0.0, ref.objective(x, cents) - want) / want
    return {"layout": bad, "kmeans_gap": kmeans_gap, "assign_gap": assign_gap, "knn_gap": knn_gap,
            "knn_w_gap": knn_w_gap}


def train_numbers(prog: list, want: list) -> dict:
    """``prog``: for each checked epoch (its mean loss, θ at its start, θ
    at its end) from the program; ``want``: (mean loss, θ at its end) from
    the reference following that epoch from the same start; θ as float64
    host arrays in the index's row layout. The worst epoch's gaps."""
    loss_gap = change_gap = 0.0
    for (lp, t0, tp), (lr, tr) in zip(prog, want):
        loss_gap = max(loss_gap, abs(lp - lr) / max(abs(lr), 1e-300))
        cp, cr = np.linalg.norm(tp - t0), np.linalg.norm(tr - t0)
        change_gap = max(change_gap, abs(cp - cr) / max(cr, 1e-300))
    if len(prog) != len(want) or not prog:
        loss_gap = change_gap = math.inf
    return {"loss_gap": float(loss_gap), "change_gap": float(change_gap)}


def map_numbers(fz: dict, index: dict, theta_rows, cfg: dict) -> dict:
    """The frozen map ``fz`` (theta_rows, x_rows, centroids, counts, means,
    inv_perm as device tensors) against the index and θ it was frozen
    from: ``map_layout`` counts differing entries of what must be copied
    exactly; ``means_gap`` the largest cell mean's distance from the
    reference's, over the map's spread."""
    dev = fz["theta_rows"].device
    cap = ref.capacity(cfg)
    th = _on(theta_rows, dev)
    bad = int((fz["theta_rows"] != th).any(-1).sum())
    bad += int((fz["x_rows"] != _on(index["x_rows"], dev)).any(-1).sum())
    bad += int((fz["centroids"] != _on(index["centroids"], dev)).any(-1).sum())
    bad += int((fz["counts"].cpu().numpy() != np.asarray(index["counts"])).sum())
    inv = np.full(fz["inv_perm"].shape[0], -1, np.int64)
    inv[np.asarray(index["perm"])] = np.arange(len(index["perm"]))
    bad += int((fz["inv_perm"].cpu().numpy() != inv).sum())
    counts = _on(index["counts"], dev, torch.int64)
    mu = ref.local_means(th.double(), counts, cap)
    real = torch.as_tensor(inv >= 0, device=dev)
    spread = float(th.double()[real].std(0).norm())
    means_gap = float((fz["means"].double() - mu).norm(dim=-1).max()) / max(spread, 1e-300)
    return {"map_layout": bad, "means_gap": means_gap}


def query_numbers(cfg: dict, fz: dict, perm, q, seeds, rows, out: dict) -> dict:
    """Checked queries ``q`` (B, D) on the device with their seeds and
    row ids, and what the program returned for them (``out``: embedding,
    cells, neighbor_ids, neighbor_dists, host arrays). The reference
    places each query from the program's cell and neighbours, once the
    comparisons above have held them to the reference's nearest."""
    dev = q.device
    cap, k = ref.capacity(cfg), cfg["n_neighbors"]
    counts = fz["counts"]
    cents = fz["centroids"].double()
    perm_d = _on(perm, dev, torch.int64)
    own = torch.as_tensor(out["cells"], dtype=torch.int64, device=dev)
    K = counts.shape[0]
    bad = int(((own < 0) | (own >= K)).sum())
    own = own.clamp(0, K - 1)
    d2c = ref.sq_dist(q.double(), cents)
    mine = d2c.gather(1, own[:, None])[:, 0]
    cell_gap = _max(_rel_gap(mine - d2c.min(1).values, mine))

    ids = torch.as_tensor(out["neighbor_ids"], dtype=torch.int64, device=dev)
    has = ids >= 0
    nb_rows = torch.where(has, perm_d[ids.clamp(0, perm_d.shape[0] - 1)], 0)
    bad += int((has & (nb_rows // cap != own[:, None])).sum())
    want = torch.clamp(counts[own], max=k)
    bad += int((has.sum(1) != want).sum())
    blocks = fz["x_rows"].view(K, cap, -1)[own].double()
    d2 = ((q.double()[:, None, :] - blocks) ** 2).sum(-1)
    invalid = torch.arange(cap, device=dev)[None, :] >= counts[own][:, None]
    srt = torch.sort(torch.where(invalid, math.inf, d2), -1).values
    kth = srt.gather(1, (want - 1).clamp_min(0)[:, None])[:, 0]
    d_nb = d2.gather(1, (nb_rows % cap))
    qknn_gap = _max(_rel_gap(d_nb - kth[:, None], kth[:, None])[has])
    dist = torch.as_tensor(out["neighbor_dists"], device=dev).double()
    qdist_gap = _max(((dist - d_nb.sqrt()).abs() / d_nb.sqrt().clamp_min(1e-300))[has])

    theta = ref.place(cfg, fz["theta_rows"], fz["x_rows"], counts, ref.local_means(
        fz["theta_rows"].double(), counts, cap), q, own, nb_rows, has, seeds, rows, F64)
    got = torch.as_tensor(out["embedding"], device=dev).double()
    scale = (theta[:, None, :] - fz["theta_rows"].double()[nb_rows]).norm(dim=-1)
    scale = float(torch.median(scale[has]))
    place_gap = float((got - theta).norm(dim=-1).max()) / max(scale, 1e-300)
    return {"query_layout": bad, "cell_gap": cell_gap, "qknn_gap": qknn_gap, "qdist_gap": qdist_gap,
            "place_gap": place_gap}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number with no limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        v = float(value)
        good = limit is not None and math.isfinite(v) and v <= float(limit)
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
