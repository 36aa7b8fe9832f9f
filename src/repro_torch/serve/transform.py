"""The out-of-sample transform: frozen-neighbour NOMAD steps on a batch.

One batch of unseen rows is placed in four stages (the JAX package's
``make_transform_fn``, as plain functions on tensors):

1. **assign** — nearest frozen centroid per query (the ``kmeans_assign``
   kernel);
2. **kNN** — exact nearest neighbours inside the assigned frozen cell
   (:func:`repro_torch.index.knn.query_cluster_knn`), weighted by Eq. 6
   with the query-side rank (neighbour s gets e^{1/(s+1)}/Z);
3. **init** — each query starts at the Cauchy-weighted mean of its
   neighbours' positions, weights 1/(1 + ‖x_q − x_nb‖²) from the high-dim
   distances;
4. **optimise** — ``steps`` frozen NOMAD steps (:func:`frozen_step`) in
   which only the query positions move: attraction through the
   ``frozen_attract`` kernel, repulsion through the ``cauchy_mean`` M̃ term
   (remote cells via the frozen means) plus S frozen in-cell samples, lr
   annealed linearly to 0.

**Per-row random numbers.** The JAX package folds a threefry key per row,
``fold_in(fold_in(key(seed_i), row_i), t)``. Here a counter-based hash of
(seed_i, row_i, t, s) in int64 tensor ops (:func:`counter_hash`) gives the
draw of row i's s-th in-cell sample at step t. Every product in it stays
below 2^63, so nothing relies on overflow, and integer arithmetic is exact:
the same draws on the CPU and on the card, whatever the batch size and
whichever requests a batch coalesces. Together with per-row kernels (each
head's sums in one fixed order) this makes placements independent of
batching. The bits differ from threefry's, which is not a goal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.cauchy import cauchy
from repro_torch.core.rank_model import normalizer
from repro_torch.index.knn import query_cluster_knn
from repro_torch.kernels.frozen_attract.ops import frozen_attract
from repro_torch.kernels.kmeans_assign.ops import assign_nearest
from repro_torch.serve.frozen import FrozenMap

_M32 = 0xFFFFFFFF
# odd and below 2^27: a 32-bit value times it stays below 2^59
_MUL = 0x45D9F3B
_SALT = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)  # one per input


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) with full avalanche, in int64 arithmetic."""
    x = ((x >> 16) ^ x) * _MUL & _M32
    x = ((x >> 16) ^ x) * _MUL & _M32
    return (x >> 16) ^ x


def counter_hash(seed: torch.Tensor, row: torch.Tensor, t: int, s: torch.Tensor) -> torch.Tensor:
    """32-bit hash of (seed, row, t, s), broadcast; int64 in [0, 2^32)."""
    h = _mix32((seed & _M32) ^ _SALT[0])
    h = _mix32(h ^ (row & _M32) ^ _SALT[1])
    h = _mix32(h ^ (int(t) & _M32) ^ _SALT[2])
    return _mix32(h ^ (s & _M32) ^ _SALT[3])


def sample_negative_slots(seeds: torch.Tensor, rows: torch.Tensor, t: int,
                          cnt_own: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The S in-cell slots of step ``t``, per row: (B, S) int64 in
    [0, cnt_own). Draw u = h/2^24 from the top 24 bits of the hash and take
    floor(u·cnt) exactly, as (h·cnt) >> 24 in integers (< 2^55)."""
    s = torch.arange(n_samples, device=seeds.device, dtype=torch.int64)
    h = counter_hash(seeds[:, None], rows[:, None], t, s[None, :]) >> 8
    return (h * cnt_own[:, None]) >> 24


def rank_weight_table(k: int) -> np.ndarray:
    """Eq. 6 weights of query-side ranks 1..k, computed on the host in
    float32 as the JAX package does."""
    return np.exp(1.0 / np.arange(1, k + 1, dtype=np.float32)) / normalizer(k)


def annealed_lr(lr0: float, t: int, steps: int) -> float:
    """lr0·(1 − t/T) in float32 arithmetic, as the JAX scan computes it."""
    one = np.float32(1.0)
    return float(np.float32(lr0) * (one - np.float32(t) / np.float32(max(steps, 1))))


def assign_and_knn(fz: FrozenMap, qx: torch.Tensor, k: int):
    """Stages 1 and 2: each query's frozen cell and its k in-cell nearest
    neighbours. Returns (own (B,), neighbour rows (B, k) into θ / inv_perm,
    d² (B, k), valid (B, k))."""
    own, _ = assign_nearest(qx, fz.centroids)
    own = own.long()
    slot, d2, valid = query_cluster_knn(qx, own, fz.x_blocks, fz.counts, k, block=fz.cfg.serve_knn_block)
    return own, own[:, None] * fz.capacity + slot, d2, valid


def frozen_step(theta: torch.Tensor, fz: FrozenMap, own: torch.Tensor, nb_theta: torch.Tensor,
                nb_w: torch.Tensor, nslot: torch.Tensor, valid: torch.Tensor, lr_t: float):
    """One frozen NOMAD step on the query positions ``theta`` (B, d).

    The loss of the JAX transform (M̃ through ``cauchy_mean``, M from the S
    frozen in-cell samples at slots ``nslot`` (B, S), attraction through
    ``frozen_attract``), summed over the valid rows; its gradient to θ by
    ``torch.autograd.grad``. Returns (θ − lr_t·g, loss sum). Rows never
    couple: the loss is a sum of per-row terms.
    """
    cfg = fz.cfg
    n_noise = float(cfg.n_noise)
    S = nslot.shape[1]
    p_cell = fz.counts.float() / float(fz.n_points)
    cell_w = n_noise * p_cell
    th_neg = fz.theta_rows[own[:, None] * fz.capacity + nslot]  # (B, S, d)
    th = theta.detach().requires_grad_()
    with torch.enable_grad():
        m_tilde = losses.nomad_mean_term(th, fz.means, cell_w, own)
        q_neg = cauchy(th[:, None, :], th_neg)  # (B, S)
        m_exact = (n_noise * p_cell[own] / S) * torch.sum(q_neg, -1)
        lb = frozen_attract(th, nb_theta, nb_w, m_tilde + m_exact)
        loss_sum = torch.sum(torch.where(valid, lb, 0.0))
        (g,) = torch.autograd.grad(loss_sum, th)
    return (theta - lr_t * g).detach(), loss_sum.detach()


def place_batch(fz: FrozenMap, qx: torch.Tensor, rows: torch.Tensor, seeds: torch.Tensor,
                valid: torch.Tensor, *, steps: Optional[int] = None, lr: Optional[float] = None,
                with_neighbors: bool = True, n_valid: Optional[int] = None):
    """Place one batch: qx (B, D) on the map's device, rows/seeds (B,) int64
    (the row's index in its request and the request's seed, in
    [0, 2^32)), valid (B,) bool (pad rows are False: they change only the
    reported loss).

    Returns (θ (B, d), own (B,), nb_ids (B, k), nb_dists (B, k), step
    losses (steps,)); with ``with_neighbors=False`` the ids and distances
    are None. A step's loss is its sum over the valid rows divided by
    ``n_valid`` (default: this batch's valid rows; a slot of a sharded
    batch passes the whole batch's).
    """
    cfg = fz.cfg
    k, S = cfg.n_neighbors, cfg.n_exact_negatives
    T = cfg.transform_steps if steps is None else steps
    lr0 = cfg.resolved_transform_lr() if lr is None else lr
    with torch.no_grad():
        own, nb_row, nb_d2, nb_valid = assign_and_knn(fz, qx, k)
        nb_theta = fz.theta_rows[nb_row]  # (B, k, d)
        w_rank = torch.from_numpy(rank_weight_table(k)).to(qx.device)
        nb_w = torch.where(nb_valid, w_rank[None, :], 0.0)
        # 3. Cauchy-weighted init, summed over the k neighbours in a fixed
        # order (a batched product could round differently per batch size)
        w_init = torch.where(nb_valid, 1.0 / (1.0 + nb_d2), 0.0)
        w_init = w_init / torch.clamp_min(torch.sum(w_init, -1, keepdim=True), 1e-12)
        theta = w_init[:, 0, None] * nb_theta[:, 0]
        for s in range(1, k):
            theta = theta + w_init[:, s, None] * nb_theta[:, s]
        # 4. frozen NOMAD steps
        cnt_own = torch.clamp_min(fz.counts[own], 1)
        n_valid = max(int(valid.sum()), 1) if n_valid is None else n_valid
        step_losses = []
        for t in range(T):
            nslot = sample_negative_slots(seeds, rows, t, cnt_own, S)
            theta, loss_sum = frozen_step(
                theta, fz, own, nb_theta, nb_w, nslot, valid, annealed_lr(lr0, t, T)
            )
            step_losses.append(loss_sum / n_valid)
        step_losses = torch.stack(step_losses) if step_losses else torch.zeros((0,))
        if not with_neighbors:
            return theta, own, None, None, step_losses
        nb_ids = torch.where(nb_valid, fz.inv_perm[nb_row], -1)
        nb_dists = torch.where(nb_valid, torch.sqrt(nb_d2), torch.inf)
        return theta, own, nb_ids, nb_dists, step_losses
