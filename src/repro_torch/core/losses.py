"""InfoNC-t-SNE loss (Eq. 2) and the NOMAD surrogate (Eq. 3–5).

    L = −(1/B) Σ_b Σ_s w_pos[b,s] · [log q(b,s) − log(q(b,s) + M̃_b + M_b)]

    M̃_b = Σ_r mean_w[b,r] · q(θ_b, μ_r)          (approximated cells)
    M_b  = Σ_s neg_w[b,s] · q(θ_b, θ_neg[b,s])    (exactly-sampled cells)

The training step runs the whole per-head NOMAD loss as one fused kernel
(``nomad_step``, :func:`nomad_step_term`): the CUDA kernel pair on the
card, its plain PyTorch version on the CPU, picked by the tensors' device.
The serving step takes M̃ alone from the ``cauchy_mean`` kernel
(:func:`nomad_mean_term`). :func:`contrastive_loss` is the unfused
composition the InfoNC baseline and the tests use.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cauchy import cauchy
from repro_torch.kernels.cauchy_mean.ops import cauchy_weighted_sum
from repro_torch.kernels.nomad_step.ops import nomad_step_fused


def nomad_mean_term(theta_i, means, cell_w, own_cell):
    """M̃ (B,) = Σ_r cell_w[r]·[r ≠ own_cell[b]]·q(θ_b, μ_r), with
    cell_w = |M|·p(m∈r); the gradient flows to θ_i only."""
    return cauchy_weighted_sum(theta_i, means, cell_w, own_cell)


def nomad_step_term(theta_i, theta_pos, pos_w, theta_neg, neg_w, means, cell_w, own_cell):
    """The fused per-head step loss (B,); gradients flow to θ_i, θ_pos and
    θ_neg only (means, weights and cell ids are data)."""
    return nomad_step_fused(theta_i, theta_pos, pos_w, theta_neg, neg_w, means, cell_w, own_cell)


def contrastive_loss(
    theta_i: torch.Tensor,  # (B, d) head positions
    theta_pos: torch.Tensor,  # (B, k, d) positive (kNN) tail positions
    pos_w: torch.Tensor,  # (B, k) p(j|i) weights (0 ⇒ edge absent)
    m_tilde: torch.Tensor,  # (B,) mean-approximated negative mass (M̃)
    theta_neg: Optional[torch.Tensor] = None,  # (B, S, d) sampled negatives
    neg_w: Optional[torch.Tensor] = None,  # (B, S) importance weights
) -> torch.Tensor:
    """The shared primitive above. Returns a scalar (mean over the batch)."""
    q_pos = cauchy(theta_i[:, None, :], theta_pos)  # (B, k)
    if theta_neg is not None:
        q_neg = cauchy(theta_i[:, None, :], theta_neg)  # (B, S)
        m_exact = torch.sum(neg_w * q_neg, -1)
    else:
        m_exact = torch.zeros(theta_i.shape[:1], dtype=torch.float32, device=theta_i.device)
    denom = q_pos + (m_tilde + m_exact)[:, None]
    per_edge = torch.log(q_pos) - torch.log(denom)
    return torch.mean(-torch.sum(pos_w * per_edge, -1))


def infonc_tsne_loss(theta_i, theta_pos, pos_w, theta_noise):
    """Eq. 2: denominators from |M| uniformly drawn noise tails (B, M, d),
    each an exact sample of unit weight; the R̃ = ∅ corner of NOMAD."""
    B, M, _ = theta_noise.shape
    m_tilde = torch.zeros((B,), dtype=torch.float32, device=theta_i.device)
    neg_w = torch.ones((B, M), dtype=torch.float32, device=theta_i.device)
    return contrastive_loss(theta_i, theta_pos, pos_w, m_tilde, theta_noise, neg_w)


def nomad_loss(
    theta_i,
    theta_pos,
    pos_w,
    means,
    counts,  # (K,) cell sizes
    cell_of_i,  # (B,) own-cell id of each head
    theta_neg,  # (B, S, d) samples drawn uniformly from the head's own cell
    n_noise: int,  # |M|
    n_total: int,  # N
):
    """Eq. 3 with R̃ = all cells except the head's own (the paper's default).

    M̃  = |M| Σ_{r≠c(i)} (|r|/N) q(i, μ_r)      — means, no gradient
    M   = |M| (|c(i)|/N) mean_s q(i, m_s)      — exact in-cell samples
    """
    B, S, _ = theta_neg.shape
    p_cell = counts.float() / float(n_total)  # (K,)
    cell_w = float(n_noise) * p_cell
    p_own = p_cell[cell_of_i]  # (B,)
    neg_w = (float(n_noise) * p_own / S)[:, None].expand(B, S)
    per_head = nomad_step_term(
        theta_i, theta_pos, pos_w, theta_neg, neg_w, means.detach(), cell_w, cell_of_i
    )
    return torch.mean(per_head)
