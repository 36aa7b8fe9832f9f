"""The Cauchy affinity kernel (paper Eq. 1): q(θi, θj) = 1 / (1 + ‖θi−θj‖²).

All affinity math is fp32: near q→1 the gradient is dominated by the tiny
‖θi−θj‖² term and bf16 rounding destroys the spring forces.
"""

from __future__ import annotations

import torch


def cauchy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise-broadcast Cauchy affinity over the last axis."""
    d2 = torch.sum(torch.square(a.float() - b.float()), -1)
    return 1.0 / (1.0 + d2)


def cauchy_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, d) × (Nb, d) → (Na, Nb) Cauchy affinities, in the JAX package's
    product form ‖a‖² + ‖b‖² − 2ab, clamped at 0 before the affinity."""
    a = a.float()
    b = b.float()
    d2 = torch.sum(torch.square(a), -1)[:, None] + torch.sum(torch.square(b), -1)[None, :] - 2.0 * (a @ b.T)
    return 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
