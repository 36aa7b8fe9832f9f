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

