"""Synthetic corpora standing in for the paper's datasets (port copy).

``gaussian_mixture`` draws with numpy from one seed, so the port and the
JAX package see the very same rows for the same arguments.
"""

from __future__ import annotations

import numpy as np


def gaussian_mixture(
    n: int,
    dim: int,
    n_components: int = 10,
    spread: float = 0.15,
    seed: int = 0,
):
    """Well-separated clusters on a hypersphere shell.

    Returns (x (n, dim) float32, labels (n,) int64).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (n_components, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, n_components, n)
    x = centers[labels] + rng.normal(0, spread / np.sqrt(dim), (n, dim))
    return x.astype(np.float32), labels
