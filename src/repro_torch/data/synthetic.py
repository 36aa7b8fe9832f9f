"""Synthetic corpora standing in for the paper's datasets (port copy).

``gaussian_mixture`` draws with numpy from one seed, so the port and the
JAX package see the very same rows for the same arguments.
"""

from __future__ import annotations

import numpy as np


def mixture_centers(rng: np.random.Generator, n_components: int, dim: int) -> np.ndarray:
    """The mixture's unit-norm centres, (n_components, dim) float64: the
    first draws ``gaussian_mixture`` takes from its generator."""
    centers = rng.normal(0, 1, (n_components, dim))
    return centers / np.linalg.norm(centers, axis=1, keepdims=True)


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
    centers = mixture_centers(rng, n_components, dim)
    labels = rng.integers(0, n_components, n)
    x = centers[labels] + rng.normal(0, spread / np.sqrt(dim), (n, dim))
    return x.astype(np.float32), labels
