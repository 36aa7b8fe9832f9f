"""Random triplet accuracy (paper §4, following Wang et al. [27]): the
probability that a random triplet keeps its pairwise-distance ordering
between the high- and low-dimensional spaces. The JAX package's numpy
computation, draw for draw, so both packages score a map the same."""

from __future__ import annotations

import numpy as np


def random_triplet_accuracy(x_high: np.ndarray, x_low: np.ndarray, n_triplets: int = 20_000,
                            seed: int = 0) -> float:
    n = x_high.shape[0]
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, n_triplets)
    j = rng.integers(0, n, n_triplets)
    k = rng.integers(0, n, n_triplets)
    ok = (i != j) & (j != k) & (i != k)
    i, j, k = i[ok], j[ok], k[ok]

    def d2(x, a, b):
        diff = x[a].astype(np.float32) - x[b].astype(np.float32)
        return np.sum(diff * diff, axis=-1)

    hi = d2(x_high, i, j) < d2(x_high, i, k)
    lo = d2(x_low, i, j) < d2(x_low, i, k)
    return float(np.mean(hi == lo))
