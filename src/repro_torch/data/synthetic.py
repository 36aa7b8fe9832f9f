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


def gaussian_mixture_store(
    out_dir: str,
    n: int,
    dim: int,
    n_components: int = 10,
    spread: float = 0.15,
    seed: int = 0,
    *,
    chunk_rows: int = 8192,
    rows_per_shard: int = 65536,
    dtype: str = "float32",
):
    """:func:`gaussian_mixture`, generated chunk by chunk straight into a
    sharded on-disk store: the corpus never materialises in host RAM.

    Returns ``(store, labels)``. ``np.random.Generator`` draws normals
    sequentially from its bit stream, so chunked draws give exactly the
    rows one ``(n, dim)`` draw gives: the store holds
    ``gaussian_mixture(n, dim, ...)``'s float32 values (before the storage
    dtype's rounding).
    """
    from repro_torch.data.store import write_sharded

    rng = np.random.default_rng(seed)
    centers = mixture_centers(rng, n_components, dim)
    labels = rng.integers(0, n_components, n)

    def chunks():
        for s in range(0, n, chunk_rows):
            lab = labels[s : s + chunk_rows]
            yield (centers[lab] + rng.normal(0, spread / np.sqrt(dim), (lab.size, dim))).astype(np.float32)

    store = write_sharded(chunks(), out_dir, rows_per_shard=rows_per_shard, dtype=dtype)
    return store, labels
