"""Synthetic corpora standing in for the paper's datasets (port copy).

``gaussian_mixture`` and ``class_token_corpus`` draw with numpy from one
seed, so the port and the JAX package see the very same rows and tokens
for the same arguments.
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


def class_token_corpus(
    n_docs: int,
    seq_len: int,
    vocab_size: int,
    n_classes: int = 8,
    keep: float = 0.7,
    seed: int = 0,
):
    """A token corpus with latent document classes — the embed→map
    pipeline's stand-in for a real text corpus.

    Each class owns a base token sequence; a document keeps each base
    token with probability ``keep`` and replaces the rest with uniform
    noise, so documents of one class share ~``keep`` of their tokens and
    an embedding model (even an untrained one: mean-pooled token
    embeddings are class-token histograms) separates the classes.

    Returns ``(tokens (n_docs, seq_len) int32, classes (n_docs,) int64)``.
    """
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, n_classes, n_docs)
    base = rng.integers(0, vocab_size, (n_classes, seq_len))
    noise = rng.integers(0, vocab_size, (n_docs, seq_len))
    mask = rng.random((n_docs, seq_len)) < keep
    tokens = np.where(mask, base[classes], noise).astype(np.int32)
    return tokens, classes
