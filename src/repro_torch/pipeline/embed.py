"""Stage 1 of the embed→map→explore pipeline: streaming model embedding
(port of the JAX package's ``pipeline/embed.py``).

The paper's maps are built from vectors a real model produced. This module
drives any zoo architecture (``data/embeddings.py``'s pooled forward) over
token batches and lands the vectors **directly in a sharded on-disk store**
— the pooled ``(N, D)`` matrix never materialises on host. Two overlapped
stages run concurrently:

* a :class:`repro_torch.data.loader.Prefetcher` worker thread runs the
  model forward for batch *i+1* on the model's device, and the
  device→host copy of the pooled rows, which waits for the forward, so a
  chunk leaves the worker finished; while
* the consumer thread writes batch *i*'s rows into ``write_sharded()``
  chunks (disk I/O).

Chunk contents depend only on (params, token batches, pool): the worker
runs the same forward at the same batch shapes, in the same order, as a
materialising loop, so ``fit(embed_to_store(...))`` is bit-for-bit
``fit(embed_corpus(...))`` for every architecture family.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.embeddings import hidden_states, pool_hidden


def make_embed_fn(cfg: ArchConfig, pool: str = "mean"):
    """The ``(params, tokens (B, S)) -> pooled (B, D) f32`` forward, on the
    model's device under ``torch.inference_mode`` (``hidden_states``).
    PyTorch runs eagerly, so there is nothing to compile; the function
    fixes (cfg, pool)."""
    if pool not in ("mean", "last"):
        raise ValueError(f"unknown pool {pool!r} (want 'mean'|'last')")

    def fwd(params, tokens) -> torch.Tensor:
        return pool_hidden(hidden_states(params, cfg, tokens=tokens), pool)

    return fwd


def _batch_slices(tokens: np.ndarray, batch: int) -> Sequence[np.ndarray]:
    return [tokens[s : s + batch] for s in range(0, tokens.shape[0], batch)]


def embed_chunks(
    params,
    cfg: ArchConfig,
    token_batches: Union[np.ndarray, Sequence[np.ndarray]],
    *,
    pool: str = "mean",
    doc_batch: int = 128,
    depth: int = 2,
) -> Iterator[np.ndarray]:
    """Yield pooled ``(B, D)`` float32 chunks, model forward prefetched.

    ``token_batches`` is either a ``(N, S)`` token array (cut into
    ``doc_batch``-row forwards) or an explicit sequence of ``(B, S)``
    batches. The forward for batch *i+1* runs on a Prefetcher worker
    while the consumer (typically ``write_sharded``) handles batch *i*. A
    forward error re-raises in the consumer (Prefetcher contract), never
    hangs the pipeline.
    """
    if isinstance(token_batches, np.ndarray):
        batches: Sequence[np.ndarray] = _batch_slices(token_batches, doc_batch)
    else:
        batches = list(token_batches)
    if not batches:
        return
    fwd = make_embed_fn(cfg, pool)

    from repro_torch.data.loader import Prefetcher

    def make(step: int) -> np.ndarray:
        # .cpu() waits for the forward: the worker owns the forward AND the
        # device→host copy, the consumer only writes
        return fwd(params, batches[step]).cpu().numpy()

    pf = Prefetcher(make, depth=depth, max_steps=len(batches))
    try:
        for _ in range(len(batches)):
            _step, chunk = next(pf)
            yield chunk
    finally:
        pf.close()


def embed_to_store(
    params,
    cfg: ArchConfig,
    token_batches: Union[np.ndarray, Sequence[np.ndarray]],
    out_dir: str,
    *,
    pool: str = "mean",
    doc_batch: int = 128,
    rows_per_shard: int = 8192,
    dtype: str = "float32",
    depth: int = 2,
):
    """Embed token batches straight into a sharded store at ``out_dir``.

    Peak host memory is O(doc_batch · D + rows_per_shard · D): the chunk
    iterator feeds ``write_sharded`` which re-blocks rows to shards and
    commits ``meta.json`` last (a crashed embed run never leaves a
    directory that parses as a store). Returns the committed
    :class:`repro_torch.data.store.ShardedStore`.
    """
    from repro_torch.data.store import write_sharded

    return write_sharded(
        embed_chunks(params, cfg, token_batches, pool=pool, doc_batch=doc_batch, depth=depth),
        out_dir,
        rows_per_shard=rows_per_shard,
        dtype=dtype,
    )


def embed_dim(cfg: ArchConfig) -> int:
    """The pooled-vector dimensionality of an embedder (== d_model)."""
    return cfg.d_model


def n_embed_batches(n_docs: int, doc_batch: int) -> int:
    return math.ceil(n_docs / doc_batch)


def init_embedder(workload, seed: int = 0, *, device=None, **arch_overrides):
    """(params, reduced ArchConfig) for one named pipeline workload: the
    model initialised on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    from repro_torch.core.runtime import resolve_device
    from repro_torch.models import lm

    acfg = workload.arch_config(**arch_overrides)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return lm.init_params(acfg, generator=gen), acfg


def corpus_for(workload, seed: Optional[int] = None):
    """The workload's synthetic class-structured token corpus."""
    from repro_torch.data.synthetic import class_token_corpus

    return class_token_corpus(
        workload.n_docs,
        workload.seq_len,
        workload.vocab_size,
        n_classes=workload.n_classes,
        seed=0 if seed is None else seed,
    )
