"""The end-to-end driver: embed → store → fit → inverse → explore-ready
(port of the JAX package's ``pipeline/run.py``).

``run_pipeline`` strings the stages of one named
:class:`repro_torch.configs.PipelineWorkload` together and leaves behind a
self-contained map directory a service node can pick up cold:

* ``<workdir>/embeddings/`` — the sharded corpus store stage 1 streamed
  (the pooled ``(N, D)`` matrix never existed on host),
* ``<workdir>/map/``        — θ checkpoints + ``index.npz`` from the fit,
  plus ``inverse.npz`` — the stage-2 head — beside them, so
  ``MapRegistry.load(dir)`` serves both ``project`` and ``explore``
  from the directory alone.

Stage walls land in ``PipelineResult.stage_s`` and the inverse round-trip
R² in ``PipelineResult.roundtrip_score``. Every stage runs on ``device``
(default: the card).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from repro_torch.configs.nomad_workloads import PipelineWorkload


@dataclasses.dataclass
class PipelineResult:
    """Everything one pipeline run produced (see module docstring)."""

    workload: PipelineWorkload
    store: object  # ShardedStore — the streamed corpus on disk
    fit: object  # core.nomad.FitResult
    frozen: object  # serve.frozen.FrozenMap
    inverse: object  # pipeline.inverse.InverseProjection
    classes: np.ndarray  # (N,) latent corpus classes (synthetic ground truth)
    checkpoint_dir: str  # the map dir (θ + index.npz + inverse.npz)
    roundtrip_score: float  # inverse R² over the map's own rows
    stage_s: dict  # {"embed": s, "fit": s, "inverse_train": s}


def run_pipeline(
    workload: PipelineWorkload,
    workdir: str,
    *,
    seed: int = 0,
    pool: Optional[str] = None,
    chunk_rows: int = 1_024,
    inverse_steps: int = 600,
    inverse_hidden=(64, 64),
    nomad_overrides: Optional[dict] = None,
    device=None,
) -> PipelineResult:
    """Run embed→store→fit→inverse for one workload under ``workdir``.

    ``chunk_rows`` is pinned (not auto) so the fit is bit-reproducible
    against a materialised run of the same vectors. ``nomad_overrides``
    forwards extra :class:`NomadConfig` fields (tests shrink epochs with
    it). Stage walls end with the stage's results on the host.
    """
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.runtime import resolve_device
    from repro_torch.pipeline.embed import corpus_for, embed_to_store, init_embedder
    from repro_torch.pipeline.inverse import inverse_from_frozen, roundtrip_score, save_inverse
    from repro_torch.serve.frozen import FrozenMap

    device = resolve_device(device)
    stage_s = {}
    tokens, classes = corpus_for(workload, seed=seed)
    params, acfg = init_embedder(workload, seed=seed, device=device)

    t0 = time.perf_counter()
    store = embed_to_store(
        params,
        acfg,
        tokens,
        os.path.join(workdir, "embeddings"),
        pool=workload.pool if pool is None else pool,
        doc_batch=workload.doc_batch,
    )
    stage_s["embed"] = time.perf_counter() - t0

    ckdir = os.path.join(workdir, "map")
    cfg = workload.nomad_config(
        store.shape[0],
        store.shape[1],
        seed=seed,
        chunk_rows=chunk_rows,
        checkpoint_dir=ckdir,
        **(nomad_overrides or {}),
    )
    t0 = time.perf_counter()
    fit = NomadProjection(cfg, device=device).fit(store)
    stage_s["fit"] = time.perf_counter() - t0

    frozen = FrozenMap.from_fit(fit, cfg, device=device)
    t0 = time.perf_counter()
    inverse = inverse_from_frozen(frozen, hidden=tuple(inverse_hidden), steps=inverse_steps, seed=seed)
    stage_s["inverse_train"] = time.perf_counter() - t0
    save_inverse(ckdir, inverse)

    score = roundtrip_score(inverse, fit.embedding, store.materialize(), device=device)
    return PipelineResult(
        workload=workload,
        store=store,
        fit=fit,
        frozen=frozen,
        inverse=inverse,
        classes=classes,
        checkpoint_dir=ckdir,
        roundtrip_score=score,
        stage_s=stage_s,
    )
