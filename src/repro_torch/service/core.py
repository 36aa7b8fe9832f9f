"""MapService: the framework-free service core behind every endpoint.

One object ties the three service pieces together —

  request → validation gate → result cache → batching engine → MapServer

— and is what the FastAPI app (``repro_torch.service.app``),
``chip_smoke.py`` and the tests all drive. Keeping the whole request path
out of the HTTP layer means the batching/caching/swap semantics are fully
testable on a bare install (the ``[service]`` extra only adds the network
skin). This is the JAX package's ``repro/service/core.py`` over the
port's serve layer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve.server import TransformResult
from repro_torch.service import cache as cache_mod
from repro_torch.service.batcher import BatcherClosed
from repro_torch.service.cache import ResultCache
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.registry import MapRegistry

# a request that raced a retire re-resolves the active map this many times
SWAP_RETRIES = 8


@dataclasses.dataclass
class ProjectOutcome:
    """One served ``/project`` request: result + serving provenance."""

    result: TransformResult
    map_version: str
    map_fingerprint: str
    cache_hit: bool
    wall_s: float


@dataclasses.dataclass
class ExploreOutcome:
    """One served ``/explore`` request: "what lives at this 2D spot?".

    ``embedding`` is the inverse head's decoded vector per coordinate;
    ``neighbor_ids``/``neighbor_dists`` are the corpus rows the frozen
    §3.2 index puts nearest to it (-1 / inf padding, as everywhere)."""

    coords: np.ndarray  # (B, 2) the query coordinates
    embedding: np.ndarray  # (B, D) decoded embedding-space vectors
    neighbor_ids: np.ndarray  # (B, k) int32 original corpus ids
    neighbor_dists: np.ndarray  # (B, k) float32 embedding-space distances
    map_version: str
    map_fingerprint: str
    wall_s: float


class MapService:
    """Registry + cache + metrics behind one ``project()`` entry point.
    ``device`` is the new registry's (default: the card; ``"cpu"`` for the
    plain path); a given ``registry`` keeps its own."""

    def __init__(
        self,
        registry: Optional[MapRegistry] = None,
        *,
        cache_entries: Optional[int] = None,
        metrics: Optional[ServiceMetrics] = None,
        device=None,
    ):
        self.registry = registry if registry is not None else MapRegistry(device=device)
        self.cache = ResultCache(1024 if cache_entries is None else cache_entries)
        self.metrics = metrics if metrics is not None else ServiceMetrics()

    # -- the request path ------------------------------------------------------

    def project(
        self,
        q,
        *,
        seed: int = 0,
        steps: Optional[int] = None,
        return_neighbors: bool = True,
        map_version: Optional[str] = None,
        use_cache: bool = True,
        timeout: float = 60.0,
    ) -> ProjectOutcome:
        """Place query rows on a served map.

        The happy path: resolve the map handle, check the result cache
        (keyed on map fingerprint × query fingerprint × seed × steps — a
        hit returns without touching the batcher or the device at all),
        else go through the batching engine. If a hot swap retires the
        resolved handle between resolution and submission, the request
        transparently re-resolves the *current* active map — a swap never
        drops a request (tested).
        """
        from repro_torch.core.nomad import prepare_inputs

        t0 = time.time()
        self.metrics.inc("project.requests")
        handle = self.registry.get(map_version)
        q = prepare_inputs(q, dim=handle.frozen.dim, caller="project")
        q = np.asarray(q)
        for attempt in range(SWAP_RETRIES):
            if steps is not None and steps != handle.server.steps:
                raise ValueError(
                    f"map {handle.version!r} serves transform_steps="
                    f"{handle.server.steps} (compiled in); got steps={steps}. "
                    "Register a version with the steps you want."
                )
            key = cache_mod.make_key(
                handle.fingerprint, q, seed, handle.server.steps, return_neighbors
            )
            if use_cache:
                hit = self.cache.get(key)
                if hit is not None:
                    self.metrics.inc("project.cache_hits")
                    wall = time.time() - t0
                    self.metrics.record_latency("project", wall)
                    return ProjectOutcome(
                        result=hit,
                        map_version=handle.version,
                        map_fingerprint=handle.fingerprint,
                        cache_hit=True,
                        wall_s=wall,
                    )
            try:
                result = handle.batcher.project(
                    q, seed=seed, return_neighbors=return_neighbors, timeout=timeout
                )
            except BatcherClosed:
                # lost the race against a hot swap: the handle we resolved
                # was retired before our rows made it in — re-resolve. An
                # explicitly pinned version does not fail over to a
                # different map behind the caller's back.
                self.metrics.inc("project.swap_retries")
                if map_version is not None:
                    raise
                handle = self.registry.get(None)
                continue
            if use_cache:
                self.cache.put(key, result)
            self.metrics.inc("project.served")
            wall = time.time() - t0
            self.metrics.record_latency("project", wall)
            return ProjectOutcome(
                result=result,
                map_version=handle.version,
                map_fingerprint=handle.fingerprint,
                cache_hit=False,
                wall_s=wall,
            )
        raise RuntimeError(
            f"request lost the swap race {SWAP_RETRIES} times in a row — "
            "is something retiring maps in a tight loop?"
        )

    def explore(
        self,
        coords,
        *,
        k: Optional[int] = None,
        map_version: Optional[str] = None,
    ) -> ExploreOutcome:
        """The inverse of :meth:`project`: given 2D map coordinate(s),
        decode an embedding-space vector with the map's inverse head and
        return the corpus rows the frozen index puts nearest to it — the
        MapExplorer "what lives at this spot?" query.

        Needs a version whose checkpoint carried ``inverse.npz``
        (``describe()['has_inverse']``); a map without one raises with
        the training hint. Explore never touches the batcher: the decode
        runs on the map's own device, then ``FrozenMap.neighbors`` (K2 →
        K3 on the card) on the handle's own frozen state, so a racing hot
        swap simply means this request answers from the map it resolved —
        exactly the ``project()`` semantics.
        """
        t0 = time.time()
        self.metrics.inc("explore.requests")
        handle = self.registry.get(map_version)
        if handle.inverse is None:
            raise ValueError(
                f"map {handle.version!r} has no inverse head — fit one with "
                "repro_torch.pipeline (train_inverse or inverse_from_frozen + "
                "save_inverse beside the checkpoint) and reload the version"
            )
        q = np.asarray(coords, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        emb = handle.inverse.decode(q, device=handle.frozen.device)  # validates shape/NaN
        ids, dists = handle.frozen.neighbors(emb, k=k)
        self.metrics.inc("explore.served")
        wall = time.time() - t0
        self.metrics.record_latency("explore", wall)
        return ExploreOutcome(
            coords=q,
            embedding=emb,
            neighbor_ids=ids,
            neighbor_dists=dists,
            map_version=handle.version,
            map_fingerprint=handle.fingerprint,
            wall_s=wall,
        )

    # -- introspection (the /health, /maps, /metrics bodies) -------------------

    def health(self) -> dict:
        active = self.registry.active_version
        return {
            "status": "ok" if active is not None else "empty",
            "active_map": active,
            "n_maps": len(self.registry.versions()),
        }

    def maps(self) -> dict:
        return {
            "active": self.registry.active_version,
            "maps": self.registry.versions(),
        }

    def metrics_snapshot(self) -> dict:
        """Everything ``/metrics`` serves: counters, request-latency
        percentiles, cache stats, and per-version batcher state (queue
        depth, batch-fill ratio, device-batch latency percentiles)."""
        snap = self.metrics.snapshot()
        snap["cache"] = self.cache.stats()
        per_map = {}
        for desc in self.registry.versions():
            handle = self.registry.get(desc["version"])
            lat = handle.batcher.recent_batch_latency()
            per_map[desc["version"]] = {
                "active": desc["active"],
                "queue_depth": handle.batcher.queue_depth(),
                **handle.batcher.stats.as_dict(),
                "batch_p50_s": TransformResult.percentile(lat, 50.0),
                "batch_p99_s": TransformResult.percentile(lat, 99.0),
            }
        snap["maps"] = per_map
        snap["active_map"] = self.registry.active_version
        return snap

    def close(self) -> None:
        self.registry.close()
