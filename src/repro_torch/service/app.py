"""The HTTP skin: a FastAPI app over one :class:`MapService`.

The JAX package's ``repro/service/app.py`` over the port's
:class:`MapService`. This module is the only place the ``[service]``
optional extra (fastapi / uvicorn / httpx) is touched, and every import
is guarded: a bare install can import ``repro_torch.service`` — batcher,
cache, registry, core are all dependency-free — and only ``create_app()``
raises, with the install hint. Endpoints:

* ``GET  /health``  — 200 with the active map, 503 while no map is live
  (what a load balancer should probe);
* ``POST /project`` — place query rows: body ``{"rows": [[...], ...],
  "seed": 0, "return_neighbors": true, "map_version": null}``. Responses
  carry the serving provenance (map version + fingerprint, cache_hit,
  batch count). Neighbor distances use ``-1.0`` where the neighbor id is
  ``-1`` (dead edge): the float payload stays strict-JSON (no
  ``Infinity`` literals);
* ``POST /explore`` — the inverse: body ``{"coords": [[x, y], ...],
  "k": null, "map_version": null}``. Each 2D map coordinate is decoded
  to an embedding-space vector by the map's inverse head (the
  ``inverse.npz`` saved beside the map) and answered
  with the nearest corpus rows from the frozen index — "what lives at
  this spot?". 400 when the served map has no inverse head;
* ``GET  /maps``    — every registered version + which one is active;
* ``POST /maps``    — hot swap: load a checkpoint dir, warm, activate,
  optionally retire the old version — all while serving;
* ``POST /maps/{version}/activate`` — flip the active pointer only;
* ``GET  /metrics`` — request counters per endpoint, cache stats, queue
  depth, batch-fill ratio, p50/p99 request and device-batch latency.

Run it with uvicorn, e.g.::

    service = MapService(); service.registry.load("ck/")
    uvicorn.run(create_app(service), host="0.0.0.0", port=8000)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.service.core import MapService

try:  # the [service] extra — keep the core importable without it
    from fastapi import FastAPI, HTTPException
    from pydantic import BaseModel, Field

    HAVE_FASTAPI = True
except ImportError:  # pragma: no cover - exercised on bare installs
    HAVE_FASTAPI = False
    FastAPI = None  # type: ignore[assignment]

    class BaseModel:  # type: ignore[no-redef]
        pass

    def Field(*a, **k):  # type: ignore[no-redef]
        return None


class ProjectRequest(BaseModel):
    rows: List[List[float]] = Field(..., description="(n, dim) query rows")
    seed: int = 0
    return_neighbors: bool = True
    map_version: Optional[str] = None
    use_cache: bool = True


class ExploreRequest(BaseModel):
    coords: List[List[float]] = Field(..., description="(n, 2) map coordinates")
    k: Optional[int] = None
    map_version: Optional[str] = None


class SwapRequest(BaseModel):
    checkpoint_dir: str
    version: Optional[str] = None
    retire_old: bool = True


def _json_dists(ids: np.ndarray, dists: np.ndarray) -> list:
    """inf (dead edge) → -1.0 so the payload stays strict JSON."""
    return np.where(ids >= 0, dists, -1.0).astype(float).tolist()


def create_app(service: Optional[MapService] = None, **service_kw):
    """Build the FastAPI app over ``service`` (a fresh empty
    :class:`MapService` when omitted — load maps via ``POST /maps``)."""
    if not HAVE_FASTAPI:
        raise RuntimeError(
            "the HTTP service needs the [service] extra: "
            "pip install 'repro-nomad[service]'"
        )
    svc = service if service is not None else MapService(**service_kw)
    app = FastAPI(
        title="NOMAD map service",
        description="Out-of-sample projection over frozen NOMAD maps",
    )
    app.state.service = svc

    @app.get("/health")
    def health():
        svc.metrics.inc("http./health")
        body = svc.health()
        if body["status"] != "ok":
            raise HTTPException(status_code=503, detail=body)
        return body

    @app.post("/project")
    def project(req: ProjectRequest):
        svc.metrics.inc("http./project")
        q = np.asarray(req.rows, np.float32)
        try:
            outcome = svc.project(
                q,
                seed=req.seed,
                return_neighbors=req.return_neighbors,
                map_version=req.map_version,
                use_cache=req.use_cache,
            )
        except (ValueError, KeyError, RuntimeError) as e:
            # validation-gate rejects (dim/NaN/steps), unknown versions,
            # and "no active map" are all caller errors at this layer
            status = 404 if isinstance(e, KeyError) else 400
            raise HTTPException(status_code=status, detail=str(e)) from None
        res = outcome.result
        body = {
            "map_version": outcome.map_version,
            "map_fingerprint": outcome.map_fingerprint,
            "cache_hit": outcome.cache_hit,
            "wall_s": outcome.wall_s,
            "n_queries": res.n_queries,
            "n_batches": len(res.batch_latency_s),
            "embedding": res.embedding.astype(float).tolist(),
            "cells": res.cells.astype(int).tolist(),
        }
        if req.return_neighbors:
            body["neighbor_ids"] = res.neighbor_ids.astype(int).tolist()
            body["neighbor_dists"] = _json_dists(
                res.neighbor_ids, res.neighbor_dists
            )
        return body

    @app.post("/explore")
    def explore(req: ExploreRequest):
        svc.metrics.inc("http./explore")
        try:
            outcome = svc.explore(
                np.asarray(req.coords, np.float32),
                k=req.k,
                map_version=req.map_version,
            )
        except (ValueError, KeyError, RuntimeError) as e:
            status = 404 if isinstance(e, KeyError) else 400
            raise HTTPException(status_code=status, detail=str(e)) from None
        return {
            "map_version": outcome.map_version,
            "map_fingerprint": outcome.map_fingerprint,
            "wall_s": outcome.wall_s,
            "embedding": outcome.embedding.astype(float).tolist(),
            "neighbor_ids": outcome.neighbor_ids.astype(int).tolist(),
            "neighbor_dists": _json_dists(
                outcome.neighbor_ids, outcome.neighbor_dists
            ),
        }

    @app.get("/maps")
    def maps():
        svc.metrics.inc("http./maps")
        return svc.maps()

    @app.post("/maps")
    def swap(req: SwapRequest):
        svc.metrics.inc("http./maps.swap")
        try:
            handle = svc.registry.swap(
                req.checkpoint_dir, version=req.version, retire_old=req.retire_old
            )
        except (FileNotFoundError, ValueError) as e:
            raise HTTPException(status_code=400, detail=str(e)) from None
        return {"activated": handle.version, "map": handle.describe()}

    @app.post("/maps/{version}/activate")
    def activate(version: str):
        svc.metrics.inc("http./maps.activate")
        try:
            handle = svc.registry.activate(version)
        except KeyError as e:
            raise HTTPException(status_code=404, detail=str(e)) from None
        return {"activated": handle.version}

    @app.get("/metrics")
    def metrics():
        svc.metrics.inc("http./metrics")
        return svc.metrics_snapshot()

    return app
