"""Map registry: versioned frozen maps with atomic hot swap.

A production map service outlives any single map: corpora are refit
nightly and the serving fleet must pick the new checkpoint up without
dropping traffic. ``MapRegistry`` owns that lifecycle:

* :meth:`load` — build a :class:`FrozenMap` from a checkpoint dir (or
  :meth:`add` an in-process FrozenMap / MapServer), wrap it in a
  :class:`MapServer` + :class:`Batcher`, and **warm** it (one single-row
  transform through the path the batcher uses, which on the card builds
  and loads the kernels, *before* the version can take traffic);
* :meth:`activate` — flip the active pointer. The flip is one reference
  assignment under the registry lock: requests that already resolved the
  old handle keep it and complete on the map they started on, requests
  resolving after the flip get the new one — no request ever sees half a
  swap or rows from two maps;
* :meth:`retire` — drain the old version's batcher (in-flight requests
  finish), close it, and drop the handle;
* :meth:`swap` — load → warm → activate → retire(old), the one-call hot
  swap used by the ``POST /maps`` endpoint.

Each handle carries a content-derived ``fingerprint``
(:func:`map_fingerprint` — ``data_fingerprint`` over the frozen θ rows,
the JAX package's hex for the same θ), which is what the result cache
keys on: a swap to a genuinely different map invalidates by
construction, while reloading identical state under a new label keeps
its warm cache.

This is the JAX package's ``repro/service/registry.py`` over the port's
serve layer. Maps loaded from a checkpoint land on the registry's
``device`` (default: the card; ``"cpu"`` for the plain path).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.serve.frozen import FrozenMap
from repro_torch.serve.server import MapServer
from repro_torch.service.batcher import Batcher


def map_fingerprint(frozen: FrozenMap) -> str:
    """Content hash of the served state — ``data_fingerprint`` (shape +
    row sample + column checksums) over the frozen θ rows, copied to the
    host (10 MB at N = 1M)."""
    from repro_torch.index.ann import data_fingerprint

    return data_fingerprint(frozen.theta_rows.detach().cpu().numpy())


@dataclasses.dataclass
class MapHandle:
    """One servable map version: frozen state + server + batcher, plus the
    optional inverse head (2D → embedding) when the checkpoint carried an
    ``inverse.npz`` — what the ``/explore`` endpoint decodes with."""

    version: str
    server: MapServer
    batcher: Batcher
    fingerprint: str
    source: str = "in-process"
    created_at: float = dataclasses.field(default_factory=time.time)
    inverse: Optional[object] = None  # repro_torch.pipeline.inverse.InverseProjection

    @property
    def frozen(self) -> FrozenMap:
        return self.server.frozen

    def describe(self) -> dict:
        fz = self.frozen
        return {
            "version": self.version,
            "fingerprint": self.fingerprint,
            "source": self.source,
            "created_at": self.created_at,
            "n_points": fz.n_points,
            "dim": fz.dim,
            "out_dim": fz.out_dim,
            "n_clusters": fz.n_clusters,
            "steps": self.server.steps,
            "strategy": self.server.strategy,
            "n_shards": self.server.n_shards,
            "microbatch": self.server.microbatch,
            "batch_rows": self.server.batch_rows,
            "has_inverse": self.inverse is not None,
        }


class MapRegistry:
    """Versioned :class:`MapHandle` store with an atomic active pointer.
    ``device`` is where :meth:`load` puts a checkpoint's map (default: the
    card)."""

    def __init__(self, *, device=None):
        self.device = device
        self._maps: Dict[str, MapHandle] = {}
        self._active: Optional[str] = None
        self._lock = threading.RLock()
        self._seq = 0

    # -- registration ----------------------------------------------------------

    def add(
        self,
        frozen_or_server: Union[FrozenMap, MapServer],
        *,
        version: Optional[str] = None,
        activate: bool = True,
        warm: bool = True,
        source: str = "in-process",
        max_delay_s: Optional[float] = None,
        inverse=None,
        **server_kw,
    ) -> MapHandle:
        """Register an already-loaded FrozenMap (or a configured MapServer).

        Warming runs one single-row transform through the server on the
        caller's thread — the same ``transform_batch`` path the batcher
        takes, so on the card the kernels are built and loaded before
        :meth:`activate` exposes the version to traffic: a hot swap must
        never stall live requests on a cold build. ``inverse`` optionally
        attaches a trained
        :class:`repro_torch.pipeline.inverse.InverseProjection` so the
        version can serve ``/explore``.
        """
        if isinstance(frozen_or_server, MapServer):
            if server_kw:
                raise ValueError("pass server options with a FrozenMap, not a MapServer")
            server = frozen_or_server
        else:
            server = MapServer(frozen_or_server, **server_kw)
        if warm:
            server.transform(np.zeros((1, server.frozen.dim), np.float32), seed=0)
        handle = MapHandle(
            version="",
            server=server,
            batcher=Batcher(server, max_delay_s=max_delay_s),
            fingerprint=map_fingerprint(server.frozen),
            source=source,
            inverse=inverse,
        )
        with self._lock:
            if version is None:
                self._seq += 1
                version = f"v{self._seq}"
            if version in self._maps:
                handle.batcher.close(drain=False)
                raise ValueError(f"map version {version!r} already registered")
            handle.version = version
            self._maps[version] = handle
            if activate or self._active is None:
                self._active = version
        return handle

    def load(
        self,
        checkpoint_dir: str,
        *,
        version: Optional[str] = None,
        cfg=None,
        activate: bool = True,
        warm: bool = True,
        max_delay_s: Optional[float] = None,
        **server_kw,
    ) -> MapHandle:
        """Load a checkpoint dir into a servable version (θ + index cache,
        no training data — the ``FrozenMap.from_checkpoint`` path) on the
        registry's device. An ``inverse.npz`` beside the
        checkpoint (``save_inverse`` writes one) is picked up
        automatically, so a hot swap carries the explore head with the
        map."""
        from repro_torch.pipeline.inverse import load_inverse

        frozen = FrozenMap.from_checkpoint(checkpoint_dir, cfg, device=self.device)
        return self.add(
            frozen,
            version=version,
            activate=activate,
            warm=warm,
            source=checkpoint_dir,
            max_delay_s=max_delay_s,
            inverse=load_inverse(checkpoint_dir, missing_ok=True),
            **server_kw,
        )

    def load_lineage(
        self,
        lineage_root: str,
        *,
        map_version: Optional[str] = None,
        version: Optional[str] = None,
        **load_kw,
    ) -> MapHandle:
        """Load a version from a ``versions.json`` lineage (the artifact
        layout ``partial_fit`` grows under one checkpoint root).

        ``map_version`` names the lineage entry (default: the newest —
        "serve the latest map"); ``version`` is the registry label it
        serves under (default: the lineage name, so a hot swap onto a
        grown map reads ``registry.load_lineage(root)`` and the service's
        ``/versions`` listing shows ``v1``, ``v2`` … matching the lineage).
        Every lineage version directory is self-contained, so this is just
        resolution + the ordinary :meth:`load`.
        """
        from repro_torch.checkpoint.lineage import MapLineage

        v = MapLineage(lineage_root).resolve(map_version)
        return self.load(v.path, version=version or v.name, **load_kw)

    # -- resolution ------------------------------------------------------------

    def get(self, version: Optional[str] = None) -> MapHandle:
        """The handle for ``version`` (default: the active map)."""
        with self._lock:
            if version is None:
                if self._active is None:
                    raise RuntimeError(
                        "no active map — register one with load()/add() first"
                    )
                return self._maps[self._active]
            try:
                return self._maps[version]
            except KeyError:
                raise KeyError(
                    f"unknown map version {version!r} "
                    f"(have {sorted(self._maps)})"
                ) from None

    @property
    def active_version(self) -> Optional[str]:
        with self._lock:
            return self._active

    def versions(self) -> List[dict]:
        with self._lock:
            handles = list(self._maps.values())
            active = self._active
        out = [h.describe() for h in sorted(handles, key=lambda h: h.created_at)]
        for d in out:
            d["active"] = d["version"] == active
        return out

    # -- lifecycle -------------------------------------------------------------

    def activate(self, version: str) -> MapHandle:
        with self._lock:
            handle = self.get(version)
            self._active = version
            return handle

    def retire(self, version: str, *, timeout: float = 60.0) -> None:
        """Drain and drop a non-active version. In-flight requests finish
        (the batcher drains before closing); new submissions to the
        retired handle raise ``BatcherClosed``, which the service layer
        retries onto the current active map."""
        with self._lock:
            if version == self._active:
                raise ValueError(
                    f"refusing to retire the active map {version!r} — "
                    "activate a replacement first"
                )
            handle = self.get(version)
            del self._maps[version]
        handle.batcher.close(drain=True, timeout=timeout)

    def swap(
        self,
        checkpoint_dir: str,
        *,
        version: Optional[str] = None,
        retire_old: bool = True,
        timeout: float = 60.0,
        **load_kw,
    ) -> MapHandle:
        """Hot swap: load + warm the new version, flip the pointer, drain
        the old. Requests in flight on the old map complete there; nothing
        is dropped (tested under concurrent load)."""
        with self._lock:
            old = self._active
        handle = self.load(
            checkpoint_dir, version=version, activate=True, warm=True, **load_kw
        )
        if retire_old and old is not None and old != handle.version:
            self.retire(old, timeout=timeout)
        return handle

    def close(self, *, timeout: float = 60.0) -> None:
        """Drain and close every version (service shutdown)."""
        with self._lock:
            handles = list(self._maps.values())
            self._maps.clear()
            self._active = None
        for h in handles:
            h.batcher.close(drain=True, timeout=timeout)
