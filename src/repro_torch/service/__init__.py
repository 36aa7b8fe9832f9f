"""The map-serving service layer: HTTP front end over ``repro_torch.serve``
(the JAX package's ``repro.service``, ported).

Layering (each piece independently testable, all dependency-free except
the optional HTTP skin)::

    app.py (FastAPI, [service] extra)      — the network skin
      └─ core.py   MapService             — validation → cache → batcher
           ├─ cache.py    ResultCache     — LRU keyed on (map, query,
           │                                seed, steps) fingerprints
           ├─ registry.py MapRegistry     — versioned maps, warm + atomic
           │                                hot swap + drain
           │    └─ batcher.py Batcher     — coalesces concurrent requests
           │         └─ repro_torch.serve.MapServer.transform_batch
           └─ metrics.py ServiceMetrics   — counters + latency windows

The batching engine returns, per request, exactly the bits a dedicated
``MapServer.transform`` call would (per-row seeds/rows — see
``batcher.py``); the cache returns them without touching the device; the
registry swaps maps under load without dropping either.
"""

from repro_torch.service.batcher import Batcher, BatcherClosed, BatcherStats
from repro_torch.service.cache import ResultCache, make_key, query_fingerprint
from repro_torch.service.core import ExploreOutcome, MapService, ProjectOutcome
from repro_torch.service.metrics import LatencyWindow, ServiceMetrics
from repro_torch.service.registry import MapHandle, MapRegistry, map_fingerprint

__all__ = [
    "Batcher",
    "BatcherClosed",
    "BatcherStats",
    "ExploreOutcome",
    "LatencyWindow",
    "MapHandle",
    "MapRegistry",
    "MapService",
    "ProjectOutcome",
    "ResultCache",
    "ServiceMetrics",
    "create_app",
    "make_key",
    "map_fingerprint",
    "query_fingerprint",
]


def create_app(*args, **kwargs):
    """Lazy re-export of :func:`repro_torch.service.app.create_app` (keeps
    the fastapi import out of ``import repro_torch.service`` on bare
    installs)."""
    from repro_torch.service.app import create_app as _create_app

    return _create_app(*args, **kwargs)
