"""Out-of-sample projection and serving: ``transform()`` on a frozen map.

``FrozenMap`` holds a fitted (or checkpoint-loaded) map on one device;
``MapServer`` places batches of queries on it; ``NomadProjection.transform``
is the estimator's front door.
"""

from repro_torch.serve.frozen import FrozenMap
from repro_torch.serve.server import BatchOutput, MapServer, TransformResult, resolve_serve_strategy

__all__ = ["BatchOutput", "FrozenMap", "MapServer", "TransformResult", "resolve_serve_strategy"]
