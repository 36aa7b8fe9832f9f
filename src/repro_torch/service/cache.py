"""LRU result cache for ``/project`` responses.

A cache entry is one full :class:`repro_torch.serve.TransformResult`, keyed on
everything that determines it bit-for-bit:

  (map fingerprint, query fingerprint, seed, steps, return_neighbors)

The *map* fingerprint is content-derived (``data_fingerprint`` over the
frozen θ rows — see ``repro_torch.service.registry.map_fingerprint``), so a hot
swap to a genuinely different map can never serve stale placements, while
re-registering the same checkpoint under a new version label keeps its
warm cache. The *query* fingerprint hashes the exact canonical float32
bytes of the query rows: ``data_fingerprint``'s sampled row hash is built
for 10⁸-row training corpora where a full pass is the cost being avoided;
a service query is a handful of rows, and a cache that can confuse two
different queries is worse than no cache — so below
``EXACT_FINGERPRINT_ROWS`` (every realistic request) the fingerprint is
exact, and only beyond it falls back to ``data_fingerprint``'s sampled
scheme.

Hits return the stored result object; results are immutable by the serve
layer's convention (nothing downstream writes to a TransformResult).
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Optional, Tuple

import numpy as np

from repro_torch.serve.server import TransformResult

# full-bytes hashing up to this many query rows; sampled beyond (a 4096×1024
# float32 request is 16 MB — still < 2ms to sha256)
EXACT_FINGERPRINT_ROWS = 65536

CacheKey = Tuple[str, str, int, int, bool]


def query_fingerprint(q: np.ndarray) -> str:
    """Content hash of one canonical (float32, C-contiguous) query array."""
    q = np.ascontiguousarray(q, np.float32)
    if q.shape[0] <= EXACT_FINGERPRINT_ROWS:
        h = hashlib.sha256()
        h.update(repr(q.shape).encode())
        h.update(q.tobytes())
        return h.hexdigest()[:16]
    from repro_torch.index.ann import data_fingerprint

    return data_fingerprint(q)


def make_key(
    map_fingerprint: str,
    q: np.ndarray,
    seed: int,
    steps: int,
    return_neighbors: bool = True,
) -> CacheKey:
    return (
        map_fingerprint,
        query_fingerprint(q),
        int(seed),
        int(steps),
        bool(return_neighbors),
    )


class ResultCache:
    """A plain thread-safe LRU over :class:`TransformResult` entries.

    ``capacity=0`` disables caching (every get misses, puts drop)."""

    def __init__(self, capacity: int = 1024):
        if capacity < 0:
            raise ValueError("cache capacity must be >= 0")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[CacheKey, TransformResult]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: CacheKey) -> Optional[TransformResult]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: CacheKey, result: TransformResult) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "size": len(self._entries),
                "capacity": self.capacity,
            }
