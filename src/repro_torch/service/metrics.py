"""Thread-safe service counters and latency windows (the JAX package's
``repro/service/metrics.py``, over the port's serve layer).

Deliberately framework-free: the FastAPI app, the batching engine and the
load-test benchmark all report through the same two primitives, so
``/metrics`` works (and is testable) without the ``[service]`` extra
installed. Quantiles go through ``TransformResult.percentile`` — one
percentile implementation across the serve layer, the benchmarks and the
metrics endpoint.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict

from repro_torch.serve.server import TransformResult


class LatencyWindow:
    """A bounded sliding window of wall clocks with p50/p99 snapshots.

    Keeps the most recent ``maxlen`` observations — a service that has
    been up for a week should report *current* tail latency, not the
    all-time histogram — plus a lifetime count.
    """

    def __init__(self, maxlen: int = 2048):
        self._window = collections.deque(maxlen=maxlen)
        self._count = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._window.append(float(seconds))
            self._count += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = list(self._window)
            count = self._count
        return {
            "count": count,
            "window": len(vals),
            "p50_s": TransformResult.percentile(vals, 50.0),
            "p99_s": TransformResult.percentile(vals, 99.0),
        }


class ServiceMetrics:
    """Named monotonic counters + named latency windows, all thread-safe."""

    def __init__(self):
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()
        self._latencies: Dict[str, LatencyWindow] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def count(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def latency(self, name: str) -> LatencyWindow:
        with self._lock:
            win = self._latencies.get(name)
            if win is None:
                win = self._latencies[name] = LatencyWindow()
            return win

    def record_latency(self, name: str, seconds: float) -> None:
        self.latency(name).record(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(sorted(self._counters.items()))
            windows = dict(self._latencies)
        return {
            "counters": counters,
            "latency": {k: w.snapshot() for k, w in sorted(windows.items())},
        }
