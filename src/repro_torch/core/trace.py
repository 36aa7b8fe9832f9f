"""The port's spans and counters: what a profiler or a reader of a run can
see of the fit's epoch step and of the index build.

* :func:`span` names a phase on the profiler's clock. While a
  ``torch.profiler`` records on the calling thread it is a
  ``record_function`` span, so the trace shows the phase and keys the
  device's idle gaps by it; it also adds its count and host seconds to
  :func:`span_totals`, for a reader that does not parse the trace. With no
  profiler it is one shared ``nullcontext``: no allocation and no op
  dispatch (a bare ``record_function`` dispatches two ops even then).
* :func:`stage` is the device-synchronised stage timer of the build
  (``build.<label>``) and of the fit (``fit.<label>``): a span around the
  stage, its seconds added to the caller's ``stage_s``.
* :func:`count` adds to a process-wide counter beside the work it counts,
  as ``kernels.registry.count_launch`` counts launches: ``kmeans.passes``
  (full passes of k-means over the rows: the LSH seeding and every
  E-step) and ``stream.read_wait_s`` (host seconds a consumer of
  ``data.store.stream_chunks`` waited on its reader thread).

The spans of the epoch step (``core/nomad.py``) are ``nomad.epoch``,
``nomad.means``, ``nomad.step`` and its children ``nomad.step.sample``,
``nomad.step.gather``, ``nomad.step.k1`` and ``nomad.step.scatter``.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict
from typing import Optional

import torch

_profiling = torch._C._autograd._profiler_enabled  # this thread's profiler is recording
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_COUNTS: dict = defaultdict(int)
_SPANS: dict = {}


class _Recorded:
    """A ``record_function`` span that also adds its host seconds to
    :func:`span_totals`: from the span's opening to its closing, its own
    recording included, so that a parent's seconds less its children's are
    the parent's own work."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.t0 = time.perf_counter()
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        dt = time.perf_counter() - self.t0
        with _LOCK:
            tot = _SPANS.setdefault(self.name, [0, 0.0])
            tot[0] += 1
            tot[1] += dt
        return False


def span(name: str):
    """A span named ``name`` while the profiler records, else a shared
    null context."""
    return _Recorded(name) if _profiling() else _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    with _LOCK:
        _COUNTS[name] += n


def counts() -> dict:
    """The process-wide counters: {name: value}."""
    with _LOCK:
        return dict(_COUNTS)


def span_totals() -> dict:
    """{span name: [count, host seconds]} of the spans closed while a
    profiler recorded."""
    with _LOCK:
        return {k: list(v) for k, v in _SPANS.items()}


def reset() -> None:
    """Zero the counters and the span totals."""
    with _LOCK:
        _COUNTS.clear()
        _SPANS.clear()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rss_mb() -> float:
    """This process's peak resident set so far (MB): ``ru_maxrss``, which
    Linux gives in kilobytes and macOS in bytes."""
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss / (1024.0 * 1024.0) if sys.platform == "darwin" else rss / 1024.0


@contextlib.contextmanager
def stage(layer: str, label: str, stage_s: dict, device: torch.device, stage_rss: Optional[dict] = None):
    """Time one stage: a ``<layer>.<label>`` span around it, its seconds to
    the device's synchronise added to ``stage_s[label]``, and the peak RSS
    at its end in ``stage_rss[label]`` (when given)."""
    with span(f"{layer}.{label}"):
        t0 = time.perf_counter()
        yield
        synchronize(device)
        stage_s[label] = stage_s.get(label, 0.0) + (time.perf_counter() - t0)
    if stage_rss is not None:
        stage_rss[label] = rss_mb()
