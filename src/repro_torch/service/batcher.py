"""The dynamic batching engine: concurrent requests → device batches.

``Batcher`` sits between the service endpoints and one
:class:`repro_torch.serve.MapServer`. Concurrent ``project()`` calls
enqueue their rows; a single worker thread coalesces whatever is waiting
into fixed ``MapServer.batch_rows``-row device batches — holding a
*partial* batch open for at most ``max_delay_s`` in case more requests
arrive — and fans the rows of each batch back out to the requests they
came from.

Correctness rests on one property of the serve layer: a batch takes
**per-row seeds and per-row local row ids**, and every row's placement
depends only on its own ``(x, seed, row)`` and the frozen state (random
numbers are a counter hash of the row's seed and id, and every kernel
sums per row in a fixed order; pad rows only dilute the *reported*
loss). A request is chunked into items of at most ``batch_rows`` rows,
each row keeping the request's seed and its 0-based offset within the
request — exactly the numbering a dedicated ``MapServer.transform(q,
seed=...)`` call uses. Any interleaving of concurrent requests therefore
returns placements bit-identical to one direct transform per request
(tested, on the CPU and on the card), with one deliberate exception:
``TransformResult.batch_loss`` is reported as NaN for coalesced results,
because a shared batch's loss mixes rows of several requests and cannot
be attributed to one of them.

The worker thread places its batches on the map's own device
(``MapServer.transform_batch`` takes it from the ``FrozenMap``), never on
the thread's current CUDA device. The batcher itself is framework-free —
the FastAPI app drives it over HTTP, tests and ``chip_smoke.py`` drive it
directly.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.serve.server import MapServer, TransformResult


class BatcherClosed(RuntimeError):
    """Raised by submissions to a closed (draining or shut down) batcher."""


class _Request:
    """One logical ``project()`` call: output buffers + completion event."""

    __slots__ = (
        "n",
        "seed",
        "return_neighbors",
        "embedding",
        "cells",
        "neighbor_ids",
        "neighbor_dists",
        "remaining_rows",
        "done",
        "error",
        "latencies",
        "t_submit",
    )

    def __init__(self, n: int, seed: int, out_dim: int, k: int, return_neighbors: bool):
        self.n = n
        self.seed = np.uint32(seed & 0xFFFFFFFF)
        self.return_neighbors = return_neighbors
        self.embedding = np.empty((n, out_dim), np.float32)
        self.cells = np.empty((n,), np.int64)
        self.neighbor_ids = np.empty((n, k), np.int64) if return_neighbors else None
        self.neighbor_dists = (
            np.empty((n, k), np.float32) if return_neighbors else None
        )
        self.remaining_rows = n
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.latencies: List[float] = []
        self.t_submit = time.monotonic()


class _Item:
    """A contiguous row range of one request, as queued for coalescing."""

    __slots__ = ("request", "q", "offset")

    def __init__(self, request: _Request, q: np.ndarray, offset: int):
        self.request = request
        self.q = q
        self.offset = offset  # row offset into the request (== local row id base)

    @property
    def n(self) -> int:
        return self.q.shape[0]

    def split(self, m: int) -> "tuple[_Item, _Item]":
        """Head of ``m`` rows (fills the current batch) + requeued tail."""
        return (
            _Item(self.request, self.q[:m], self.offset),
            _Item(self.request, self.q[m:], self.offset + m),
        )


class BatcherStats:
    """Monotonic counters the cache tests and ``/metrics`` read."""

    __slots__ = ("n_batches", "n_rows", "n_pad_rows", "n_requests", "n_errors")

    def __init__(self):
        self.n_batches = 0
        self.n_rows = 0
        self.n_pad_rows = 0
        self.n_requests = 0
        self.n_errors = 0

    @property
    def batch_fill(self) -> float:
        """Fraction of device-batch rows that carried real queries."""
        total = self.n_rows + self.n_pad_rows
        return self.n_rows / total if total else float("nan")

    def as_dict(self) -> dict:
        return {
            "n_batches": self.n_batches,
            "n_rows": self.n_rows,
            "n_pad_rows": self.n_pad_rows,
            "n_requests": self.n_requests,
            "n_errors": self.n_errors,
            "batch_fill": self.batch_fill,
        }


class Batcher:
    """Coalesces concurrent requests into ``server.batch_rows`` batches.

    ``max_delay_s`` bounds the queueing a lone request pays for the chance
    of sharing its device batch: the worker flushes a partial batch the
    moment the *oldest* queued row has waited that long (or immediately,
    once a batch is full or the batcher is draining).

    ``autostart=False`` leaves the worker stopped until :meth:`start` —
    tests use this to enqueue a deterministic backlog and observe exactly
    how it coalesces.
    """

    def __init__(
        self,
        server: MapServer,
        *,
        max_delay_s: Optional[float] = None,
        autostart: bool = True,
    ):
        self.server = server
        self.max_delay_s = (
            server.frozen.cfg.service_max_delay_s if max_delay_s is None else max_delay_s
        )
        if self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")
        self._dq: "collections.deque[_Item]" = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._inflight_rows = 0  # queued or inside the worker, not yet fanned out
        self.stats = BatcherStats()
        self._recent_batch_lat: "collections.deque[float]" = collections.deque(
            maxlen=512
        )
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            if self._worker is not None:
                return
            self._worker = threading.Thread(
                target=self._run, name="nomad-batcher", daemon=True
            )
            self._worker.start()

    def close(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting work; with ``drain`` finish everything queued.

        Draining is what makes hot map swap lossless: the registry flips
        the active pointer first, then closes the old version's batcher —
        requests already inside it complete on the map they started on,
        requests arriving after the flip never see it.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if drain:
            deadline = time.monotonic() + timeout
            with self._cv:
                while self._inflight_rows > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"batcher drain timed out with "
                            f"{self._inflight_rows} rows in flight"
                        )
                    self._cv.wait(min(remaining, 0.1))
        if self._worker is not None:
            self._worker.join(timeout=timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- introspection ---------------------------------------------------------

    def queue_depth(self) -> int:
        """Rows currently waiting to be placed (queued or mid-batch)."""
        with self._cv:
            return self._inflight_rows

    def recent_batch_latency(self) -> List[float]:
        with self._cv:
            return list(self._recent_batch_lat)

    # -- the public call -------------------------------------------------------

    def submit(self, q: np.ndarray, *, seed: int = 0, return_neighbors: bool = True):
        """Enqueue one request; returns its :class:`_Request` handle
        (wait on ``.done``, then read the output buffers). ``q`` must
        already be validated, float32, ``(n, dim)`` with n ≥ 1."""
        q = np.ascontiguousarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.server.frozen.dim or q.shape[0] < 1:
            raise ValueError(
                f"submit wants (n>=1, {self.server.frozen.dim}) float32 rows, "
                f"got {q.shape}"
            )
        req = _Request(
            q.shape[0],
            seed,
            self.server.frozen.out_dim,
            self.server.frozen.cfg.n_neighbors,
            return_neighbors,
        )
        B = self.server.batch_rows
        items = [
            _Item(req, q[s : s + B], s) for s in range(0, q.shape[0], B)
        ]
        with self._cv:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            self.stats.n_requests += 1
            self._inflight_rows += req.n
            self._dq.extend(items)
            self._cv.notify_all()
        return req

    def project(
        self,
        q: np.ndarray,
        *,
        seed: int = 0,
        return_neighbors: bool = True,
        timeout: float = 60.0,
    ) -> TransformResult:
        """Blocking submit + wait; returns the request's TransformResult.

        ``batch_loss`` is NaN per batch touched — a coalesced batch's loss
        mixes requests and is not attributable to this one.
        """
        t0 = time.time()
        req = self.submit(q, seed=seed, return_neighbors=return_neighbors)
        if not req.done.wait(timeout):
            raise TimeoutError(
                f"request of {req.n} rows not served within {timeout}s "
                f"(queue depth {self.queue_depth()})"
            )
        if req.error is not None:
            raise req.error
        return TransformResult(
            embedding=req.embedding,
            cells=req.cells,
            neighbor_ids=req.neighbor_ids,
            neighbor_dists=req.neighbor_dists,
            n_queries=req.n,
            strategy=self.server.strategy,
            n_shards=self.server.n_shards,
            microbatch=self.server.microbatch,
            steps=self.server.steps,
            wall_time_s=time.time() - t0,
            batch_latency_s=list(req.latencies),
            batch_loss=[float("nan")] * len(req.latencies),
        )

    # -- the worker ------------------------------------------------------------

    def _collect(self) -> Optional[List[_Item]]:
        """Block until a batch is ready: full, deadline-expired, or closing.

        Returns None exactly once, when the queue is empty and the batcher
        is closed — the worker's exit signal.
        """
        B = self.server.batch_rows
        with self._cv:
            while not self._dq:
                if self._closed:
                    return None
                self._cv.wait(0.05)
            first = self._dq.popleft()
            deadline = first.request.t_submit + self.max_delay_s
            items, rows = [first], first.n
            while rows < B:
                if self._dq:
                    nxt = self._dq[0]
                    space = B - rows
                    if nxt.n <= space:
                        self._dq.popleft()
                        items.append(nxt)
                        rows += nxt.n
                    else:
                        head, tail = nxt.split(space)
                        self._dq[0] = tail
                        items.append(head)
                        rows += space
                    continue
                now = time.monotonic()
                if self._closed or now >= deadline:
                    break
                self._cv.wait(min(deadline - now, 0.05))
            return items

    def _run(self) -> None:
        while True:
            items = self._collect()
            if items is None:
                return
            self._process(items)

    def _process(self, items: List[_Item]) -> None:
        B = self.server.batch_rows
        dim = self.server.frozen.dim
        qb = np.zeros((B, dim), np.float32)
        rows = np.zeros((B,), np.int32)
        seeds = np.zeros((B,), np.uint32)
        valid = np.zeros((B,), bool)
        o = 0
        for it in items:
            m = it.n
            qb[o : o + m] = it.q
            rows[o : o + m] = np.arange(it.offset, it.offset + m, dtype=np.int32)
            seeds[o : o + m] = it.request.seed
            valid[o : o + m] = True
            o += m
        # the full variant serves a mixed batch too (placements are parity-
        # tested against the fast path); skip neighbors only when every
        # request in the batch asked to
        want_nb = any(it.request.return_neighbors for it in items)
        try:
            out = self.server.transform_batch(
                qb, rows, seeds, valid, return_neighbors=want_nb
            )
        except BaseException as e:  # noqa: BLE001 — fail the requests, keep serving
            with self._cv:
                self.stats.n_errors += 1
                self._inflight_rows -= o
                self._cv.notify_all()
            for it in items:
                req = it.request
                req.error = e
                req.done.set()
            return
        o = 0
        for it in items:
            m = it.n
            req = it.request
            req.embedding[it.offset : it.offset + m] = out.embedding[o : o + m]
            req.cells[it.offset : it.offset + m] = out.cells[o : o + m]
            if req.return_neighbors:
                req.neighbor_ids[it.offset : it.offset + m] = out.neighbor_ids[
                    o : o + m
                ]
                req.neighbor_dists[it.offset : it.offset + m] = out.neighbor_dists[
                    o : o + m
                ]
            req.latencies.append(out.latency_s)
            req.remaining_rows -= m
            if req.remaining_rows == 0:
                req.done.set()
            o += m
        with self._cv:
            self.stats.n_batches += 1
            self.stats.n_rows += o
            self.stats.n_pad_rows += B - o
            self._recent_batch_lat.append(out.latency_s)
            self._inflight_rows -= o
            self._cv.notify_all()
