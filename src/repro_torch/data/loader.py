"""Background prefetch for streamed reads (the port's copy of the JAX
package's ``data/loader.py:Prefetcher``).

:func:`repro_torch.data.store.stream_chunks` reads chunk *i+1* of a store
on this worker thread while the caller works on chunk *i*. The JAX
package's ``TokenStream`` belongs to the embed pipeline and is not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class Prefetcher:
    """Runs ``make(step)`` on a worker thread, ``depth`` items ahead.

    ``max_steps`` bounds the worker to that many items (for one finite pass
    over a chunked store); ``None`` free-runs forever. Each item is built
    **once** and only the queue put retries on back-pressure, so a slow
    consumer never triggers a re-read. A ``make`` exception is enqueued and
    re-raised in the consumer, so a failed disk read surfaces instead of
    hanging the pipeline on a dead worker.
    """

    def __init__(self, make, start_step: int = 0, depth: int = 2, max_steps=None):
        self._make = make
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._max_steps = max_steps
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Retry-put until accepted or close(); True iff enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        step = self._step
        made = 0
        while not self._stop.is_set():
            if self._max_steps is not None and made >= self._max_steps:
                return
            try:
                item = (step, self._make(step))
            except BaseException as e:  # surfaces in the consumer
                self._put((step, e))
                return
            if not self._put(item):
                return
            step += 1
            made += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return step, item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
