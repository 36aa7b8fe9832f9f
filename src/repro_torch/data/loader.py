"""Deterministic host data loading: the synthetic LM token stream and
background prefetch (the port of the JAX package's ``data/loader.py``).

:class:`TokenStream` is the zoo's training corpus, seeded per (stream
name, step, shard) so every host of a multi-host job materialises exactly
its own rows of the global batch without coordination, and a resumed run
sees the same batches (the step counter is in the checkpoint).
:func:`repro_torch.data.store.stream_chunks` reads chunk *i+1* of a store
on a :class:`Prefetcher` worker thread while the caller works on chunk *i*.
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Iterator

import numpy as np


def stream_seed(name: str, step: int, shard: int) -> int:
    """The seed of one (stream, step, shard) batch, in [0, 2**31).

    The reference seeds with ``abs(hash((name, step, shard))) % 2**31``.
    Python salts a ``str``'s hash per process, so its batches differ from
    one process to the next unless ``PYTHONHASHSEED`` is set. The port
    takes the name's CRC-32, a digest that is the same in every process,
    and mixes it with the two integers through numpy's ``SeedSequence``."""
    crc = zlib.crc32(name.encode("utf-8"))
    return int(np.random.SeedSequence([crc, int(step), int(shard)]).generate_state(1, np.uint32)[0]) % (2**31)


class TokenStream:
    """Synthetic next-token corpus: Zipf-distributed ids with a Markov twist,
    so the loss has learnable structure (the tests assert it decreases).

    After the seed (:func:`stream_seed`) every draw is the reference's:
    ``zipf(1.3)`` modulo the vocabulary for ``seq + 1`` positions, then
    every odd position repeats its predecessor with p = 0.5. Tokens and
    labels are int32 numpy arrays, the labels the tokens shifted by one."""

    def __init__(self, vocab_size: int, seq_len: int, name: str = "train"):
        self.vocab = vocab_size
        self.seq = seq_len
        self.name = name

    def batch(self, step: int, batch_size: int, shard: int = 0, n_shards: int = 1) -> dict:
        rows = batch_size // n_shards
        rng = np.random.default_rng(stream_seed(self.name, step, shard))
        # zipf-ish marginal, clipped to vocab
        z = rng.zipf(1.3, size=(rows, self.seq + 1)) % self.vocab
        # every odd position repeats the previous token with p = 0.5
        # (learnable bigram structure)
        rep = rng.random((rows, self.seq)) < 0.5
        z = z.astype(np.int64)
        for t in range(1, self.seq + 1, 2):
            z[:, t] = np.where(rep[:, t - 1], z[:, t - 1], z[:, t])
        return {
            "tokens": z[:, :-1].astype(np.int32),
            "labels": z[:, 1:].astype(np.int32),
        }


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
