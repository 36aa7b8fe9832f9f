"""MapServer: batched query serving over a frozen map.

The server owns microbatching, padding, latency accounting and result
assembly; :func:`repro_torch.serve.transform.place_batch` places each
batch. ``strategy`` "local" serves on the map's device; "sharded" splits
each batch of ``microbatch × n_shards`` query rows over a flat mesh of
shard slots (``launch/mesh.py``), the frozen map replicated on every
slot's device, and gathers the slots' placements back in row order;
"auto" is local with one slot in the pool. Queries may be an array or a
disk-backed store (a memmap, a ``.npy`` path or a store directory),
validated per chunk and read one batch at a time.

Two entry points:

* :meth:`MapServer.transform` — one query array in, one
  :class:`TransformResult` out, cut into fixed ``batch_rows`` batches;
* :meth:`MapServer.transform_batch` — exactly ``batch_rows`` pre-padded
  rows with per-row seeds and row ids, so one batch may coalesce rows of
  several requests and still return, row for row, the bits a dedicated
  ``transform`` call per request would.

Placements do not depend on the microbatch, nor on which requests a batch
coalesces: random numbers are per row and every kernel sums per row in a
fixed order (``serve/transform.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import device_count, devices, flat_mesh
from repro_torch.serve.frozen import FrozenMap
from repro_torch.serve.transform import place_batch


@dataclasses.dataclass
class TransformResult:
    """What one ``MapServer.transform`` call returns.

    ``neighbor_ids``/``neighbor_dists`` are ``None`` when the call asked
    for the placement-only path (``return_neighbors=False``).
    """

    embedding: np.ndarray  # (Nq, out_dim) placements, query order
    cells: np.ndarray  # (Nq,) assigned frozen cluster per query
    neighbor_ids: Optional[np.ndarray]  # (Nq, k) original-order ids (-1 = none)
    neighbor_dists: Optional[np.ndarray]  # (Nq, k) ascending distances (inf = none)
    n_queries: int = 0
    strategy: str = "local"
    n_shards: int = 1
    microbatch: int = 0
    steps: int = 0
    wall_time_s: float = 0.0
    batch_latency_s: List[float] = dataclasses.field(default_factory=list)
    batch_loss: List[float] = dataclasses.field(default_factory=list)

    @staticmethod
    def percentile(values: Sequence[float], pct: float) -> float:
        """Percentile of ``values`` (NaN when empty)."""
        arr = np.asarray(list(values), np.float64)
        if arr.size == 0:
            return float("nan")
        return float(np.percentile(arr, pct))

    @property
    def p50_latency_s(self) -> float:
        return self.percentile(self.batch_latency_s, 50.0)

    @property
    def p99_latency_s(self) -> float:
        return self.percentile(self.batch_latency_s, 99.0)


@dataclasses.dataclass
class BatchOutput:
    """One ``transform_batch`` batch, on the host, at the full padded
    ``batch_rows`` length (the caller owns the valid mask)."""

    embedding: np.ndarray  # (B, out_dim)
    cells: np.ndarray  # (B,)
    neighbor_ids: Optional[np.ndarray]  # (B, k) | None
    neighbor_dists: Optional[np.ndarray]  # (B, k) | None
    loss: float  # last step's mean loss over valid rows (nan if steps == 0)
    latency_s: float  # from the batch's upload to its results on the host


SERVE_AXIS = "serve"


def resolve_serve_strategy(spec: Optional[str], mesh=None, device=None):
    """``"auto" | "local" | "sharded"`` → ("local", None) or ("sharded", a
    flat mesh of slots): ``mesh`` when it has one axis, else one flat axis
    over its slots or over the global pool on ``device``. "auto" is local
    when that pool holds one slot."""
    spec = spec or "auto"
    if spec not in ("auto", "local", "sharded"):
        raise ValueError(f"unknown serve_strategy {spec!r} (want 'auto'|'local'|'sharded')")
    if spec == "local" or (spec == "auto" and mesh is None and device_count() == 1):
        return "local", None
    devs = mesh.slots if mesh is not None else devices(device)
    if spec == "auto" and len(devs) == 1:
        return "local", None
    if mesh is not None and len(mesh.axis_names) == 1:
        return "sharded", mesh
    return "sharded", flat_mesh(SERVE_AXIS, devs)


class MapServer:
    """Turns a :class:`FrozenMap` into a batched query engine on the map's
    device, or on a mesh of shard slots. Queries are cut into fixed
    ``microbatch × n_shards``-row batches (the last one zero-padded); each
    batch's wall time lands in ``TransformResult.batch_latency_s``."""

    def __init__(self, frozen: FrozenMap, *, strategy: Optional[str] = None,
                 microbatch: Optional[int] = None, mesh=None, steps: Optional[int] = None,
                 lr: Optional[float] = None):
        cfg = frozen.cfg
        self.frozen = frozen
        self.strategy, self.mesh = resolve_serve_strategy(
            strategy if strategy is not None else cfg.serve_strategy, mesh, frozen.device
        )
        self.n_shards = 1 if self.mesh is None else self.mesh.size
        self.microbatch = microbatch or cfg.serve_microbatch
        self.steps = cfg.transform_steps if steps is None else steps
        self._lr = lr
        self._replicas = {frozen.device: frozen}

    @property
    def batch_rows(self) -> int:
        """Query rows per placed batch (all slots together)."""
        return self.microbatch * self.n_shards

    def _frozen_on(self, device) -> FrozenMap:
        """The frozen map on ``device`` (copied there once)."""
        if device not in self._replicas:
            self._replicas[device] = self.frozen.to(device)
        return self._replicas[device]

    def _place(self, qb, rows, seeds, valid, return_neighbors: bool):
        """(θ, own, ids, dists, step losses) of one batch: on the map's
        device, or slice i of ``microbatch`` rows on slot i, gathered in
        slot order. A slot's step losses are its loss sums over the batch's
        valid rows, so they add up to the whole batch's mean."""
        def run(fz, sl):
            dev = fz.device
            return place_batch(
                fz,
                torch.from_numpy(np.require(qb[sl], np.float32, ["C", "W"])).to(dev),
                torch.as_tensor(np.asarray(rows[sl], np.int64) & 0xFFFFFFFF, device=dev),
                torch.as_tensor(np.asarray(seeds[sl], np.int64) & 0xFFFFFFFF, device=dev),
                torch.as_tensor(np.asarray(valid[sl], bool), device=dev),
                steps=self.steps,
                lr=self._lr,
                with_neighbors=return_neighbors,
                n_valid=max(int(np.count_nonzero(valid)), 1),
            )

        if self.mesh is None:
            return run(self.frozen, slice(None))
        mb, slots = self.microbatch, self.mesh.slots
        outs = [run(self._frozen_on(slots[i].device), slice(i * mb, (i + 1) * mb))
                for i in self.mesh.local_indices()]
        fields = []
        for j in range(5):
            if outs[0][j] is None:
                fields.append(None)
                continue
            got = self.mesh.all_gather([o[j] for o in outs])
            home = got[0].device
            if j == 4:
                fields.append(torch.stack([g.to(home) for g in got]).sum(0) if got[0].numel() else got[0])
            else:
                fields.append(torch.cat([g.to(home) for g in got]))
        return tuple(fields)

    def transform_batch(self, qb: np.ndarray, rows: np.ndarray, seeds: np.ndarray,
                        valid: np.ndarray, *, return_neighbors: bool = True) -> BatchOutput:
        """Place exactly one pre-assembled batch: ``qb`` (batch_rows, dim)
        float32, already padded; ``rows``/``seeds``/``valid`` per row (row
        ids and seeds in [0, 2^32), valid bool). Row i draws its random
        numbers from (seeds[i], rows[i]) alone."""
        B = self.batch_rows
        if qb.shape != (B, self.frozen.dim):
            raise ValueError(
                f"transform_batch wants exactly ({B}, {self.frozen.dim}) rows "
                f"(pad the tail), got {qb.shape}"
            )
        tb = time.time()
        th, own, ids, dist, sl = self._place(qb, rows, seeds, valid, return_neighbors)
        host = [None if a is None else a.cpu().numpy() for a in (th, own, ids, dist, sl)]
        latency = time.time() - tb
        return BatchOutput(
            embedding=host[0], cells=host[1], neighbor_ids=host[2], neighbor_dists=host[3],
            loss=float(host[4][-1]) if host[4].size else float("nan"),
            latency_s=latency,
        )

    def transform(self, q, *, seed: int = 0, return_neighbors: bool = True) -> TransformResult:
        """Place unseen rows on the frozen map. Deterministic per ``seed``
        and independent of the microbatch. ``q`` is an array or a
        disk-backed :class:`repro_torch.data.store.EmbeddingStore` (or a
        memmap, ``.npy`` path or store directory): store queries are
        validated per chunk and read one batch at a time, so a query log
        larger than RAM never materialises. ``return_neighbors=False``
        skips the neighbour ids and distances; placements and cells are the
        same."""
        from repro_torch.core.nomad import prepare_inputs
        from repro_torch.data.store import is_store

        q = prepare_inputs(q, dim=self.frozen.dim, caller="transform",
                           chunk_rows=self.frozen.cfg.chunk_rows)
        t0 = time.time()
        nq = q.shape[0]
        B = self.batch_rows
        embs, cells, nids, ndist, lat, bloss = [], [], [], [], [], []
        for s in range(0, max(nq, 1), B):
            qb = q.read(s, min(s + B, nq)) if is_store(q) else q[s : s + B]
            pad = B - qb.shape[0]
            if pad:
                qb = np.concatenate([qb, np.zeros((pad, q.shape[1]), qb.dtype)])
            rows = np.arange(s, s + B, dtype=np.int64)
            out = self.transform_batch(
                qb, rows, np.full((B,), seed & 0xFFFFFFFF, np.int64), rows < nq,
                return_neighbors=return_neighbors,
            )
            take = B - pad
            lat.append(out.latency_s)
            bloss.append(out.loss)
            embs.append(out.embedding[:take])
            cells.append(out.cells[:take])
            if return_neighbors:
                nids.append(out.neighbor_ids[:take])
                ndist.append(out.neighbor_dists[:take])
        return TransformResult(
            embedding=np.concatenate(embs).astype(np.float32),
            cells=np.concatenate(cells).astype(np.int64),
            neighbor_ids=np.concatenate(nids).astype(np.int64) if return_neighbors else None,
            neighbor_dists=np.concatenate(ndist).astype(np.float32) if return_neighbors else None,
            n_queries=nq,
            strategy=self.strategy,
            n_shards=self.n_shards,
            microbatch=self.microbatch,
            steps=self.steps,
            wall_time_s=time.time() - t0,
            batch_latency_s=lat,
            batch_loss=bloss,
        )
