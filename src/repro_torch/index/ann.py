"""ANN index: the §3.2 pipeline's data structure, in the cluster-major layout

  row r = cluster * capacity + slot,  slot < counts[cluster] ⇒ real point

Fields (host numpy arrays, the JAX package's ``AnnIndex`` field for field)
------------------------------------------------------------------------
x_rows     (K·C, D)   permuted input vectors (padding rows = 0); after a
                      streamed build from disk, a ShardedStore spill
knn_idx    (K·C, k)   row indices of kNN tails (self-loop ⇒ masked edge)
knn_w      (K·C, k)   p(j|i) weights (0 ⇒ edge absent)
counts     (K,)       real points per cluster
centroids  (K, D)
perm       (N,)       original index → row (for un-permuting outputs)
fingerprint           content hash of the data the index was built from

``save_index``/``load_index`` read and write the JAX package's
``index.npz`` layout, and :func:`index_from_arrays` takes its fields as a
dict of arrays, so an index built by either package steps in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np


@dataclasses.dataclass
class AnnIndex:
    x_rows: np.ndarray
    knn_idx: np.ndarray
    knn_w: np.ndarray
    counts: np.ndarray
    centroids: np.ndarray
    perm: np.ndarray
    capacity: int
    n_points: int
    fingerprint: str = ""

    @property
    def n_clusters(self) -> int:
        return self.counts.shape[0]

    @property
    def valid_mask(self) -> np.ndarray:
        K, C = self.n_clusters, self.capacity
        return (np.arange(C)[None, :] < self.counts[:, None]).reshape(K * C)

    def unpermute(self, rows: np.ndarray) -> np.ndarray:
        """Map row-major data (K·C, …) back to original point order (N, …)."""
        return rows[self.perm]


_FIELDS = ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm")


def index_from_arrays(arrays: dict) -> AnnIndex:
    """An :class:`AnnIndex` from a dict of its fields — for instance
    ``dataclasses.asdict`` of the JAX package's index, or an npz."""
    return AnnIndex(
        **{f: np.asarray(arrays[f]) for f in _FIELDS},
        capacity=int(arrays["capacity"]),
        n_points=int(arrays["n_points"]),
        fingerprint=str(arrays.get("fingerprint", "")),
    )


def data_fingerprint(x, n_sample: int = 64, block_rows: int = 65536) -> str:
    """Content hash of ``x`` (an array or a
    :class:`repro_torch.data.store.EmbeddingStore`): shape + a deterministic
    row sample + a float64 column-sum checksum accumulated over fixed
    ``block_rows`` blocks, whatever the container, so the same rows hash
    the same in RAM, as a memmap or sharded on disk — and as the JAX
    package hashes them."""
    from repro_torch.data.store import as_store, is_store

    st = x if is_store(x) else as_store(np.asarray(x))
    n, d = st.shape
    idx = np.unique(np.linspace(0, max(n - 1, 0), min(n_sample, n)).astype(np.int64))
    h = hashlib.sha256()
    h.update(repr((n, d)).encode())
    h.update(np.ascontiguousarray(st.read_rows(idx), dtype=np.float32).tobytes())
    colsum = np.zeros((d,), np.float64)
    for s in range(0, n, block_rows):
        colsum += st.read(s, min(s + block_rows, n)).sum(axis=0, dtype=np.float64)
    h.update(np.ascontiguousarray(colsum).tobytes())
    return h.hexdigest()[:16]


def index_cache_path(checkpoint_dir: str) -> str:
    """Where a fit caches its index beside the checkpoints (one convention,
    the JAX package's)."""
    return os.path.join(checkpoint_dir, "index.npz")


def save_index(index: AnnIndex, path: str) -> None:
    """Persist an index as one ``.npz`` in the JAX package's layout. A
    store-backed ``x_rows`` (the streamed build's spill) is copied chunk by
    chunk into a float32 ``.npy`` sidecar beside the npz, which records its
    name: the cache directory stays self-contained."""
    from repro_torch.data.store import copy_to_npy, is_store

    fields = dict(
        knn_idx=index.knn_idx,
        knn_w=index.knn_w,
        counts=index.counts,
        centroids=index.centroids,
        perm=index.perm,
        capacity=index.capacity,
        n_points=index.n_points,
        fingerprint=np.asarray(index.fingerprint),
    )
    if is_store(index.x_rows):
        sidecar = os.path.basename(path) + ".x_rows.npy"
        copy_to_npy(index.x_rows, os.path.join(os.path.dirname(path) or ".", sidecar))
        fields["x_rows_file"] = np.asarray(sidecar)
    else:
        fields["x_rows"] = np.asarray(index.x_rows)
    np.savez(path, **fields)


def load_index(path: str) -> AnnIndex:
    """Read an ``index.npz``; an out-of-core cache's ``x_rows`` sidecar
    (``x_rows_file``) is memory-mapped, read-only."""
    z = np.load(path)
    fields = {f: z[f] for f in z.files if f not in ("x_rows", "x_rows_file")}
    if "x_rows_file" in z.files:
        sidecar = os.path.join(os.path.dirname(path) or ".", str(z["x_rows_file"]))
        fields["x_rows"] = np.load(sidecar, mmap_mode="r")
    else:
        fields["x_rows"] = z["x_rows"]
    return index_from_arrays(fields)
