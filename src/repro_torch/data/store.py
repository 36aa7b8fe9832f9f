"""Out-of-core embedding stores: chunked row access over corpora on disk
(the port's copy of the JAX package's ``data/store.py``).

A corpus larger than host RAM (the paper's Multilingual Wikipedia map:
60M × 1024 float32) reaches every consumer of the port
(``prepare_inputs``, the streamed :class:`repro_torch.index.build.IndexBuilder`
path, the streamed PCA init, ``MapServer`` query batches) through ONE
interface, :class:`EmbeddingStore`:

* :class:`ArrayStore`   — an in-memory ``np.ndarray`` (or ``np.memmap``)
  behind the same chunked API;
* :class:`MemmapStore`  — a single ``.npy`` file opened with
  ``mmap_mode="r"``;
* :class:`ShardedStore` — a directory of row-block shards
  (``shard-00000.npy``, …) described by ``meta.json``, read one shard at a
  time with a one-shard cache, so host RSS stays O(shard).

``read()`` always returns **float32** rows whatever the storage dtype
(``float32``, ``float16`` or ``bfloat16``); the cast happens per chunk.
The on-disk format is the JAX package's, so each package reads the other's
stores: bf16 shards hold the raw ``uint16`` bit patterns (``.npy`` has no
bfloat16) and ``meta.json`` records the logical dtype. The port encodes
bf16 with integer arithmetic on the float32 bits (round to nearest even,
NaN to the quiet NaN of its sign), the bytes ``ml_dtypes`` writes, and
decodes by shifting back; it needs no ``ml_dtypes``.

``write_sharded()`` converts an array, a store or a chunk iterator into the
sharded layout; the command line::

    python -m repro_torch.data.store convert corpus.npy corpus_store/ \\
        --rows-per-shard 65536 --dtype bfloat16
    python -m repro_torch.data.store info corpus_store/

``stream_chunks()`` is the double-buffered feed every streamed stage reads
through: a :class:`repro_torch.data.loader.Prefetcher` reads chunk *i+1*
while the caller works on chunk *i*.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np

META_NAME = "meta.json"
STORE_FORMAT = "repro-embedding-store"
SHARD_PATTERN = "shard-{:05d}.npy"

#: storage dtypes a store may hold on disk (reads always upcast to f32)
STORE_DTYPES = ("float32", "float16", "bfloat16")

#: the chunk size streamed consumers default to when cfg.chunk_rows is 0 —
#: the one definition (NomadConfig.resolved_chunk_rows, prepare_inputs and
#: pca_init_streamed all resolve through it), so chunk boundaries depend
#: only on (N, chunk_rows)
DEFAULT_CHUNK_ROWS = 8192


def _check_store_dtype(name: str) -> str:
    if name not in STORE_DTYPES:
        raise ValueError(f"unknown store dtype {name!r} (want one of {STORE_DTYPES})")
    return name


def bf16_bits(chunk: np.ndarray) -> np.ndarray:
    """float rows → bfloat16 bit patterns (uint16): round to nearest even on
    the float32 bits, subnormals kept, NaN to the quiet NaN of its sign."""
    f = np.ascontiguousarray(chunk, np.float32)
    u = f.view(np.uint32)
    r = (u >> 16) & 1
    r += 0x7FFF
    r += u  # wraps only for NaN, which is replaced below
    r >>= 16
    out = r.astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        out[nan] = np.where(u[nan] >> 31, 0xFFC0, 0x7FC0).astype(np.uint16)
    return out


def bf16_decode(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → float32, exactly."""
    w = np.asarray(bits).astype(np.uint32)
    w <<= 16
    return w.view(np.float32)


def _encode(chunk: np.ndarray, dtype: str) -> np.ndarray:
    """float rows → the on-disk representation of ``dtype``."""
    if dtype == "bfloat16":
        return bf16_bits(chunk)
    return chunk.astype(np.dtype(dtype), copy=False)


def _decode(raw: np.ndarray, dtype: str) -> np.ndarray:
    """On-disk representation → float32 rows."""
    if dtype == "bfloat16":
        return bf16_decode(raw)
    return raw.astype(np.float32, copy=False)


def _disk_dtype(dtype: str) -> np.dtype:
    """The numpy dtype shard *files* hold (bf16 → raw uint16 bits)."""
    _check_store_dtype(dtype)
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


def _commit_meta(out_dir: str, n_rows: int, dim: int, dtype: str, files, shard_rows) -> None:
    """Write ``meta.json`` atomically (tmp + rename): the one place the
    store format is stamped, so a crashed write never leaves a directory
    that parses as a store."""
    meta = {
        "format": STORE_FORMAT,
        "version": 1,
        "n_rows": int(n_rows),
        "dim": int(dim),
        "dtype": dtype,
        "shards": list(files),
        "shard_rows": [int(r) for r in shard_rows],
    }
    tmp = os.path.join(out_dir, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, META_NAME))


# ---------------------------------------------------------------------------
# The interface
# ---------------------------------------------------------------------------


class EmbeddingStore:
    """Uniform chunked-read interface over an ``(N, D)`` row source.

    Subclasses set :attr:`shape`, :attr:`dtype_name` (the *storage* dtype),
    :attr:`path` (``None`` for in-memory) and implement :meth:`_read_raw`.
    :meth:`read`, :meth:`read_rows` and :meth:`iter_chunks` return float32.
    """

    shape: Tuple[int, int]
    dtype_name: str
    path: Optional[str] = None

    def _read_raw(self, start: int, stop: int) -> np.ndarray:
        raise NotImplementedError

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dim(self) -> int:
        return self.shape[1]

    def __len__(self) -> int:
        return self.shape[0]

    def read(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as a float32 ``(stop-start, D)`` array."""
        n = self.shape[0]
        if not (0 <= start <= stop <= n):
            raise IndexError(f"row range [{start}, {stop}) outside [0, {n})")
        return _decode(self._read_raw(start, stop), self.dtype_name)

    def read_encoded(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as a bfloat16 store holds them (raw
        ``uint16`` bits: half the bytes, decoded exactly by
        :func:`bf16_decode` or on the device), else as :meth:`read`
        gives them."""
        return self.read(start, stop)

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Gather arbitrary rows (float32): one range read per run of
        consecutive indices, in sorted order."""
        rows = np.asarray(rows, np.int64)
        out = np.empty((rows.size, self.shape[1]), np.float32)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        s = 0
        while s < sorted_rows.size:
            e = s + 1
            while e < sorted_rows.size and sorted_rows[e] == sorted_rows[e - 1] + 1:
                e += 1
            out[order[s:e]] = self.read(int(sorted_rows[s]), int(sorted_rows[e - 1]) + 1)
            s = e
        return out

    def iter_chunks(self, chunk_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start, chunk)`` covering all rows in order; the final
        chunk is ragged when ``chunk_rows`` does not divide N."""
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        n = self.shape[0]
        for s in range(0, n, chunk_rows):
            yield s, self.read(s, min(s + chunk_rows, n))

    def materialize(self) -> np.ndarray:
        """The full float32 array: an explicit O(N·D) host allocation."""
        out = np.empty(self.shape, np.float32)
        for s, chunk in self.iter_chunks(max(1, min(65536, self.shape[0]))):
            out[s : s + chunk.shape[0]] = chunk
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


def is_store(x) -> bool:
    """True iff ``x`` goes through the chunked-read interface."""
    return isinstance(x, EmbeddingStore)


# ---------------------------------------------------------------------------
# Implementations
# ---------------------------------------------------------------------------


class ArrayStore(EmbeddingStore):
    """An in-memory array (or ``np.memmap``) behind the store interface.
    Reads are slices cast to float32 per chunk, so a memmap input never
    materialises a full-size temporary."""

    def __init__(self, x: np.ndarray):
        if x.ndim != 2:
            raise ValueError(f"expected a 2-D (n, dim) array, got {x.shape}")
        self._x = x
        self.shape = (int(x.shape[0]), int(x.shape[1]))
        self.dtype_name = str(x.dtype)
        self.path = getattr(x, "filename", None)

    def _read_raw(self, start, stop):
        return self._x[start:stop]

    def read(self, start, stop):
        return np.asarray(self._x[start:stop], np.float32)

    def read_rows(self, rows):
        return np.asarray(self._x[np.asarray(rows, np.int64)], np.float32)


class MemmapStore(EmbeddingStore):
    """A single ``.npy`` file opened with ``mmap_mode="r"``."""

    def __init__(self, path: str):
        self.path = str(path)
        self._mm = np.load(self.path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError(f"{path}: expected a 2-D (n, dim) .npy, got shape {self._mm.shape}")
        if self._mm.dtype.kind == "V":
            raise ValueError(
                f"{path}: raw void dtype — bfloat16 cannot round-trip through "
                "a bare .npy; convert it to a sharded store "
                "(python -m repro_torch.data.store convert) which records the "
                "logical dtype in meta.json"
            )
        self.shape = (int(self._mm.shape[0]), int(self._mm.shape[1]))
        self.dtype_name = str(self._mm.dtype)

    def _read_raw(self, start, stop):
        return self._mm[start:stop]

    def read(self, start, stop):
        return np.asarray(self._mm[start:stop], np.float32)

    def read_rows(self, rows):
        return np.asarray(self._mm[np.asarray(rows, np.int64)], np.float32)


class ShardedStore(EmbeddingStore):
    """A directory of row-block shards + ``meta.json``.

    Shards are loaded *eagerly* (``np.load``, anonymous memory) one at a
    time into a one-shard cache of the stored bits, decoded per read, so a
    sequential pass keeps host RSS at O(shard).
    """

    def __init__(self, directory: str):
        self.path = str(directory)
        meta_path = os.path.join(self.path, META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{self.path}: no {META_NAME} — not an embedding store "
                "(create one with repro_torch.data.store.write_sharded)"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != STORE_FORMAT:
            raise ValueError(f"{meta_path}: format {meta.get('format')!r} is not {STORE_FORMAT!r}")
        self.dtype_name = _check_store_dtype(meta["dtype"])
        self.shape = (int(meta["n_rows"]), int(meta["dim"]))
        self._files = list(meta["shards"])
        self._rows = np.asarray(meta["shard_rows"], np.int64)
        if len(self._files) != self._rows.size or self._rows.size == 0:
            raise ValueError(f"{meta_path}: empty or inconsistent shard list")
        if (self._rows <= 0).any():
            bad = int(np.argmax(self._rows <= 0))
            raise ValueError(
                f"{meta_path}: shard {self._files[bad]!r} declares "
                f"{int(self._rows[bad])} rows — every shard must hold at "
                "least one row"
            )
        if int(self._rows.sum()) != self.shape[0]:
            raise ValueError(
                f"{meta_path}: shard rows sum to {int(self._rows.sum())} "
                f"but n_rows is {self.shape[0]}"
            )
        self._starts = np.concatenate([[0], np.cumsum(self._rows)])
        self._cache: Tuple[int, Optional[np.ndarray]] = (-1, None)

    def _shard(self, i: int) -> np.ndarray:
        """Shard ``i`` as stored on disk (the one-shard cache)."""
        ci, raw = self._cache
        if ci == i and raw is not None:
            return raw
        raw = np.load(os.path.join(self.path, self._files[i]))
        want = (int(self._rows[i]), self.shape[1])
        if raw.shape != want:
            raise ValueError(f"{self._files[i]}: shape {raw.shape} does not match meta.json ({want})")
        self._cache = (i, raw)
        return raw

    def _read_raw(self, start, stop):
        n = self.shape[0]
        if not (0 <= start <= stop <= n):
            raise IndexError(f"row range [{start}, {stop}) outside [0, {n})")
        if start == stop:
            return np.empty((0, self.shape[1]), _disk_dtype(self.dtype_name))
        i0 = int(np.searchsorted(self._starts, start, side="right")) - 1
        i1 = int(np.searchsorted(self._starts, stop, side="left")) - 1
        parts = []
        for i in range(i0, i1 + 1):
            lo = max(start, int(self._starts[i])) - int(self._starts[i])
            hi = min(stop, int(self._starts[i + 1])) - int(self._starts[i])
            parts.append(self._shard(i)[lo:hi])
        if len(parts) == 1:
            return np.ascontiguousarray(parts[0])
        return np.concatenate(parts, axis=0)

    def read_encoded(self, start, stop):
        if self.dtype_name == "bfloat16":
            return self._read_raw(start, stop)
        return self.read(start, stop)

    def read_rows(self, rows):
        """One sorted gather: each shard the rows touch is loaded once."""
        rows = np.asarray(rows, np.int64)
        n = self.shape[0]
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(f"rows outside [0, {n})")
        out = np.empty((rows.size, self.shape[1]), np.float32)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        shard = np.searchsorted(self._starts, sorted_rows, side="right") - 1
        bounds = np.searchsorted(shard, np.arange(self._rows.size + 1))
        for i in range(self._rows.size):
            lo, hi = bounds[i], bounds[i + 1]
            if lo < hi:
                raw = self._shard(i)[sorted_rows[lo:hi] - self._starts[i]]
                out[order[lo:hi]] = _decode(raw, self.dtype_name)
        return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _chunk_source(source, chunk_rows: int) -> Iterator[np.ndarray]:
    if isinstance(source, EmbeddingStore):
        for _s, chunk in source.iter_chunks(chunk_rows):
            yield chunk
    elif isinstance(source, np.ndarray):
        for s in range(0, source.shape[0], chunk_rows):
            yield source[s : s + chunk_rows]
    else:  # an iterable of 2-D row chunks (streamed generation)
        for chunk in source:
            yield np.asarray(chunk)


def sharded_grid(n_rows: int, rows_per_shard: int) -> Tuple[list, list]:
    """The canonical ``(files, shard_rows)`` layout of an ``n_rows`` store
    re-blocked at ``rows_per_shard``: full shards plus one ragged tail."""
    files, shard_rows = [], []
    for i, s in enumerate(range(0, n_rows, rows_per_shard)):
        files.append(SHARD_PATTERN.format(i))
        shard_rows.append(min(rows_per_shard, n_rows - s))
    return files, shard_rows


def commit_sharded_meta(out_dir: str, n_rows: int, dim: int, *, rows_per_shard: int,
                        dtype: str = "float32") -> ShardedStore:
    """Commit ``meta.json`` for a store whose shards were written by
    :func:`write_sharded` calls with ``commit=False`` (one per writer).
    Call once, after every writer has finished."""
    _check_store_dtype(dtype)
    files, shard_rows = sharded_grid(n_rows, rows_per_shard)
    missing = [f for f in files if not os.path.exists(os.path.join(out_dir, f))]
    if missing:
        raise FileNotFoundError(
            f"commit_sharded_meta({out_dir}): {len(missing)} shard file(s) "
            f"missing (first: {missing[0]}) — did every writer process "
            "finish before the commit?"
        )
    _commit_meta(out_dir, n_rows, dim, dtype, files, shard_rows)
    return ShardedStore(out_dir)


def write_sharded(
    source: Union[np.ndarray, EmbeddingStore, Iterable[np.ndarray]],
    out_dir: str,
    *,
    rows_per_shard: int = 65536,
    dtype: str = "float32",
    row_offset: int = 0,
    total_rows: Optional[int] = None,
    commit: bool = True,
) -> Optional[ShardedStore]:
    """Stream ``source`` (an array, another store, or an iterable of 2-D row
    chunks) into a sharded store at ``out_dir``: rows re-blocked to exactly
    ``rows_per_shard`` a shard (ragged final shard), encoded to ``dtype``,
    ``meta.json`` committed last.

    Several writers: with ``total_rows`` set, ``source`` covers rows
    ``[row_offset, row_offset + len(source))`` of a ``total_rows`` store
    whose other ranges other writers fill; ``row_offset`` must land on a
    shard boundary. Each writer passes ``commit=False`` (returns ``None``),
    then one calls :func:`commit_sharded_meta`.
    """
    _check_store_dtype(dtype)
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    if total_rows is None and row_offset:
        raise ValueError("row_offset needs total_rows (a multi-writer store)")
    if row_offset % rows_per_shard:
        raise ValueError(
            f"row_offset {row_offset} is not a multiple of rows_per_shard "
            f"{rows_per_shard} — a shard file would need two writers"
        )
    os.makedirs(out_dir, exist_ok=True)

    shard_base = row_offset // rows_per_shard
    files, shard_rows = [], []
    dim = None
    pending: list = []
    pending_rows = 0

    def flush(buf_rows: int):
        nonlocal pending, pending_rows
        block = pending[0] if len(pending) == 1 else np.concatenate(pending)
        take, rest = block[:buf_rows], block[buf_rows:]
        name = SHARD_PATTERN.format(shard_base + len(files))
        np.save(os.path.join(out_dir, name), _encode(take, dtype))
        files.append(name)
        shard_rows.append(int(take.shape[0]))
        pending = [rest] if rest.shape[0] else []
        pending_rows = int(rest.shape[0])

    written = 0
    for chunk in _chunk_source(source, rows_per_shard):
        if chunk.ndim != 2:
            raise ValueError(f"source chunk has shape {chunk.shape}, want 2-D")
        if dim is None:
            dim = int(chunk.shape[1])
        elif int(chunk.shape[1]) != dim:
            raise ValueError(f"source chunk dim {chunk.shape[1]} != first chunk dim {dim}")
        if chunk.dtype == np.float64:
            chunk = chunk.astype(np.float32)  # per chunk, never the full array
        pending.append(chunk)
        pending_rows += int(chunk.shape[0])
        written += int(chunk.shape[0])
        while pending_rows >= rows_per_shard:
            flush(rows_per_shard)
    if pending_rows:
        flush(pending_rows)
    if not files:
        raise ValueError("write_sharded: source produced no rows")

    if total_rows is not None:
        end = row_offset + written
        if end > total_rows:
            raise ValueError(f"write_sharded: rows [{row_offset}, {end}) overflow total_rows={total_rows}")
        if end != total_rows and written % rows_per_shard:
            raise ValueError(
                f"write_sharded: range [{row_offset}, {end}) ends mid-shard "
                f"({written} rows, rows_per_shard={rows_per_shard}) but is "
                "not the final range — the next writer's shard would have "
                "two owners"
            )
    if not commit:
        return None
    n_rows = total_rows if total_rows is not None else sum(shard_rows)
    if total_rows is not None and (row_offset or written != total_rows):
        raise ValueError(
            "write_sharded(commit=True) with a partial row range — peers "
            "own the other shards; use commit=False + commit_sharded_meta"
        )
    _commit_meta(out_dir, n_rows, dim, dtype, files, shard_rows)
    return ShardedStore(out_dir)


def copy_to_npy(store: EmbeddingStore, path: str, chunk_rows: int = 65536) -> str:
    """Chunked store → one float32 ``.npy`` (memmap-written, O(chunk) host
    RSS): the sidecar a store-backed index field is saved as."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=store.shape)
    for s, chunk in store.iter_chunks(chunk_rows):
        mm[s : s + chunk.shape[0]] = chunk
    mm.flush()
    del mm
    return path


# ---------------------------------------------------------------------------
# Resolution + streaming
# ---------------------------------------------------------------------------


def as_store(x) -> EmbeddingStore:
    """Anything row-shaped → an :class:`EmbeddingStore`: a store (as is), an
    ``np.ndarray``/``np.memmap`` (wrapped), a ``.npy`` path (memmap), or a
    sharded-store directory."""
    if is_store(x):
        return x
    if isinstance(x, np.ndarray):
        return ArrayStore(x)
    if isinstance(x, (str, os.PathLike)):
        p = os.fspath(x)
        if os.path.isdir(p):
            return ShardedStore(p)
        if p.endswith(".npy"):
            return MemmapStore(p)
        raise ValueError(f"{p}: not a sharded-store directory or a .npy file")
    raise TypeError(
        f"cannot adapt {type(x).__name__} into an EmbeddingStore "
        "(want ndarray, store, .npy path, or store directory)"
    )


def stream_chunks(store: EmbeddingStore, chunk_rows: int, *, depth: int = 2, encoded: bool = False
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """One double-buffered pass over ``store``: a background
    :class:`repro_torch.data.loader.Prefetcher` reads chunk *i+1* while
    the consumer works on chunk *i*.

    Yields the same ``(start, float32 chunk)`` schedule as
    ``store.iter_chunks(chunk_rows)``: chunk boundaries depend only on
    ``(N, chunk_rows)``, never on the store's shard layout, which is what
    makes streamed results identical across containers. ``encoded=True``
    yields :meth:`EmbeddingStore.read_encoded`'s rows instead, for a
    consumer that decodes bfloat16 bits itself (on the device).
    """
    from repro_torch.data.loader import Prefetcher

    n = store.shape[0]
    n_chunks = max(1, -(-n // chunk_rows))
    read = store.read_encoded if encoded else store.read

    def make(step: int):
        s = step * chunk_rows
        return s, read(s, min(s + chunk_rows, n))

    # max_steps bounds the worker to one pass; a read error in the worker
    # re-raises here instead of hanging the consumer
    pf = Prefetcher(make, depth=depth, max_steps=n_chunks)
    try:
        for _ in range(n_chunks):
            _step, (s, chunk) = next(pf)
            yield s, chunk
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.data.store {convert,info}
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.data.store",
        description="Convert/inspect on-disk embedding stores.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    cv = sub.add_parser("convert", help="re-block a .npy / store into a sharded store")
    cv.add_argument("src", help=".npy file or existing store directory")
    cv.add_argument("out_dir", help="output sharded-store directory")
    cv.add_argument("--rows-per-shard", type=int, default=65536)
    cv.add_argument("--dtype", default="float32", choices=list(STORE_DTYPES))
    info = sub.add_parser("info", help="describe a store")
    info.add_argument("src", help=".npy file or store directory")

    args = ap.parse_args(argv)
    if args.cmd == "convert":
        st = write_sharded(as_store(args.src), args.out_dir,
                           rows_per_shard=args.rows_per_shard, dtype=args.dtype)
        print(f"wrote {st.path}: {st.n_rows} rows x {st.dim} dims, "
              f"dtype {st.dtype_name}, {len(st._files)} shard(s)")
        return 0
    st = as_store(args.src)
    print(f"{type(st).__name__}: {st.n_rows} rows x {st.dim} dims, dtype {st.dtype_name}")
    if isinstance(st, ShardedStore):
        from repro_torch.configs.base import NomadConfig

        print(f"shards: {len(st._files)} (rows per shard: {st._rows.tolist()})")
        print(f"spill fd cap: {NomadConfig().store_max_shards} shards "
              "(NomadConfig.store_max_shards; index-build spills re-block above it)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
