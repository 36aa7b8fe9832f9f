"""Checkpoints in the JAX package's format, so either package reads the
other's.

* a checkpoint is a directory ``step_<n>/`` (n zero-padded to 9 digits)
  holding one ``shard_<i>.npz`` per logical shard plus a ``manifest.json``
  (step, shard count, which leaves are row-sharded, leaf shapes and dtypes,
  and the caller's metadata: epoch, config, method, strategy, losses);
* a write goes to ``step_<n>.tmp/`` and is committed by one atomic
  ``rename``, so a crash mid-write never corrupts the latest checkpoint;
* saves can run on one background thread (``async_save=True``): ``save``
  takes the host copy of every leaf on the calling thread, so the caller
  may update its tensors in place as soon as it returns, and the next
  save (or :meth:`Checkpointer.wait`) joins the write in flight first;
* ``n_shards > 1`` splits each of ``sharded_keys`` into that many row
  blocks, one a shard file; restore concatenates the row blocks of
  row-sharded leaves whatever shard count wrote them, so a multi-shard
  JAX checkpoint loads too and the JAX package reads the port's;
* ``keep`` bounds the checkpoints retained (the oldest pruned after each
  commit).

``primary`` and ``n_shards`` keep the reference's single-process meaning;
the multi-process writer waits for multi-GPU.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
from typing import Any, Optional

import numpy as np


def _flatten(tree, prefix=""):
    """Stable depth-first flatten of nested dict/list trees of arrays."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_into(skeleton, flat: dict, prefix=""):
    if isinstance(skeleton, dict):
        return {
            k: _unflatten_into(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in skeleton.items()
        }
    if isinstance(skeleton, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}/{i}") for i, v in enumerate(skeleton)]
        return type(skeleton)(vals)
    return flat[prefix]


def _steps(directory: str) -> list:
    return [
        int(n.split("_")[1])
        for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
    ]


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def _host_copy(v) -> np.ndarray:
    """A numpy copy of a leaf that no later in-place update of the caller's
    array or tensor reaches (a CPU tensor's ``.numpy()`` shares its
    memory)."""
    if hasattr(v, "detach"):  # a torch.Tensor, on any device
        v = v.detach().cpu().numpy()
    return np.array(v, copy=True)


class Checkpointer:
    def __init__(
        self,
        directory: str,
        *,
        n_shards: int = 1,
        keep: int = 3,
        async_save: bool = False,
        primary: bool = True,
    ):
        """``primary=False`` turns ``save`` into a no-op: only the primary
        process of a multi-process run writes, and every process restores
        from the shared directory."""
        self.dir = directory
        self.n_shards = n_shards
        self.keep = keep
        self.primary = primary
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[cf.Future] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: dict, *, sharded_keys=(), metadata: Optional[dict] = None):
        """``sharded_keys``: names (flat paths) whose leading axis is split
        into ``n_shards`` row blocks, one block a shard file. The leaves
        may be numpy arrays or tensors on any device; their host copies
        are taken before this returns."""
        if not self.primary:
            return
        self.wait()
        arrays = {k: _host_copy(v) for k, v in _flatten(tree)}
        for k in sharded_keys:
            if arrays[k].shape[0] % self.n_shards:
                raise ValueError(f"{k}: {arrays[k].shape[0]} rows do not split into {self.n_shards} shards")
        if self._pool is None:
            self._write(step, arrays, tuple(sharded_keys), metadata or {})
        else:
            self._pending = self._pool.submit(self._write, step, arrays, tuple(sharded_keys), metadata or {})

    def wait(self):
        """Join the write in flight, if any (re-raising its error)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _write(self, step: int, arrays: dict, sharded_keys, metadata: dict):
        tmp = _step_dir(self.dir, step) + ".tmp"
        final = _step_dir(self.dir, step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_shards": self.n_shards,
            "sharded": list(sharded_keys),
            "metadata": metadata,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in arrays.items()},
        }
        for s in range(self.n_shards):
            payload = {}
            for k, v in arrays.items():
                if k in sharded_keys:
                    blk = v.shape[0] // self.n_shards
                    payload[k] = v[s * blk : (s + 1) * blk]
                elif s == 0:  # replicated leaves live in shard 0 only
                    payload[k] = v
            np.savez(os.path.join(tmp, f"shard_{s:05d}.npz"), **payload)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic commit point
        self._prune()

    def _prune(self):
        for old in sorted(_steps(self.dir))[: -self.keep]:
            shutil.rmtree(_step_dir(self.dir, old), ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def restore(self, skeleton: dict, step: Optional[int] = None):
        """Returns (tree, metadata) of one checkpoint (latest by default).
        ``skeleton`` fixes the tree's structure; shapes come from the files."""
        steps = _steps(self.dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = _step_dir(self.dir, max(steps) if step is None else step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        sharded = set(manifest["sharded"])
        flat: dict[str, Any] = {}
        parts: dict[str, list] = {k: [] for k in sharded}
        for s in range(manifest["n_shards"]):
            with np.load(os.path.join(path, f"shard_{s:05d}.npz")) as z:
                for k in z.files:
                    if k in sharded:
                        parts[k].append(z[k])
                    else:
                        flat[k] = z[k]
        for k, chunks in parts.items():
            flat[k] = np.concatenate(chunks, axis=0)
        return _unflatten_into(skeleton, flat), manifest["metadata"]


def load_theta(directory: str, step: Optional[int] = None):
    """The θ row block of one checkpoint (latest by default): ``(theta
    (K·C, out_dim) np.float32, metadata)``, shards concatenated into the
    cluster-major buffer the serve path freezes."""
    tree, meta = Checkpointer(directory).restore({"theta": None}, step)
    return np.asarray(tree["theta"], np.float32), meta


def load_metadata(directory: str, step: Optional[int] = None) -> dict:
    """The metadata of one checkpoint (latest by default), no array I/O."""
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, max(steps) if step is None else step)
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["metadata"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None
