"""Checkpoints in the JAX package's format, so either package reads the
other's.

* a checkpoint is a directory ``step_<n>/`` (n zero-padded to 9 digits)
  holding one ``shard_<i>.npz`` per logical shard plus a ``manifest.json``
  (step, shard count, which leaves are row-sharded, leaf shapes and dtypes,
  and the caller's metadata: epoch, config, method, strategy, losses);
* a write goes to ``step_<n>.tmp/`` and is committed by one atomic
  ``rename``, so a crash mid-write never corrupts the latest checkpoint;
* the port writes one shard (it fits on one device); restore
  concatenates the row blocks of row-sharded leaves, whatever shard count
  wrote them, so a multi-shard JAX checkpoint loads too;
* ``keep`` bounds the checkpoints retained (the oldest pruned after each
  commit).

The port's fit writes synchronously from one process: θ is
(K·C, out_dim) floats, a few MB at the paper's scale.
"""

from __future__ import annotations

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


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: dict, *, sharded_keys=(), metadata: Optional[dict] = None):
        """``sharded_keys``: names (flat paths) whose leading axis a reader
        splits over devices; the manifest records them."""
        arrays = {k: np.asarray(v) for k, v in _flatten(tree)}
        tmp = _step_dir(self.dir, step) + ".tmp"
        final = _step_dir(self.dir, step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_shards": 1,
            "sharded": list(sharded_keys),
            "metadata": metadata or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in arrays.items()},
        }
        np.savez(os.path.join(tmp, "shard_00000.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic commit point
        for old in sorted(_steps(self.dir))[: -self.keep]:
            shutil.rmtree(_step_dir(self.dir, old), ignore_errors=True)

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
