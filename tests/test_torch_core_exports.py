"""``repro_torch.core`` exports every name of the JAX package's
``repro.core``, loads them lazily (JAX stays out of ``sys.modules``), and
its step and epoch factories equal the direct calls of ``step_update`` and
the epoch loop bit for bit on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def _reference_names() -> list:
    import repro.core

    return list(repro.core.__all__)


def test_every_reference_name_imports_without_jax():
    names = _reference_names()
    code = (
        "import sys\n"
        f"from repro_torch.core import {', '.join(names)}\n"
        "import repro_torch.core as c\n"
        f"missing = [n for n in {names!r} if n not in c.__all__]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(missing, bad, callable(c.cauchy))\n"
        "sys.exit(1 if missing or bad or not callable(c.cauchy) else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", ["NomadProjection", "make_step_fn", "ShardedStrategy", "pca_init", "nomad_loss",
                                  "CheckpointEvent", "cauchy"])
def test_names_are_the_submodules_objects(name):
    import importlib

    import repro_torch.core as core

    where = {"NomadProjection": "nomad", "make_step_fn": "nomad", "ShardedStrategy": "strategy", "pca_init": "pca",
             "nomad_loss": "losses", "CheckpointEvent": "strategy", "cauchy": "cauchy"}[name]
    assert getattr(core, name) is getattr(importlib.import_module(f"repro_torch.core.{where}"), name)
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


def _state(seed: int = 0, K: int = 8, C: int = 40, d: int = 2, k: int = 5):
    """A tiny cluster-major index and θ, made with numpy."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(C // 2, C + 1, K).astype(np.int32)
    rows = K * C
    knn = np.zeros((rows, k), np.int64)
    for c in range(K):
        for s in range(counts[c]):
            knn[c * C + s] = c * C + rng.integers(0, counts[c], k)
    idx = {
        "knn_idx": torch.from_numpy(knn),
        "knn_w": torch.from_numpy(rng.random((rows, k)).astype(np.float32)),
        "counts": torch.from_numpy(counts.astype(np.int64)),
        "cum_counts": torch.from_numpy(np.cumsum(counts).astype(np.int64)),
        "total": int(counts.sum()),
    }
    theta = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    return theta, idx


def _cfg(K=8, C=40, refresh=0):
    from repro_torch.configs.base import NomadConfig

    cfg = NomadConfig(n_points=K * C, dim=4, n_clusters=K, capacity_slack=1.0, n_neighbors=5, n_noise=16,
                      n_exact_negatives=4, batch_size=32, mean_refresh_steps=refresh)
    assert cfg.cluster_capacity == C
    return cfg


@pytest.mark.parametrize("method", ["nomad", "infonc"])
def test_step_factory_equals_step_update(method):
    from repro_torch.core import make_step_fn
    from repro_torch.core.nomad import local_means, sample_step_rows, step_update
    from repro_torch.index.build import seeded_generator

    torch.set_num_threads(1)
    cfg = _cfg()
    theta, idx = _state()
    means = local_means(theta, idx["counts"], cfg.cluster_capacity)
    counts_f = idx["counts"].float()
    a, b = theta.clone(), theta.clone()
    rows, cl, neg = sample_step_rows(seeded_generator(a.device, 7, 0), idx, cfg, method)
    want = step_update(a, idx, means, counts_f, 0.5, rows, cl, neg, cfg=cfg, method=method)
    step = make_step_fn(cfg, method=method)
    b2, got = step(b, idx, means, counts_f, 0.5, seeded_generator(b.device, 7, 0))
    assert b2 is b
    assert torch.equal(got, want) and torch.equal(a, b) and not torch.equal(a, theta)


@pytest.mark.parametrize("refresh", [0, 3])
def test_epoch_factory_equals_the_step_loop(refresh):
    """``make_epoch_fn(cfg, make_step_fn(cfg), steps)`` and ``run_epoch``
    against the epoch written out: means refreshed every ``refresh`` steps
    (0: once), lr annealed, step t's generator from (*key, t)."""
    from repro_torch.core import make_epoch_fn, make_step_fn
    from repro_torch.core.nomad import local_means, run_epoch, sample_step_rows, step_update
    from repro_torch.index.build import seeded_generator

    torch.set_num_threads(1)
    cfg = _cfg(refresh=refresh)
    theta, idx = _state(1)
    steps, lr0, lr1, key = 7, 2.0, 0.5, (cfg.seed + 1, 4)
    ref = theta.clone()
    losses = []
    for t in range(steps):
        if t % (refresh or steps) == 0:
            means = local_means(ref, idx["counts"], cfg.cluster_capacity)
        rows, cl, neg = sample_step_rows(seeded_generator(ref.device, *key, t), idx, cfg, "nomad")
        losses.append(step_update(ref, idx, means, idx["counts"].float(), lr0 + (lr1 - lr0) * (t / steps), rows, cl,
                                  neg, cfg=cfg))
    want_loss = torch.stack(losses).mean()
    epoch = make_epoch_fn(cfg, make_step_fn(cfg), steps)
    got, loss = epoch(theta.clone(), idx, lr0, lr1, key)
    assert torch.equal(got, ref) and torch.equal(loss, want_loss)
    got2, loss2 = run_epoch(theta.clone(), idx, cfg, "nomad", steps, lr0, lr1, 4)
    assert torch.equal(got2, ref) and torch.equal(loss2, want_loss)
