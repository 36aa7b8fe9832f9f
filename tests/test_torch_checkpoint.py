"""The port's checkpoints on the CPU: the JAX package's format both ways,
serving a checkpoint directory either package wrote, and the port's own
bit-equality contracts (from_checkpoint ≡ fitted, resume ≡ uninterrupted)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint import load_theta as jax_load_theta  # noqa: E402
from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro_torch.checkpoint import Checkpointer, latest_step, load_metadata, load_theta  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.core.strategy import LocalStrategy  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.serve import FrozenMap  # noqa: E402

N, DIM = 1500, 16
CFG = NomadConfig(
    n_points=N, dim=DIM, n_clusters=4, n_neighbors=10, n_noise=16, n_exact_negatives=4,
    batch_size=256, n_epochs=4, serve_microbatch=128, transform_steps=6, checkpoint_every_epochs=1,
)


@pytest.fixture(scope="module")
def data():
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    q, _ = gaussian_mixture(200, DIM, n_components=4, seed=7)
    return x, q


@pytest.fixture(scope="module")
def port_ck(data, tmp_path_factory):
    """A port fit with checkpoint_dir: (estimator, result, dir)."""
    x, _ = data
    ckdir = str(tmp_path_factory.mktemp("port") / "ck")
    est = NomadProjection(CFG.replace(checkpoint_dir=ckdir), device="cpu")
    return est, est.fit(x), ckdir


@pytest.fixture(scope="module")
def jax_ck(data, tmp_path_factory):
    """A JAX fit (kernel_impl="jnp") with checkpoint_dir: (estimator, dir)."""
    x, _ = data
    ckdir = str(tmp_path_factory.mktemp("jax") / "ck")
    jcfg = JaxConfig(**dataclasses.asdict(CFG.replace(checkpoint_dir=ckdir)), kernel_impl="jnp")
    est = JaxProjection(jcfg)
    est.fit(x)
    return est, ckdir


def test_format_on_disk(port_ck):
    """step_<n>/ with shard npz + manifest, no tmp left, keep=3 pruning,
    and the JAX metadata keys."""
    _, res, ckdir = port_ck
    assert res.checkpoint_epochs == [0, 1, 2, 3]
    assert sorted(os.listdir(ckdir)) == ["index.npz", "step_000000001", "step_000000002", "step_000000003"]
    with open(os.path.join(ckdir, "step_000000003", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["sharded"] == ["theta"] and manifest["n_shards"] == 1
    assert set(manifest["metadata"]) == {"epoch", "config", "method", "strategy", "losses"}
    assert latest_step(ckdir) == 3 and load_metadata(ckdir)["epoch"] == 3


def test_port_theta_loads_through_reference(port_ck):
    _, res, ckdir = port_ck
    theta, meta = jax_load_theta(ckdir)
    np.testing.assert_array_equal(res.index.unpermute(theta), res.embedding)
    mine, my_meta = load_theta(ckdir)
    np.testing.assert_array_equal(mine, theta)
    assert meta == my_meta
    assert JaxConfig(**meta["config"]).n_points == N  # the port's dict is a subset of the JAX fields


def test_reference_checkpoint_loads_through_port(tmp_path):
    """Written by the JAX Checkpointer with 4 shards; the port concatenates
    them, and the JAX Checkpointer reads back a tree the port wrote."""
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(64, 2)).astype(np.float32)
    JaxCheckpointer(str(tmp_path / "j"), n_shards=4).save(
        7, {"theta": theta, "extra": {"a": np.arange(3)}}, sharded_keys=("theta",), metadata={"epoch": 7}
    )
    got, meta = load_theta(str(tmp_path / "j"))
    np.testing.assert_array_equal(got, theta)
    assert meta == {"epoch": 7} and latest_step(str(tmp_path / "j")) == 7
    Checkpointer(str(tmp_path / "p")).save(1, {"theta": theta, "extra": {"a": np.arange(3)}},
                                           sharded_keys=("theta",))
    tree, _ = JaxCheckpointer(str(tmp_path / "p")).restore({"theta": None, "extra": {"a": None}})
    np.testing.assert_array_equal(tree["theta"], theta)
    np.testing.assert_array_equal(tree["extra"]["a"], np.arange(3))
    with pytest.raises(FileNotFoundError):
        load_metadata(str(tmp_path / "p" / "nothing-here"))


def test_jax_checkpoint_dir_serves_through_port(jax_ck, data):
    """A JAX-written directory (its config holds kernel_impl and use_pallas)
    serves through the port: assign and kNN equal the JAX neighbors()."""
    jest, ckdir = jax_ck
    _, q = data
    fz = FrozenMap.from_checkpoint(ckdir, device="cpu")
    assert fz.cfg == NomadConfig.from_stored(load_metadata(ckdir)["config"])
    jfz = jest.map_server().frozen
    ids, dists = fz.neighbors(q)
    jids, jdists = jfz.neighbors(q)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(dists, np.asarray(jdists), rtol=1e-5, atol=1e-5)
    cold = NomadProjection.from_checkpoint(ckdir, device="cpu")
    assert cold.cfg.checkpoint_dir == ckdir
    r = cold.map_server().transform(q, seed=0)
    np.testing.assert_array_equal(r.neighbor_ids, ids)
    assert np.isfinite(r.embedding).all()


def test_from_checkpoint_transform_equals_fitted(port_ck, data):
    est, _, ckdir = port_ck
    _, q = data
    a = est.map_server().transform(q, seed=0)
    b = NomadProjection.from_checkpoint(ckdir, device="cpu").map_server().transform(q, seed=0)
    for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    c = FrozenMap.from_checkpoint(ckdir, device="cpu")
    np.testing.assert_array_equal(c.theta_rows.numpy(), est.map_server().frozen.theta_rows.numpy())


def test_resume_after_interruption_equals_uninterrupted(port_ck, data, tmp_path, monkeypatch):
    """A fit killed after epoch 1 and resumed from its checkpoint equals
    the uninterrupted fit bit for bit (index from the cache, θ and epoch
    from step_1, the same per-epoch draws)."""
    _, full, _ = port_ck
    x, _ = data
    ckdir = str(tmp_path / "ck")
    run_epoch = LocalStrategy.run_epoch

    def dies_at_2(self, theta, epoch, lr0, lr1):
        if epoch == 2:
            raise RuntimeError("killed at epoch 2")
        return run_epoch(self, theta, epoch, lr0, lr1)

    monkeypatch.setattr(LocalStrategy, "run_epoch", dies_at_2)
    with pytest.raises(RuntimeError, match="killed"):
        NomadProjection(CFG.replace(checkpoint_dir=ckdir), device="cpu").fit(x)
    monkeypatch.setattr(LocalStrategy, "run_epoch", run_epoch)
    assert latest_step(ckdir) == 1
    resumed = NomadProjection.from_checkpoint(ckdir, device="cpu").fit(x)
    assert resumed.resumed and resumed.start_epoch == 2 and resumed.index_build_strategy == "cache"
    assert resumed.checkpoint_epochs == [2, 3]
    np.testing.assert_array_equal(resumed.embedding, full.embedding)
    np.testing.assert_array_equal(resumed.losses, full.losses[2:])


def test_stale_index_cache_is_rebuilt(port_ck, data, tmp_path):
    """A cache written for other data of the same shape is ignored (and
    replaced), never silently served for the caller's rows."""
    _, _, ckdir = port_ck
    x, _ = data
    other = str(tmp_path / "ck")
    os.makedirs(other)
    shutil.copy(os.path.join(ckdir, "index.npz"), other)
    y = x[::-1].copy()
    with pytest.warns(UserWarning, match="fingerprint"):
        res = NomadProjection(CFG.replace(checkpoint_dir=other, n_epochs=1), device="cpu").fit(y)
    assert res.index_build_strategy == "local"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = NomadProjection(CFG.replace(checkpoint_dir=other, n_epochs=1), device="cpu").fit(y)
    assert again.index_build_strategy == "cache"


def test_resume_needs_a_checkpoint_dir(data):
    x, _ = data
    with pytest.raises(ValueError, match="checkpoint_dir"):
        NomadProjection(CFG, device="cpu").fit(x, resume=True)


def test_config_from_stored_drops_jax_switches():
    stored = dataclasses.asdict(JaxConfig(**dataclasses.asdict(CFG), kernel_impl="jnp"))
    assert NomadConfig.from_stored(stored) == CFG
    assert NomadConfig.from_stored(stored, n_epochs=9).n_epochs == 9
    with pytest.raises(TypeError):
        NomadConfig.from_stored({**stored, "no_such_field": 1})
