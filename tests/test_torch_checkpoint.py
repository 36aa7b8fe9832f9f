"""The port's checkpoints on the CPU: the JAX package's format both ways
(one shard and row-sharded), serving a checkpoint directory either package
wrote, the writer's reference arguments (``n_shards``, ``keep``,
``async_save``, ``primary``), and the port's own bit-equality contracts
(from_checkpoint ≡ fitted, resume ≡ uninterrupted, async ≡ sync; the fit
saves asynchronously)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# The writer: the reference's arguments, the async thread, shards
# ---------------------------------------------------------------------------


def _read_all(ckdir: str) -> dict:
    """Every step directory's manifest and every array of every shard."""
    out = {}
    for name in sorted(os.listdir(ckdir)):
        if not name.startswith("step_"):
            continue
        with open(os.path.join(ckdir, name, "manifest.json")) as f:
            files = {"manifest": json.load(f)}
        for shard in sorted(os.listdir(os.path.join(ckdir, name))):
            if shard.endswith(".npz"):
                with np.load(os.path.join(ckdir, name, shard)) as z:
                    files[shard] = {k: z[k] for k in z.files}
        out[name] = files
    return out


def _assert_same_checkpoints(a: dict, b: dict):
    assert a.keys() == b.keys() and a
    for step in a:
        assert a[step].keys() == b[step].keys()
        assert a[step]["manifest"] == b[step]["manifest"]
        for shard in a[step]:
            if shard != "manifest":
                assert a[step][shard].keys() == b[step][shard].keys()
                for k in a[step][shard]:
                    np.testing.assert_array_equal(a[step][shard][k], b[step][shard][k])
                    assert a[step][shard][k].dtype == b[step][shard][k].dtype


def test_reference_keyword_arguments(tmp_path):
    """``Checkpointer(directory, *, n_shards, keep, async_save, primary)``
    as the reference's; the reference's own fit passes all four."""
    ck = Checkpointer(str(tmp_path), n_shards=1, keep=3, async_save=True, primary=True)
    ck.save(0, {"theta": np.ones((4, 2), np.float32)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 0 and (ck.n_shards, ck.keep, ck.primary) == (1, 3, True)


def test_fit_saves_async_equal_to_sync(port_ck, data, tmp_path, monkeypatch):
    """The fit's writer thread leaves the same checkpoints as a synchronous
    writer of the same fit: every array bit-equal, the manifests equal."""
    import repro_torch.checkpoint as ck_mod

    _, full, ckdir = port_ck
    made = []

    class Sync(ck_mod.Checkpointer):
        def __init__(self, directory, **kw):
            made.append(kw)
            super().__init__(directory, **dict(kw, async_save=False))

    monkeypatch.setattr(ck_mod, "Checkpointer", Sync)
    x, _ = data
    sync_dir = str(tmp_path / "sync")
    res = NomadProjection(CFG.replace(checkpoint_dir=sync_dir), device="cpu").fit(x)
    # the fit asks for the async writer (one process: it is the primary;
    # the local fit's one shard)
    assert made == [{"n_shards": 1, "keep": 3, "async_save": True, "primary": True}]
    np.testing.assert_array_equal(res.embedding, full.embedding)
    got, want = _read_all(ckdir), _read_all(sync_dir)
    for files in list(got.values()) + list(want.values()):
        files["manifest"]["metadata"]["config"].pop("checkpoint_dir")
    _assert_same_checkpoints(got, want)


def test_async_save_takes_its_copy_before_returning(tmp_path):
    """A tensor (and an array) updated in place right after an async
    ``save`` returns leave the saved values as they were: the write, held
    back here behind a blocked task on the writer thread, sees the copy."""
    import threading

    theta = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    extra = np.arange(3)
    want_theta, want_extra = theta.clone().numpy(), extra.copy()
    ck = Checkpointer(str(tmp_path), async_save=True)
    gate = threading.Event()
    ck._pool.submit(gate.wait, 30)
    ck.save(4, {"theta": theta, "extra": extra}, sharded_keys=("theta",), metadata={"losses": [1.0]})
    theta.add_(100.0)
    extra += 7
    assert latest_step(str(tmp_path)) is None  # not committed yet
    gate.set()
    ck.wait()
    tree, meta = Checkpointer(str(tmp_path)).restore({"theta": None, "extra": None})
    np.testing.assert_array_equal(tree["theta"], want_theta)
    np.testing.assert_array_equal(tree["extra"], want_extra)
    assert meta == {"losses": [1.0]}


def test_interrupted_fit_commits_the_save_in_flight(data, tmp_path, monkeypatch):
    """A fit killed while its last save is still being written commits
    that save before the error propagates (``wait`` in a ``finally``)."""
    import threading

    x, _ = data
    ckdir = str(tmp_path / "ck")
    write = Checkpointer._write
    started = threading.Event()

    def slow_write(self, step, *a):
        started.set()
        time.sleep(0.5)
        return write(self, step, *a)

    run_epoch = LocalStrategy.run_epoch

    def dies_at_1(self, theta, epoch, lr0, lr1):
        if epoch == 1:
            assert started.wait(30)
            raise RuntimeError("killed at epoch 1")
        return run_epoch(self, theta, epoch, lr0, lr1)

    monkeypatch.setattr(Checkpointer, "_write", slow_write)
    monkeypatch.setattr(LocalStrategy, "run_epoch", dies_at_1)
    with pytest.raises(RuntimeError, match="killed"):
        NomadProjection(CFG.replace(checkpoint_dir=ckdir), device="cpu").fit(x)
    assert latest_step(ckdir) == 0
    assert not [n for n in os.listdir(ckdir) if n.endswith(".tmp")]


@pytest.mark.parametrize("async_save", [False, True])
def test_sharded_checkpoints_read_both_ways(tmp_path, async_save):
    """``n_shards=2``: each of ``sharded_keys`` split into two row blocks,
    one a shard file, replicated leaves in shard 0. The JAX package reads
    what the port wrote, and the port what the JAX package wrote."""
    rng = np.random.default_rng(3)
    tree = {"theta": rng.normal(size=(10, 2)).astype(np.float32), "extra": {"a": np.arange(5)}}
    skel = {"theta": None, "extra": {"a": None}}
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    ck = Checkpointer(port_dir, n_shards=2, async_save=async_save)
    ck.save(3, tree, sharded_keys=("theta",), metadata={"epoch": 3})
    ck.wait()
    JaxCheckpointer(jax_dir, n_shards=2).save(3, tree, sharded_keys=("theta",), metadata={"epoch": 3})
    _assert_same_checkpoints(_read_all(port_dir), _read_all(jax_dir))
    with np.load(os.path.join(port_dir, "step_000000003", "shard_00001.npz")) as z:
        assert z.files == ["theta"] and z["theta"].shape == (5, 2)
    for reader in (JaxCheckpointer, Checkpointer):
        for d in (port_dir, jax_dir):
            got, meta = reader(d).restore(skel)
            np.testing.assert_array_equal(got["theta"], tree["theta"])
            np.testing.assert_array_equal(got["extra"]["a"], tree["extra"]["a"])
            assert meta == {"epoch": 3}
    bad = Checkpointer(str(tmp_path / "bad"), n_shards=3, async_save=async_save)
    with pytest.raises(ValueError, match="shards"):  # raised by save, on the caller's thread
        bad.save(0, tree, sharded_keys=("theta",))
    assert os.listdir(str(tmp_path / "bad")) == []


def test_non_primary_writes_nothing(tmp_path):
    """``primary=False``: ``save`` is a no-op (the primary process writes)."""
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, primary=False, async_save=True)
    ck.save(0, {"theta": np.ones((2, 2), np.float32)})
    ck.wait()
    assert os.listdir(d) == [] and latest_step(d) is None
