"""The index half of ``partial_fit`` and the lineage file, the port against
the JAX package on the same numpy inputs: ``versions.json`` both ways,
``chained_fingerprint``, ``admit_and_patch`` from one JAX-built index, θ and
placement (appends only, with splits, store-backed; the kNN patch in blocks
of cells ≡ one batch), ``capacity_assign_device``, and one refinement step
from the rows the JAX step draws."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.index.kmeans as jax_kmeans  # noqa: E402
import repro_torch.index.kmeans as port_kmeans  # noqa: E402
from repro.checkpoint.lineage import MapLineage as JaxLineage  # noqa: E402
from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core import nomad as jax_nomad  # noqa: E402
from repro.data.store import ShardedStore as JaxShardedStore  # noqa: E402
from repro.data.store import write_sharded as jax_write_sharded  # noqa: E402
from repro.index.ann import AnnIndex as JaxAnnIndex  # noqa: E402
from repro.index.build import IndexBuilder as JaxBuilder  # noqa: E402
from repro.index.build import capacity_assign_device as jax_capacity_assign  # noqa: E402
from repro.index.incremental import admit_and_patch as jax_admit  # noqa: E402
from repro.index.incremental import chained_fingerprint as jax_chained  # noqa: E402
from repro_torch.checkpoint import VERSIONS_FILE, MapLineage  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core import nomad  # noqa: E402
from repro_torch.core.strategy import PartialRefineStrategy  # noqa: E402
from repro_torch.data.store import ShardedStore  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index.ann import AnnIndex, index_from_arrays  # noqa: E402
from repro_torch.index.build import capacity_assign_device, chunked_cluster_knn, seeded_generator  # noqa: E402
from repro_torch.index.incremental import admit_and_patch, chained_fingerprint  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
CFG = NomadConfig(
    n_points=800, dim=8, n_clusters=8, n_neighbors=5, n_noise=8, n_exact_negatives=4,
    batch_size=128, n_epochs=2, strategy="local", build_strategy="local",
)
C = CFG.cluster_capacity  # 125


@pytest.fixture(scope="module")
def base():
    """One JAX-built index, a θ in its layout and new rows placed near the
    centroids (placement = nearest centroid), shared by the admission tests."""
    x, _ = gaussian_mixture(CFG.n_points, CFG.dim, n_components=8, seed=0)
    jindex = JaxBuilder(JaxConfig(**dataclasses.asdict(CFG)), strategy="local").build(x)
    theta = np.random.default_rng(1).normal(0, 3, (jindex.n_clusters * C, 2)).astype(np.float32)
    theta[~jindex.valid_mask] = 0.0
    return x, jindex, theta


def _rows_near(jindex, per_cell: dict, seed: int):
    """``per_cell[c]`` new rows around centroid c, interleaved across cells
    (so the slot order of appended rows is the order they come in)."""
    rng = np.random.default_rng(seed)
    cells = np.concatenate([np.full(n, c) for c, n in per_cell.items()])
    cells = cells[rng.permutation(cells.size)]
    y = np.asarray(jindex.centroids)[cells] + rng.normal(0, 0.05, (cells.size, CFG.dim))
    th = rng.normal(0, 3, (cells.size, 2))
    return y.astype(np.float32), cells.astype(np.int64), th.astype(np.float32)


def _both(jindex, theta, y, cells, th, *, jax_index=None, port_index=None, spill=None):
    jup = jax_admit(jax_index or jindex, theta, y, cells, th, JaxConfig(**dataclasses.asdict(CFG)),
                    impl="jnp", spill_dir=spill and spill + "-jax")
    pindex = port_index or index_from_arrays(dataclasses.asdict(jindex))
    pup = admit_and_patch(pindex, theta, y, cells, th, CFG, device=CPU, spill_dir=spill and spill + "-port")
    return jup, pup


def _assert_same_update(jup, pup):
    ji, pi = jup.index, pup.index
    x_j, x_p = (np.asarray(a.materialize() if hasattr(a, "materialize") else a) for a in (ji.x_rows, pi.x_rows))
    np.testing.assert_array_equal(x_p, x_j)
    for f in ("perm", "counts", "centroids", "knn_idx"):
        np.testing.assert_array_equal(getattr(pi, f), np.asarray(getattr(ji, f)), err_msg=f)
    np.testing.assert_allclose(pi.knn_w, np.asarray(ji.knn_w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pup.theta_rows, np.asarray(jup.theta_rows))
    np.testing.assert_array_equal(pup.affected_cells, np.asarray(jup.affected_cells))
    assert (pup.n_split_cells, pup.n_new_cells) == (jup.n_split_cells, jup.n_new_cells)
    assert (pi.n_points, pi.capacity, pi.fingerprint) == (ji.n_points, ji.capacity, ji.fingerprint)


# ---------------------------------------------------------------------------
# versions.json and the chained fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lineage_file_reads_both_ways(tmp_path, writer):
    """A lineage either package writes reads the same in the other, and the
    other can append to it."""
    root = str(tmp_path)
    W, R = (JaxLineage, MapLineage) if writer == "jax" else (MapLineage, JaxLineage)
    W(root).record(name="v0", dirname=".", parent="", fingerprint="a" * 16, n_points=100, kind="fit")
    W(root).record(name=W(root).next_name(), dirname="v1", parent="v0", fingerprint="b" * 16, n_points=120,
                   kind="partial_fit")
    got, want = R(root).load(), W(root).load()
    assert [v.to_json() for v in got] == [v.to_json() for v in want]
    assert R(root).resolve().path == os.path.join(root, "v1") and R(root).resolve("v0").path == root
    assert R(root).next_name() == W(root).next_name() == "v2"
    R(root).record(name="v2", dirname="v2", parent="v1", fingerprint="c" * 16, n_points=130, kind="partial_fit")
    assert [v.name for v in W(root).load()] == ["v0", "v1", "v2"]
    with open(os.path.join(root, VERSIONS_FILE)) as f:
        assert set(json.load(f)["versions"][0]) == {"name", "dir", "parent", "fingerprint", "n_points", "kind",
                                                   "created_at"}


@pytest.mark.parametrize("package", ["jax", "port"])
def test_lineage_refusals_match(tmp_path, package):
    L = JaxLineage if package == "jax" else MapLineage
    lin = L(str(tmp_path))
    assert not lin.exists() and lin.load() == [] and lin.latest() is None
    with pytest.raises(FileNotFoundError):
        lin.resolve()
    lin.record(name="v0", dirname=".", parent="", fingerprint="f", n_points=1, kind="fit")
    with pytest.raises(ValueError):
        lin.record(name="v0", dirname=".", parent="", fingerprint="f", n_points=1, kind="fit")
    with pytest.raises(ValueError):
        lin.record(name="v1", dirname="v1", parent="v9", fingerprint="f", n_points=1, kind="partial_fit")
    with pytest.raises(KeyError):
        lin.resolve("v7")
    assert not os.path.exists(os.path.join(str(tmp_path), VERSIONS_FILE + ".tmp"))


def test_chained_fingerprint_matches_jax(base):
    x = base[0]
    y = x[:37] + 1.0
    assert chained_fingerprint("0123456789abcdef", y) == jax_chained("0123456789abcdef", y)
    assert chained_fingerprint("0123456789abcdef", y) != chained_fingerprint("0123456789abcdef", y[::-1])


# ---------------------------------------------------------------------------
# admit_and_patch against the JAX package
# ---------------------------------------------------------------------------


def test_admit_appends_only_matches_jax(base):
    _x, jindex, theta = base
    free = C - np.asarray(jindex.counts)
    y, cells, th = _rows_near(jindex, {c: min(6, int(free[c])) for c in range(0, 8, 2)}, seed=2)
    jup, pup = _both(jindex, theta, y, cells, th)
    assert pup.n_split_cells == 0 and pup.n_new_cells == 0
    _assert_same_update(jup, pup)


def _numpy_centroids(x: np.ndarray, n: int) -> np.ndarray:
    """One numpy function of a split cell's members, in place of both
    packages' seeded k-means (their generators differ)."""
    order = np.argsort(x[:, 0], kind="stable")
    return x[order[np.linspace(0, x.shape[0] - 1, n).astype(np.int64)]].astype(np.float32)


@pytest.fixture()
def same_split_centroids(monkeypatch):
    monkeypatch.setattr(jax_kmeans, "kmeans_centroids",
                        lambda key, x, n, **kw: jnp.asarray(_numpy_centroids(np.asarray(x), n)))
    monkeypatch.setattr(port_kmeans, "kmeans_centroids",
                        lambda gen, x, n, **kw: torch.from_numpy(_numpy_centroids(x.cpu().numpy(), n)))


def _split_rows(jindex):
    """Overflow cells 1 and 5 (one by 1 row past their free slots, one by a
    whole cell's worth) and append a few rows elsewhere."""
    free = C - np.asarray(jindex.counts)
    return _rows_near(jindex, {1: int(free[1]) + 1, 5: int(free[5]) + C, 2: 3, 6: 4}, seed=3)


def test_admit_with_splits_matches_jax(base, same_split_centroids):
    _x, jindex, theta = base
    y, cells, th = _split_rows(jindex)
    jup, pup = _both(jindex, theta, y, cells, th)
    assert pup.n_split_cells == 2 and pup.n_new_cells >= 2
    assert (pup.index.counts <= C).all()
    _assert_same_update(jup, pup)


def test_admit_store_backed_matches_jax(base, same_split_centroids, tmp_path):
    """A store-backed x_rows: the port's patched store, read through the
    JAX package's ShardedStore, holds the JAX patch's rows on its shard grid."""
    _x, jindex, theta = base
    src = str(tmp_path / "x_rows")
    jax_write_sharded(np.asarray(jindex.x_rows), src, rows_per_shard=2 * C)
    jidx = JaxAnnIndex(**{**dataclasses.asdict(jindex), "x_rows": JaxShardedStore(src)})
    pidx = index_from_arrays({**dataclasses.asdict(jindex), "x_rows": np.zeros((1, CFG.dim))})
    pidx = AnnIndex(**{**dataclasses.asdict(pidx), "x_rows": ShardedStore(src)})
    y, cells, th = _split_rows(jindex)
    jup, pup = _both(jindex, theta, y, cells, th, jax_index=jidx, port_index=pidx, spill=str(tmp_path / "grown"))
    assert isinstance(pup.index.x_rows, ShardedStore)
    _assert_same_update(jup, pup)
    port_store = JaxShardedStore(pup.index.x_rows.path)
    jax_store = jup.index.x_rows
    np.testing.assert_array_equal(port_store.materialize(), jax_store.materialize())
    with open(os.path.join(pup.index.x_rows.path, "meta.json")) as f, \
            open(os.path.join(jax_store.path, "meta.json")) as g:
        pm, jm = json.load(f), json.load(g)
    assert {k: pm[k] for k in ("n_rows", "dim", "dtype", "shards")} == \
        {k: jm[k] for k in ("n_rows", "dim", "dtype", "shards")}


def test_knn_patch_in_blocks_equals_one_batch(base):
    _x, jindex, _theta = base
    K = jindex.n_clusters
    array = np.asarray(jindex.x_rows).reshape(K, C, CFG.dim)
    counts = np.asarray(jindex.counts)
    one = chunked_cluster_knn(list(array), counts, CFG.n_neighbors, CPU, cells_per_launch=K)
    for blocks, per in ((list(array), 1), (list(array), 3), (array, 3)):  # the patch's list, the build's array
        got = chunked_cluster_knn(blocks, counts, CFG.n_neighbors, CPU, cells_per_launch=per)
        np.testing.assert_array_equal(got[0], one[0])
        np.testing.assert_array_equal(got[1], one[1])


def test_capacity_assign_device_matches_jax(base):
    """The split's assignment, held to the JAX package's on rows that crowd
    two of four centroids past capacity (bidding rounds do the work)."""
    x = base[0][:300]
    cents = _numpy_centroids(x, 4)
    for cap, n_cand in ((90, 4), (80, 2)):
        want = jax_capacity_assign(x, cents, cap, impl="jnp", max_rounds=16, n_cand=n_cand)
        got = capacity_assign_device(x, cents, cap, device=CPU, max_rounds=16, n_cand=n_cand)
        np.testing.assert_array_equal(got, want)
        assert np.bincount(got, minlength=4).max() <= cap


# ---------------------------------------------------------------------------
# One refinement step against make_partial_step_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["nomad", "infonc"])
def test_partial_step_moves_theta_like_jax(base, method):
    _x, jindex, theta0 = base
    aff = np.array([1, 4, 6], np.int64)
    counts = np.asarray(jindex.counts)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    jidx = {
        "knn_idx": jnp.asarray(jindex.knn_idx, jnp.int32),
        "knn_w": jnp.asarray(jindex.knn_w, jnp.float32),
        "counts": jnp.asarray(counts, jnp.int32),
        "cum_counts": jnp.asarray(np.cumsum(counts), jnp.int32),
        "aff_cells": jnp.asarray(aff, jnp.int32),
        "aff_cum_counts": jnp.asarray(np.cumsum(counts[aff]), jnp.int32),
    }
    means = jax_nomad.local_means(jnp.asarray(theta0), jidx["counts"], C)
    lr, key, n_total = jcfg.resolved_lr0(), jax.random.key(5), int(jindex.n_points)
    want, want_loss = jax_nomad.make_partial_step_fn(jcfg, method=method, n_total=n_total)(
        jnp.asarray(theta0), jidx, means, jidx["counts"].astype(jnp.float32), lr, key)

    # the rows that step drew from that key, by its own arithmetic
    B = CFG.batch_size
    k_head, k_neg = jax.random.split(key)
    acum = jidx["aff_cum_counts"]
    u = jax.random.randint(k_head, (B,), 0, acum[-1])
    a = jnp.searchsorted(acum, u, side="right")
    start = jnp.where(a > 0, acum[a - 1], 0)
    cell = jidx["aff_cells"][a]
    rows = cell * C + (u - start)
    if method == "infonc":
        neg, _ = jax_nomad.sample_points(k_neg, B * CFG.n_noise, jidx["cum_counts"], C)
        neg = neg.reshape(B, CFG.n_noise)
    else:
        neg = jax_nomad.sample_in_cluster(k_neg, cell, jidx["counts"], C, CFG.n_exact_negatives)

    strategy = PartialRefineStrategy(aff)
    theta = strategy.prepare(CFG, method, index_from_arrays(dataclasses.asdict(jindex)), theta0, CPU)
    loss = nomad.step_update(
        theta, strategy.idx, torch.from_numpy(np.array(means)), strategy.idx["counts"].float(), lr,
        *(torch.from_numpy(np.asarray(v).astype(np.int64)) for v in (rows, cell, neg)),
        cfg=CFG, method=method, n_total=n_total,
    )
    want = np.asarray(want)
    np.testing.assert_allclose(theta.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)
    if method == "nomad":  # in-cell positives and negatives: nothing else moves
        outside = ~np.isin(np.arange(theta0.shape[0]) // C, aff)
        assert not np.array_equal(want[~outside], theta0[~outside])
        np.testing.assert_array_equal(want[outside], theta0[outside])
        np.testing.assert_array_equal(theta.numpy()[outside], theta0[outside])


def test_port_partial_sampler_draws_affected_rows(base):
    _x, jindex, theta0 = base
    aff = np.array([0, 3, 7], np.int64)
    strategy = PartialRefineStrategy(aff)
    strategy.prepare(CFG, "nomad", index_from_arrays(dataclasses.asdict(jindex)), theta0, CPU)
    gen = seeded_generator(CPU, CFG.seed + 11, jindex.n_points, 0, 0)
    rows, cl, neg = nomad.sample_partial_rows(gen, strategy.idx, CFG, "nomad")
    valid = torch.from_numpy(jindex.valid_mask)
    assert bool(valid[rows].all()) and bool(valid[neg].all())
    assert torch.equal(rows // C, cl) and set(cl.tolist()) == set(aff.tolist())
    assert bool((neg // C == cl[:, None]).all())
    counts = np.asarray(jindex.counts)
    assert strategy.steps == -(-int(counts[aff].sum()) // CFG.batch_size)
