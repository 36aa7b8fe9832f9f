"""The port's streamed (out-of-core) path on the CPU: streamed k-means,
PCA (exact, randomized, streamed) and capacity assignment held to the JAX
package on the same numpy inputs; then the port's own contracts: a store,
memmap, ``.npy`` path or store directory builds, fits and serves bit for
bit as the array does with the same ``chunk_rows``, resume and the index
cache's sidecar, and a streamed fit scores within the side-by-side band of
a streamed JAX fit."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.core.pca import pca_init as jax_pca_init  # noqa: E402
from repro.core.pca import pca_init_streamed as jax_pca_init_streamed  # noqa: E402
from repro.data import store as jst  # noqa: E402
from repro.index import kmeans as jax_km  # noqa: E402
from repro.index.build import capacity_assign_device as jax_capacity_assign  # noqa: E402
from repro.metrics import neighborhood_preservation, random_triplet_accuracy  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.core.pca import pca_init, pca_init_streamed, range_start  # noqa: E402
from repro_torch.data import store as pst  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index import kmeans as km  # noqa: E402
from repro_torch.index.ann import load_index  # noqa: E402
from repro_torch.index.build import (  # noqa: E402
    IndexBuilder,
    capacity_rounds,
    force_place_host,
    seeded_generator,
    streamed_candidates,
)
from repro_torch.serve import FrozenMap  # noqa: E402
from test_torch_fit import SIDE_BY_SIDE_BAND  # noqa: E402


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
    batch_size=256, n_epochs=3, serve_microbatch=128, transform_steps=6, chunk_rows=400,
)
INDEX_FIELDS = ("knn_idx", "knn_w", "counts", "centroids", "perm")


@pytest.fixture(scope="module")
def data():
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    q, _ = gaussian_mixture(1100, DIM, n_components=4, seed=7)
    return x, q


@pytest.fixture(scope="module")
def containers(data, tmp_path_factory):
    """The same rows as a sharded store (shards that do not divide the
    chunk), a store directory path, a memmap and a .npy path."""
    x, _ = data
    d = tmp_path_factory.mktemp("containers")
    sharded = pst.write_sharded(x, str(d / "s"), rows_per_shard=333)
    np.save(str(d / "x.npy"), x)
    return {
        "sharded": sharded,
        "store_dir": str(d / "s"),
        "memmap": np.load(str(d / "x.npy"), mmap_mode="r"),
        "npy_path": str(d / "x.npy"),
    }


@pytest.fixture(scope="module")
def array_fit(data):
    x, _ = data
    return NomadProjection(CFG, device="cpu").fit(x)


def _low_rank(n, d, seed):
    """Rows whose top two variances stand ≥ 10× above the rest."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, 2)))[0].T
    z = rng.normal(size=(n, 2)) * np.array([6.0, 3.0])
    return (z @ basis + rng.normal(0, 0.1, (n, d)) + 0.5).astype(np.float32)


def _align(a, b):
    """``a``'s columns with the signs of ``b``'s."""
    return a * np.where(np.sum(a * b, 0) < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_streamed_kmeans_matches_jax_em(data):
    """From the same centroids, the port's chunked EM (ragged last chunk,
    padding weighted out) agrees with JAX's resident EM within 1e-4."""
    x, _ = data
    K, iters = 6, 8
    cents0 = x[np.random.default_rng(2).choice(N, K, replace=False)]
    want = jax_km._kmeans_cents_jit(jnp.asarray(x), jnp.asarray(cents0), jnp.float32(0.0), K, iters, "jnp", 512)
    got = km.kmeans_centroids_streamed(None, pst.ArrayStore(x), K, chunk_rows=400, n_iters=iters, tol=0.0,
                                       block=256, device="cpu", cents0=torch.from_numpy(cents0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_streamed_lsh_init_matches_resident(data):
    """The streamed LSH pass draws the resident init's planes and fallback
    rows from the same generator and sums the same buckets."""
    x, _ = data
    want = km.lsh_init_centroids(seeded_generator(torch.device("cpu"), 5), torch.from_numpy(x), 6)
    got = km.kmeans_centroids_streamed(seeded_generator(torch.device("cpu"), 5), pst.ArrayStore(x), 6,
                                       chunk_rows=400, n_iters=0, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["exact", "randomized", "streamed_exact", "streamed_randomized"])
def test_pca_matches_jax(kind):
    """PCA agrees with the JAX package's after aligning each column's sign,
    within 1e-3 of the largest |θ|: exact at D 32, the range-finder at D
    2304 (> 2048), resident and streamed over ragged chunks."""
    d = 2304 if kind.endswith("randomized") else 32
    x = _low_rank(600, d, seed=4)
    if kind.startswith("streamed"):
        got = pca_init_streamed(pst.ArrayStore(x), 2, 1e-4, chunk_rows=256, device="cpu")
        want = np.asarray(jax_pca_init_streamed(jst.ArrayStore(x), 2, 1e-4, chunk_rows=256))
    else:
        got = pca_init(torch.from_numpy(x), 2, 1e-4).numpy()
        want = np.asarray(jax_pca_init(jnp.asarray(x), 2, 1e-4))
    scale = np.abs(want).max()
    np.testing.assert_allclose(_align(got, want), want, atol=1e-3 * scale, rtol=0)


def test_randomized_start_is_the_cpu_generators():
    """The range-finder starts from a CPU generator seeded 17 whatever the
    device, so the card and the CPU draw the same matrix."""
    a, b = range_start(300, 2, "cpu"), range_start(300, 2, torch.device("cpu"))
    assert a.shape == (300, 10) and torch.equal(a, b)
    assert torch.equal(a, torch.randn((300, 10), generator=torch.Generator().manual_seed(17)))


def test_streamed_capacity_assignment_agrees_with_jax(data, tmp_path):
    """From JAX's centroids, the port's streamed candidate cache (ragged,
    padded last chunk) and bidding rounds assign ≥ 0.99 of the rows as the
    JAX package's device assignment does, and padding never bids."""
    x, _ = data
    K = 8
    cap = int(1.25 * N / K)
    cents = np.array(jax_km.kmeans_centroids(jax.random.key(0), jnp.asarray(x), K, 10, impl="jnp"))
    want = jax_capacity_assign(x, cents, cap, impl="jnp", block=512, max_rounds=16, n_cand=4)
    st = pst.write_sharded(x, str(tmp_path / "s"), rows_per_shard=333)
    cand_idx, cand_d2 = streamed_candidates(st, torch.from_numpy(cents), 4, 400, 256)
    assert cand_idx.shape == (1600, 4)
    assign, free = capacity_rounds(cand_idx, cand_d2, K, cap, 16, n_real=N)
    assert (assign[N:] == -1).all()
    got, _ = force_place_host(st, cents, assign[:N].numpy().astype(np.int64), free.numpy().copy())
    assert np.bincount(got, minlength=K).max() <= cap
    assert np.mean(got == want) >= 0.99


# ---------------------------------------------------------------------------
# The port's own contracts: store ≡ array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("container", ["sharded", "store_dir", "memmap", "npy_path"])
def test_build_store_equals_build_array(data, containers, container):
    """Every index field of build(container) equals build(ndarray) with the
    same chunk_rows; a disk-backed input spills x_rows to a store."""
    x, _ = data
    want = IndexBuilder(CFG, device="cpu").build(x)
    builder = IndexBuilder(CFG, device="cpu")
    got = builder.build(pst.as_store(containers[container]))
    assert builder.report.strategy == "streamed" and set(builder.report.stage_rss_mb) == set(builder.report.stage_s)
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert pst.is_store(got.x_rows) and not pst.is_store(want.x_rows)
    np.testing.assert_array_equal(got.x_rows.materialize(), want.x_rows)
    assert got.fingerprint == want.fingerprint


def test_bf16_spill_of_bf16_rows_is_lossless(data, tmp_path):
    """Rows exact in bf16, stored and spilled in bf16, build the index the
    array of the same rows builds."""
    x, _ = data
    xb = pst.bf16_decode(pst.bf16_bits(x))
    cfg = CFG.replace(store_dtype="bfloat16")
    st = pst.write_sharded(x, str(tmp_path / "b"), rows_per_shard=500, dtype="bfloat16")
    got = IndexBuilder(cfg, device="cpu").build(st)
    want = IndexBuilder(cfg, device="cpu").build(xb)
    assert got.x_rows.dtype_name == "bfloat16"
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.x_rows.materialize(), want.x_rows)


@pytest.mark.parametrize("container", ["sharded", "store_dir", "memmap", "npy_path"])
def test_fit_store_equals_fit_array(array_fit, containers, container):
    got = NomadProjection(CFG, device="cpu").fit(containers[container])
    assert got.index_build_strategy == "streamed"
    np.testing.assert_array_equal(got.embedding, array_fit.embedding)
    assert got.losses == array_fit.losses


def test_chunking_depends_only_on_n_and_chunk_rows(data, tmp_path):
    """Two shard layouts of the same rows fit bit-equal at chunk_rows 0
    (the default chunk), and the streamed fit stays near the resident one."""
    x, _ = data
    cfg = CFG.replace(chunk_rows=0)
    a = NomadProjection(cfg, device="cpu").fit(pst.write_sharded(x, str(tmp_path / "a"), rows_per_shard=100))
    b = NomadProjection(cfg, device="cpu").fit(pst.write_sharded(x, str(tmp_path / "b"), rows_per_shard=1499))
    np.testing.assert_array_equal(a.embedding, b.embedding)
    resident = NomadProjection(cfg, device="cpu").fit(x)
    assert resident.index_build_strategy == "local"
    assert np.mean(resident.index.perm == a.index.perm) > 0.99


def test_streamed_resume_and_index_cache_sidecar(array_fit, containers, tmp_path, monkeypatch):
    """A streamed fit with checkpoint_dir caches its store-backed x_rows as
    the npz's .x_rows.npy sidecar; killed after epoch 0 and resumed, it
    equals the uninterrupted fit; the cache is reused, and its fingerprint
    of the store refuses other rows."""
    from repro_torch.core.strategy import LocalStrategy

    ckdir = str(tmp_path / "ck")
    cfg = CFG.replace(checkpoint_dir=ckdir, checkpoint_every_epochs=1)
    run_epoch = LocalStrategy.run_epoch

    def dies_at_1(self, theta, epoch, lr0, lr1):
        if epoch == 1:
            raise RuntimeError("killed at epoch 1")
        return run_epoch(self, theta, epoch, lr0, lr1)

    monkeypatch.setattr(LocalStrategy, "run_epoch", dies_at_1)
    with pytest.raises(RuntimeError, match="killed"):
        NomadProjection(cfg, device="cpu").fit(containers["sharded"])
    monkeypatch.setattr(LocalStrategy, "run_epoch", run_epoch)
    z = np.load(os.path.join(ckdir, "index.npz"))
    assert "x_rows_file" in z.files and "x_rows" not in z.files
    cached = load_index(os.path.join(ckdir, "index.npz"))
    np.testing.assert_array_equal(np.asarray(cached.x_rows), array_fit.index.x_rows)
    resumed = NomadProjection.from_checkpoint(ckdir, device="cpu").fit(containers["store_dir"])
    assert resumed.resumed and resumed.start_epoch == 1 and resumed.index_build_strategy == "cache"
    np.testing.assert_array_equal(resumed.embedding, array_fit.embedding)
    other = pst.write_sharded(np.ascontiguousarray(np.asarray(containers["memmap"])[::-1]),
                              str(tmp_path / "rev"), rows_per_shard=333)
    with pytest.warns(UserWarning, match="fingerprint"):
        again = NomadProjection(cfg.replace(n_epochs=1), device="cpu").fit(other)
    assert again.index_build_strategy == "streamed"


# ---------------------------------------------------------------------------
# Serving store queries on a streamed map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [512, 1024])
def test_store_queries_equal_array_queries(data, containers, tmp_path, microbatch):
    """transform(memmap | .npy path | store) ≡ transform(ndarray) bit for bit
    on a map whose x_rows is the streamed build's spill."""
    _, q = data
    est = NomadProjection(CFG, device="cpu")
    est.fit(containers["sharded"])
    server = est.map_server(microbatch=microbatch)
    path = str(tmp_path / "q.npy")
    np.save(path, q)
    want = server.transform(q, seed=3)
    for src in (np.load(path, mmap_mode="r"), path, pst.write_sharded(q, str(tmp_path / "qs"), rows_per_shard=300)):
        got = server.transform(src, seed=3)
        for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="dim"):
        server.transform(pst.ArrayStore(np.zeros((4, DIM + 1), np.float32)))


def test_frozen_map_from_store_backed_index(array_fit, containers):
    """A store-backed x_rows lands on the device as the array's would."""
    res = NomadProjection(CFG, device="cpu").fit(containers["sharded"])
    a = FrozenMap.from_fit(res, CFG, device="cpu")
    b = FrozenMap.from_fit(array_fit, CFG, device="cpu")
    assert torch.equal(a.x_rows, b.x_rows) and torch.equal(a.theta_rows, b.theta_rows)


def test_streamed_fit_quality_against_jax(tmp_path):
    """A streamed port fit and a streamed JAX fit of one store score within
    the side-by-side band (the frameworks draw different rows)."""
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    cfg = NomadConfig(n_points=2000, dim=16, n_clusters=4, n_neighbors=15, n_noise=32, n_exact_negatives=8,
                      batch_size=512, n_epochs=10, chunk_rows=512)
    port = NomadProjection(cfg, device="cpu").fit(pst.write_sharded(x, str(tmp_path / "p"), rows_per_shard=700))
    ref = JaxProjection(JaxConfig(**dataclasses.asdict(cfg), kernel_impl="jnp")).fit(
        jst.write_sharded(x, str(tmp_path / "j"), rows_per_shard=700))
    assert port.index_build_strategy == ref.index_build_strategy == "streamed"
    np_p = neighborhood_preservation(x, port.embedding, k=10, n_queries=500)
    np_r = neighborhood_preservation(x, ref.embedding, k=10, n_queries=500)
    rta_p = random_triplet_accuracy(x, port.embedding, 8000)
    rta_r = random_triplet_accuracy(x, ref.embedding, 8000)
    assert abs(np_p - np_r) <= SIDE_BY_SIDE_BAND["np10"], (np_p, np_r)
    assert abs(rta_p - rta_r) <= SIDE_BY_SIDE_BAND["rta"], (rta_p, rta_r)
