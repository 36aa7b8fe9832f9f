"""The port's fit on the CPU: the quality bands of test_nomad_quality.py
(the multiscale band included), a side-by-side fit with the JAX package on
the same data, determinism, carrying the JAX package's index and θ across,
and the device rule."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.data.synthetic import hierarchical_mixture  # noqa: E402
from repro.metrics import neighborhood_preservation, random_triplet_accuracy  # noqa: E402
from repro.metrics.neighborhood import _topk_neighbors  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection, prepare_inputs  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture, mixture_centers  # noqa: E402
from repro_torch.index.ann import index_from_arrays  # noqa: E402
from repro_torch.index.build import IndexBuilder  # noqa: E402
from repro_torch.serve import MapServer  # noqa: E402

CFG = NomadConfig(
    n_points=5000, dim=32, n_clusters=8, n_neighbors=15, n_noise=32,
    n_exact_negatives=8, batch_size=512, n_epochs=25,
)
SMALL = CFG.replace(n_points=2000, dim=16, n_clusters=4, n_epochs=10)
# the two frameworks draw different rows (threefry vs Philox), so their
# fits differ; their scores must stay this close on the same data
SIDE_BY_SIDE_BAND = {"np10": 0.015, "rta": 0.04}


@pytest.fixture(scope="module")
def fitted():
    x, labels = gaussian_mixture(5000, 32, n_components=8, seed=0)
    return x, labels, NomadProjection(CFG, device="cpu").fit(x)


def test_quality_bands(fitted):
    x, labels, res = fitted
    emb = res.embedding
    assert emb.shape == (5000, 2) and np.isfinite(emb).all()
    assert res.losses[-1] < res.losses[0]
    np10 = neighborhood_preservation(x, emb, k=10, n_queries=500)
    assert np10 > 10 * (10 / 5000), np10
    rta = random_triplet_accuracy(x, emb, 10_000)
    assert rta > 0.6, rta
    nb = np.asarray(_topk_neighbors(jnp.asarray(emb[:500]), jnp.asarray(emb), 10))
    purity = np.mean(labels[nb] == labels[:500, None])
    assert purity > 0.9, purity


def test_multiscale_structure():
    """tests/test_nomad_quality.py's Fig. 4 analogue on the port: the same
    data, config and bar (super-cluster purity > 0.8 over 400 queries, 10
    neighbours)."""
    x, sup, _sub = hierarchical_mixture(4000, 24, n_super=4, n_sub=3, seed=3)
    cfg = CFG.replace(n_points=4000, dim=24, n_clusters=8, n_epochs=25)
    emb = NomadProjection(cfg, device="cpu").fit(x).embedding
    nb = np.asarray(_topk_neighbors(jnp.asarray(emb[:400]), jnp.asarray(emb), 10))
    sup_purity = np.mean(sup[nb] == sup[:400, None])
    assert sup_purity > 0.8, sup_purity


def test_side_by_side_with_jax_fit():
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    port = NomadProjection(SMALL, device="cpu").fit(x).embedding
    ref = JaxProjection(JaxConfig(**dataclasses.asdict(SMALL))).fit(x).embedding
    np_p = neighborhood_preservation(x, port, k=10, n_queries=500)
    np_r = neighborhood_preservation(x, ref, k=10, n_queries=500)
    rta_p = random_triplet_accuracy(x, port, 8000)
    rta_r = random_triplet_accuracy(x, ref, 8000)
    assert abs(np_p - np_r) <= SIDE_BY_SIDE_BAND["np10"], (np_p, np_r)
    assert abs(rta_p - rta_r) <= SIDE_BY_SIDE_BAND["rta"], (rta_p, rta_r)


def test_fit_deterministic():
    """Two fits from one seed, index build included, are bit-equal."""
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    cfg = SMALL.replace(n_epochs=3)
    r1 = NomadProjection(cfg, device="cpu").fit(x)
    r2 = NomadProjection(cfg, device="cpu").fit(x)
    np.testing.assert_array_equal(r1.index.knn_idx, r2.index.knn_idx)
    np.testing.assert_array_equal(r1.embedding, r2.embedding)
    assert set(r1.stage_s) == {"kmeans", "assign", "stragglers", "permute", "knn", "init", "epochs"}


def test_fit_takes_jax_index_and_theta():
    """The JAX package's index and θ step in the port: with no epochs the
    port returns exactly the JAX θ, unpermuted; with epochs it moves it."""
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    jax_est = JaxProjection(JaxConfig(**dataclasses.asdict(SMALL.replace(n_epochs=1))))
    jres = jax_est.fit(x)
    jindex = jres.index
    theta0 = np.zeros((jindex.n_clusters * jindex.capacity, 2), np.float32)
    theta0[jindex.perm] = jres.embedding
    index = index_from_arrays(dataclasses.asdict(jindex))
    still = NomadProjection(SMALL.replace(n_epochs=0), device="cpu").fit(x, index=index, theta0=theta0)
    np.testing.assert_array_equal(still.embedding, jres.embedding)
    assert still.index_build_strategy == "provided"
    moved = NomadProjection(SMALL.replace(n_epochs=2), device="cpu").fit(x, index=index, theta0=theta0)
    assert np.isfinite(moved.embedding).all() and not np.array_equal(moved.embedding, jres.embedding)


def test_infonc_baseline_runs():
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=2)
    res = NomadProjection(SMALL, method="infonc", device="cpu").fit(x)
    assert np.isfinite(res.embedding).all()
    assert random_triplet_accuracy(x, res.embedding, 8000) > 0.55


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NomadProjection(SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexBuilder(SMALL)
    assert NomadProjection(SMALL, device="cpu").device.type == "cpu"


def test_unported_options_raise():
    # the sharded strategies are ported (tests/test_torch_sharded.py); a
    # strategy neither package knows still raises, at the fit and the server
    from repro_torch.core.strategy import resolve_strategy

    with pytest.raises(ValueError, match="unknown strategy"):
        resolve_strategy("pmap", SMALL)
    with pytest.raises(ValueError, match="unknown serve_strategy"):
        MapServer(SimpleNamespace(cfg=SMALL, device=torch.device("cpu")), strategy="pmap")
    # chunk_rows > 0 is ported: the streamed build of an array equals the
    # streamed build of the same rows behind the store interface
    from repro_torch.data.store import ArrayStore

    x, _ = gaussian_mixture(600, 16, n_components=4, seed=2)
    cfg = SMALL.replace(n_points=600, chunk_rows=256)
    builder = IndexBuilder(cfg, device="cpu")
    a = builder.build(x)
    b = IndexBuilder(cfg, device="cpu").build(ArrayStore(x))
    assert builder.report.strategy == "streamed"
    for f in ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_mixture_centers_are_the_mixtures():
    """``mixture_centers`` from the same seed gives the centres the rows
    scatter around, so new queries of a fit's mixture share its centres."""
    x, labels = gaussian_mixture(400, 16, n_components=6, seed=4)
    centers = mixture_centers(np.random.default_rng(4), 6, 16)
    np.testing.assert_allclose(np.linalg.norm(centers, axis=1), 1.0, rtol=1e-12)
    nearest = np.argmin(((x[:, None, :] - centers[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(nearest, labels)


def test_prepare_inputs_gate():
    with pytest.raises(ValueError, match="float64"):
        prepare_inputs(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="non-finite"):
        prepare_inputs(np.full((4, 3), np.nan, np.float32))
    assert prepare_inputs(np.ones((4, 3), np.int64)).dtype == np.float32
