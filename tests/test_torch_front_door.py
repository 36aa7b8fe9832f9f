"""The port's front-door functions against the JAX package's, on the CPU:
``cauchy_pairwise``, the synthetic generators, ``kmeans_fit``,
``capacity_assign``, ``build_index`` and ``handle_for``.

Tolerances: ``cauchy_pairwise`` within 1e-6 (float32 products in another
order); the generators and the numpy oracle ``capacity_assign`` bit-equal;
the device assignment within the reference's own rule (≥ 0.99 of rows,
``tests/test_index_build.py``); ``kmeans_fit``'s partition against the
reference's up to relabelling on ≥ 0.99 of rows.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402

from repro.core.cauchy import cauchy_pairwise as jax_cauchy_pairwise  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.index.kmeans import capacity_assign as jax_capacity_assign  # noqa: E402
from repro.index.kmeans import kmeans_fit as jax_kmeans_fit  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core import cauchy_pairwise  # noqa: E402
from repro_torch.data import gaussian_mixture, hierarchical_mixture, swiss_roll  # noqa: E402
from repro_torch.index import (  # noqa: E402
    IndexBuilder,
    build_index,
    capacity_assign,
    capacity_assign_device,
    kmeans_fit,
)
from repro_torch.index.build import seeded_generator  # noqa: E402
from repro_torch.kernels.kmeans_assign.ops import assign_nearest_plain  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_dist2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (
        np.sum(a.astype(np.float32) ** 2, -1)[:, None]
        + np.sum(b.astype(np.float32) ** 2, -1)[None, :]
        - 2.0 * a.astype(np.float32) @ b.astype(np.float32).T
    )


@pytest.mark.parametrize("na,nb,d", [(50, 40, 2), (17, 33, 3), (64, 64, 16)])
def test_cauchy_pairwise_matches_jax(na, nb, d):
    rng = np.random.default_rng(na + nb + d)
    a = rng.normal(0, 2, (na, d)).astype(np.float32)
    b = rng.normal(0, 2, (nb, d)).astype(np.float32)
    got = cauchy_pairwise(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax_cauchy_pairwise(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (na, nb) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the same rows against themselves: affinity 1 on the diagonal, up to
    # the product form's float32 cancellation at ‖a‖² ≈ 4·d (d2 clamped at 0)
    np.testing.assert_allclose(np.diag(cauchy_pairwise(torch.from_numpy(a), torch.from_numpy(a)).numpy()), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("kw", [dict(n=1000, dim=16), dict(n=777, dim=5, n_super=3, n_sub=4, seed=3),
                                dict(n=64, dim=768, super_spread=0.5, sub_spread=0.1, seed=9)])
def test_hierarchical_mixture_bit_equal(kw):
    got = hierarchical_mixture(**kw)
    want = jax_synthetic.hierarchical_mixture(**kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(n=500), dict(n=300, dim=3, noise=0.1, seed=2), dict(n=256, dim=10, seed=4)])
def test_swiss_roll_bit_equal(kw):
    got = swiss_roll(**kw)
    want = jax_synthetic.swiss_roll(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,k,d,slack,rounds", [(400, 7, 8, 1.2, 12), (96, 8, 4, 1.0, 12), (300, 3, 5, 1.5, 1)])
def test_capacity_assign_bit_equal_and_device_agrees(n, k, d, slack, rounds):
    rng = np.random.default_rng(n + k)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    cents = rng.normal(0, 1, (k, d)).astype(np.float32)
    cap = int(np.ceil(slack * n / k))
    got = capacity_assign(_np_dist2, x, cents, cap, max_rounds=rounds)
    want = jax_capacity_assign(_np_dist2, x, cents, cap, max_rounds=rounds)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the port's device assignment follows the same rounds (the reference's rule)
    dev = capacity_assign_device(x, cents, cap, device="cpu")
    assert float(np.mean(dev == got)) >= 0.99
    counts = np.bincount(dev, minlength=k)
    assert (counts <= cap).all() and counts.sum() == n


def test_capacity_assign_raises_without_room():
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(RuntimeError, match="total capacity"):
        capacity_assign(_np_dist2, x, np.zeros((2, 2), np.float32), 4)


@pytest.mark.parametrize("seed,k", [(0, 8), (3, 16), (5, 5)])
def test_kmeans_fit_assign_is_nearest_of_its_centroids(seed, k):
    x, _ = gaussian_mixture(1500, 12, n_components=k, seed=seed)
    cents, assign, counts = kmeans_fit(seed, x, k, device="cpu")
    assert cents.shape == (k, 12) and cents.dtype == torch.float32
    assert assign.shape == (1500,) and assign.dtype == torch.int32
    assert counts.dtype == torch.float32 and int(counts.sum()) == 1500
    np.testing.assert_array_equal(counts.numpy(), np.bincount(assign.numpy(), minlength=k))
    # the plain E-step's argmin: the lowest index among equal float32 distances
    want, _ = assign_nearest_plain(torch.from_numpy(x), cents)
    assert torch.equal(assign, want)
    # and nearest in float64 too, up to float32 rounding of the distances
    d2 = ((x.astype(np.float64)[:, None, :] - cents.numpy().astype(np.float64)[None]) ** 2).sum(-1)
    picked = d2[np.arange(1500), assign.numpy()]
    assert np.all(picked <= d2.min(1) + 1e-5 * (1.0 + d2.min(1)))
    # a generator is taken as it is: the build's seeded generator is the int seed's
    again = kmeans_fit(seeded_generator(torch.device("cpu"), seed), x, k, device="cpu")
    for a, b in zip((cents, assign, counts), again):
        assert torch.equal(a, b)


def test_kmeans_fit_ties_go_to_the_lowest_centroid():
    # integer rows, each exactly halfway between two centroids after EM:
    # one EM step from symmetric data keeps the centroids at ±1, and the
    # middle rows (0) are equidistant from both
    x = np.array([[-1.0], [-1.0], [0.0], [1.0], [1.0]] * 4, np.float32)
    _, assign, counts = kmeans_fit(0, x, 2, device="cpu")
    a = assign.numpy()
    mid = x[:, 0] == 0.0
    assert len(set(a[mid].tolist())) == 1  # every tie goes one way
    assert int(counts.sum()) == x.shape[0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kmeans_fit_partition_matches_jax(seed):
    """The two packages draw their LSH planes from different generators, so
    from K = 3 up their inits can settle in different local minima of the
    same data (both valid); two separated components have one partition,
    which both must find."""
    x, _ = gaussian_mixture(2000, 16, n_components=2, seed=seed)
    _, assign, _ = kmeans_fit(seed, x, 2, device="cpu")
    _, ja, _ = jax_kmeans_fit(jax.random.key(seed), x, 2, impl="jnp")
    c = np.zeros((2, 2))
    np.add.at(c, (assign.numpy(), np.asarray(ja)), 1)
    r, col = linear_sum_assignment(-c)
    assert c[r, col].sum() / x.shape[0] >= 0.99


CFG = NomadConfig(n_points=1500, dim=12, n_clusters=6, n_neighbors=5)


@pytest.fixture(scope="module")
def built():
    x, _ = gaussian_mixture(1500, 12, n_components=6, seed=5)
    return x, build_index(x, CFG, device="cpu")


def test_build_index_equals_index_builder(built):
    x, idx = built
    want = IndexBuilder(CFG, device="cpu").build(x)
    for f in ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(want, f))
    assert (idx.capacity, idx.n_points, idx.fingerprint) == (want.capacity, want.n_points, want.fingerprint)
    for strategy in ("local", "auto"):
        np.testing.assert_array_equal(build_index(x, CFG, device="cpu", strategy=strategy).perm, want.perm)


def test_build_index_layout_and_component_property(built):
    """``tests/test_index.py``'s layout test on the port's index."""
    x, idx = built
    K, C = idx.n_clusters, idx.capacity
    assert idx.perm.shape == (1500,)
    assert len(set(idx.perm.tolist())) == 1500
    valid = idx.valid_mask
    assert valid[idx.perm].all()
    assert int(valid.sum()) == 1500
    np.testing.assert_allclose(idx.x_rows[idx.perm], x, rtol=1e-6)
    cluster_of = np.arange(K * C) // C
    live = idx.knn_w > 0
    head_cluster = np.broadcast_to(cluster_of[:, None], idx.knn_idx.shape)
    tail_cluster = cluster_of[idx.knn_idx]
    assert (head_cluster[live] == tail_cluster[live]).all()
    np.testing.assert_array_equal(idx.counts, valid.reshape(K, C).sum(1))


@pytest.mark.parametrize("strategy", ["sharded", "hierarchical"])
def test_build_index_refuses_multi_device(strategy):
    """The sharded build is ported: on the one-slot pool it is the local
    build bit for bit. "hierarchical" names a fit strategy, not a build's,
    and raises."""
    x, _ = gaussian_mixture(100, 4, n_components=2, seed=0)
    cfg = NomadConfig(n_points=100, dim=4, n_clusters=2, n_neighbors=3)
    if strategy == "hierarchical":
        with pytest.raises(ValueError, match="unknown build_strategy"):
            build_index(x, cfg, device="cpu", strategy=strategy)
        return
    got, want = build_index(x, cfg, device="cpu", strategy=strategy), build_index(x, cfg, device="cpu")
    for f in ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_handle_for():
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.serve import FrozenMap
    from repro_torch.service import MapService
    from repro_torch.service.core import handle_for

    cfg = NomadConfig(n_points=300, dim=6, n_clusters=3, n_neighbors=4, n_noise=8, n_exact_negatives=4,
                      batch_size=64, n_epochs=1, serve_microbatch=32, transform_steps=2)
    x, _ = gaussian_mixture(300, 6, n_components=3, seed=0)
    est = NomadProjection(cfg, device="cpu")
    est.fit(x)
    svc = MapService(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no active map"):
            handle_for(svc)
        h0 = svc.registry.add(FrozenMap.from_fit(est._fit_result, cfg, device="cpu"))
        h1 = svc.registry.add(FrozenMap.from_fit(est._fit_result, cfg, device="cpu"), activate=False)
        assert handle_for(svc) is svc.registry.get() is h0
        assert handle_for(svc, h1.version) is h1
        assert handle_for(svc, h0.version) is h0
    finally:
        svc.close()
