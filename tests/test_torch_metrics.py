"""The port's quality metrics on the CPU: held to ``repro.metrics`` on the
same numpy inputs (exactly on integer-valued rows with duplicates, where
the tie order decides; within 0.01 on float data), then the reference's
own property cases on the port."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.metrics import map_stability as jax_map_stability  # noqa: E402
from repro.metrics import neighborhood_preservation as jax_np  # noqa: E402
from repro.metrics import random_triplet_accuracy as jax_rta  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.metrics import exact_knn, map_stability, neighborhood_preservation, random_triplet_accuracy  # noqa: E402


def _integer_rows(n, d, seed, high=3):
    """Integer-valued rows: many duplicates and exactly tied distances."""
    return np.random.default_rng(seed).integers(0, high, (n, d)).astype(np.float32)


@pytest.mark.parametrize("k,n_queries", [(5, 120), (10, 300), (10, 400)])
def test_neighborhood_preservation_exact_on_ties(k, n_queries):
    x, y = _integer_rows(400, 4, 0), _integer_rows(400, 2, 1)
    got = neighborhood_preservation(x, y, k=k, n_queries=n_queries, seed=2, device="cpu")
    assert got == jax_np(x, y, k=k, n_queries=n_queries, seed=2)


def test_neighborhood_preservation_blocks_and_tiny_n():
    """Ties across the blocks of the running best list, and N ≤ k (the
    missing neighbours are -1 or -2, as in the JAX package)."""
    from repro.metrics.neighborhood import _topk_neighbors as jax_topk
    from repro_torch.metrics.neighborhood import _topk_neighbors

    x = _integer_rows(300, 3, 3)
    want = np.asarray(jax_topk(x[:50], x, 12, block=64))
    got = _topk_neighbors(torch.from_numpy(x[:50]), torch.from_numpy(x), 12, block=64).numpy()
    np.testing.assert_array_equal(got, want)
    tiny, tiny_low = _integer_rows(6, 3, 4), _integer_rows(6, 2, 5)
    assert neighborhood_preservation(tiny, tiny_low, k=10, device="cpu") == jax_np(tiny, tiny_low, k=10)


def test_neighborhood_preservation_float_within_band():
    x, _ = gaussian_mixture(600, 16, n_components=5, seed=6)
    y = (x[:, :2] + np.random.default_rng(6).normal(0, 0.05, (600, 2))).astype(np.float32)
    got = neighborhood_preservation(x, y, k=10, n_queries=300, device="cpu")
    assert abs(got - jax_np(x, y, k=10, n_queries=300)) <= 0.01


def test_map_stability_matches_jax():
    a, b = _integer_rows(300, 2, 7), _integer_rows(300, 2, 8)
    assert map_stability(a, b, k=10, n_queries=300, device="cpu") == jax_map_stability(a, b, k=10, n_queries=300)
    rng = np.random.default_rng(9)
    c = rng.normal(0, 1, (300, 2)).astype(np.float32)
    d = (c + rng.normal(0, 0.3, c.shape)).astype(np.float32)
    assert abs(map_stability(c, d, n_queries=300, device="cpu") - jax_map_stability(c, d, n_queries=300)) <= 0.01


@pytest.mark.parametrize("seed", [0, 1])
def test_random_triplet_accuracy_matches_jax(seed):
    x, _ = gaussian_mixture(500, 8, n_components=4, seed=seed)
    y = _integer_rows(500, 2, seed)
    assert random_triplet_accuracy(x, y, 5000, seed=seed) == jax_rta(x, y, 5000, seed=seed)


def test_exact_knn_leaves_self_out():
    x = _integer_rows(200, 3, 10)
    q = np.arange(0, 200, 7)
    nb = exact_knn(x, q, 5, device="cpu")
    assert nb.shape == (q.size, 5) and not (nb == q[:, None]).any()
    d2 = ((x[q, None, :] - x[nb]) ** 2).sum(-1)
    assert (np.diff(d2, axis=1) >= 0).all()


# ---------------------------------------------------------------------------
# The reference's property cases (tests/test_metrics.py), on the port
# ---------------------------------------------------------------------------


def test_identity_scores_one():
    x, _ = gaussian_mixture(400, 8, seed=0)
    assert neighborhood_preservation(x, x.copy(), k=10, n_queries=200, device="cpu") == 1.0
    assert random_triplet_accuracy(x, x.copy(), 5000) == 1.0


def test_isometry_scores_one():
    x, _ = gaussian_mixture(300, 4, seed=1)
    y = x * 3.0 + 7.0  # distance-order preserving
    assert neighborhood_preservation(x, y, k=10, n_queries=150, device="cpu") == 1.0
    assert random_triplet_accuracy(x, y, 4000) == 1.0


def test_random_embedding_at_chance():
    x, _ = gaussian_mixture(500, 16, seed=2)
    y = np.random.default_rng(2).normal(0, 1, (500, 2)).astype(np.float32)
    assert neighborhood_preservation(x, y, k=10, n_queries=300, device="cpu") < 0.08  # chance k/N = 0.02
    assert 0.4 < random_triplet_accuracy(x, y, 10000) < 0.6


def test_corruption_monotonicity():
    x, _ = gaussian_mixture(400, 8, seed=3)
    rng = np.random.default_rng(3)
    scores = []
    for noise in (0.0, 0.5, 5.0):
        y = x[:, :2] + rng.normal(0, noise, (400, 2)).astype(np.float32)
        scores.append(random_triplet_accuracy(x, y, 8000))
    assert scores[0] >= scores[1] >= scores[2] - 0.02


def test_map_stability_permutation_invariant_and_monotone():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 1, (250, 2)).astype(np.float32)
    b = (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)
    p = rng.permutation(250)
    s = map_stability(a, b, k=10, n_queries=250, device="cpu")
    assert s == pytest.approx(map_stability(a[p], b[p], k=10, n_queries=250, device="cpu"), abs=1e-9)
    assert map_stability(a, a.copy(), k=10, n_queries=250, device="cpu") == 1.0
    scores = [map_stability(a, a + rng.normal(0, noise, a.shape).astype(np.float32), n_queries=250, device="cpu")
              for noise in (0.2, 1.0, 5.0)]
    assert 1.0 > scores[0] > scores[1] > scores[2]


def test_map_stability_rejects_row_count_mismatch():
    a = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError, match="same rows") as mine:
        map_stability(a, np.zeros((12, 2), np.float32), device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_map_stability(a, np.zeros((12, 2), np.float32))
    assert str(mine.value) == str(theirs.value)


def test_metrics_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((20, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        neighborhood_preservation(x, x)
