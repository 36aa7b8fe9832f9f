"""The port's local index build against the JAX package's, stage by stage,
all from the same centroids: k-means EM, capacity assignment, admission,
in-cell kNN with Eq. 6 weights, and the ``index.npz`` format both ways.
The three top-k sites (in-cell kNN, serving's query kNN, the candidate
pass) are held to ``jax.lax.top_k``'s order on data with ties."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.rank_model import edge_weights as jax_edge_weights  # noqa: E402
from repro.core.rank_model import rank_matrix as jax_rank_matrix  # noqa: E402
from repro.index import ann as jax_ann  # noqa: E402
from repro.index import kmeans as jax_km  # noqa: E402
from repro.index.build import IndexBuilder as JaxBuilder  # noqa: E402
from repro.index.build import _candidate_pass as jax_candidate_pass  # noqa: E402
from repro.index.build import capacity_assign_device  # noqa: E402
from repro.index.knn import batched_cluster_knn as jax_batched_cluster_knn  # noqa: E402
from repro.index.knn import query_cluster_knn as jax_query_cluster_knn  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.rank_model import edge_weights, rank_matrix  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index import ann, build, kmeans  # noqa: E402
from repro_torch.index import knn  # noqa: E402
from repro_torch.index.knn import batched_cluster_knn, query_cluster_knn  # noqa: E402
from repro_torch.kernels.capacity_admit.ops import capacity_admit  # noqa: E402

CFG = NomadConfig(
    n_points=3000, dim=16, n_clusters=8, n_neighbors=10, kmeans_iters=12,
    capacity_slack=1.1, build_block_rows=1024,
)
KMEANS_ATOL = 1e-5  # same assignments; only the order of the fp32 sums differs
AGREEMENT = 0.99


@pytest.fixture(scope="module")
def data():
    x, _ = gaussian_mixture(CFG.n_points, CFG.dim, n_components=5, seed=4)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    return x, jcfg, JaxBuilder(jcfg, strategy="local").build(x)


def test_kmeans_em_from_same_init(data):
    x, jcfg, _ = data
    key = jax.random.key(jcfg.seed)
    cents0 = np.array(jax_km.lsh_init_centroids(key, jnp.asarray(x), CFG.n_clusters))
    want = jax_km.kmeans_centroids(
        key, x, CFG.n_clusters, n_iters=CFG.kmeans_iters, tol=CFG.kmeans_tol,
        block=CFG.build_block_rows,
    )
    got = kmeans.kmeans_centroids(
        None, torch.from_numpy(x), CFG.n_clusters, CFG.kmeans_iters, CFG.kmeans_tol,
        block=CFG.build_block_rows, cents0=torch.from_numpy(cents0),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=KMEANS_ATOL)


def test_capacity_assignment_agrees(data):
    x, jcfg, jindex = data
    cents = jindex.centroids
    C = jcfg.cluster_capacity
    want = capacity_assign_device(
        x, cents, C, impl="jnp", block=CFG.build_block_rows,
        max_rounds=CFG.build_max_rounds, n_cand=CFG.build_candidates,
    )
    xt, ct = torch.from_numpy(x), torch.from_numpy(cents)
    cand_idx, cand_d2 = build.candidate_pass(xt, ct, CFG.build_candidates, CFG.build_block_rows)
    a, free = build.capacity_rounds(cand_idx, cand_d2, CFG.n_clusters, C, CFG.build_max_rounds)
    got, _ = build.force_place_host(x, cents, a.numpy().astype(np.int64), free.numpy().copy())
    assert np.mean(got == want) >= AGREEMENT
    assert np.bincount(got, minlength=CFG.n_clusters).max() <= C


@pytest.mark.parametrize("shape_idx", range(len(jax_registry.get("capacity_admit").check_shapes)))
def test_capacity_admit_equals_jax(shape_idx):
    spec = jax_registry.get("capacity_admit")
    args = spec.make_inputs(jax.random.key(shape_idx), spec.check_shapes[shape_idx])
    want = np.asarray(spec.ref(*args))
    got = capacity_admit(*(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_edge_weights_equal_on_same_distances(data):
    """Eq. 6 from one distance matrix: ranks are equal exactly, weights up
    to the ulp by which the two frameworks' fp32 ``exp`` may differ."""
    _x, _jcfg, jindex = data
    C, k = jindex.capacity, CFG.n_neighbors
    xb = jindex.x_rows[:C].astype(np.float32)
    valid = np.arange(C) < jindex.counts[0]
    d2 = np.sum((xb[:, None] - xb[None]) ** 2, -1) + (~(valid[:, None] & valid[None])) * 1e30
    knn = np.argsort(d2 + np.eye(C) * 1e30, 1, kind="stable")[:, :k].astype(np.int32)
    want = np.asarray(jax_edge_weights(jnp.asarray(d2, jnp.float32), jnp.asarray(knn), k, jnp.asarray(valid)))
    d2 = d2.astype(np.float32)
    got = edge_weights(torch.from_numpy(d2), torch.from_numpy(knn), k, torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        rank_matrix(torch.from_numpy(d2)).numpy(), np.asarray(jax_rank_matrix(jnp.asarray(d2)))
    )


def test_in_cell_knn_agrees(data):
    """Same cells (the JAX index's x_rows): kNN edge sets agree ≥ 0.99 and
    the weights of matched edges agree ≥ 0.99 (near-tie distances may
    order differently under the two frameworks' fp32 sums)."""
    _x, _jcfg, jindex = data
    K, C, k = jindex.n_clusters, jindex.capacity, CFG.n_neighbors
    blocks = torch.from_numpy(np.ascontiguousarray(jindex.x_rows.reshape(K, C, -1)))
    valid = torch.arange(C)[None, :] < torch.from_numpy(jindex.counts)[:, None]
    idx, w = batched_cluster_knn(blocks, valid, k)
    got_idx, got_w = build.finalize_knn(idx.numpy(), w.numpy(), K, C)
    real = jindex.valid_mask
    matched, same_w, total = 0, 0, 0
    for r in np.flatnonzero(real):
        want_e = dict(zip(jindex.knn_idx[r], jindex.knn_w[r]))
        got_e = dict(zip(got_idx[r], got_w[r]))
        common = set(want_e) & set(got_e)
        total += len(want_e)
        matched += len(common)
        same_w += sum(abs(want_e[j] - got_e[j]) <= 1e-6 for j in common)
    assert matched / total >= AGREEMENT
    assert same_w / matched >= AGREEMENT


def test_index_npz_round_trip_both_ways(data, tmp_path):
    x, _jcfg, jindex = data
    jpath, ppath = str(tmp_path / "jax_index.npz"), str(tmp_path / "port_index.npz")
    jax_ann.save_index(jindex, jpath)
    port = ann.load_index(jpath)
    ann.save_index(port, ppath)
    back = jax_ann.load_index(ppath)
    for f in ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jindex, f), err_msg=f)
        np.testing.assert_array_equal(getattr(back, f), getattr(jindex, f), err_msg=f)
    assert (port.capacity, port.n_points, port.fingerprint) == (jindex.capacity, jindex.n_points, jindex.fingerprint)
    assert (back.capacity, back.n_points, back.fingerprint) == (jindex.capacity, jindex.n_points, jindex.fingerprint)
    from_dict = ann.index_from_arrays(dataclasses.asdict(jindex))
    np.testing.assert_array_equal(from_dict.knn_idx, jindex.knn_idx)
    assert ann.data_fingerprint(x) == jax_ann.data_fingerprint(x)


def test_port_build_is_a_valid_index(data):
    """The port's own end-to-end build: capacity respected, every point
    placed once, edges in-cell and weighted only between real points."""
    x, _jcfg, jindex = data
    b = build.IndexBuilder(CFG, device="cpu")
    index = b.build(x)
    K, C = index.n_clusters, index.capacity
    assert set(b.report.stage_s) == {"kmeans", "assign", "stragglers", "permute", "knn"}
    assert index.counts.sum() == CFG.n_points and index.counts.max() <= C
    assert np.unique(index.perm).size == CFG.n_points and index.valid_mask[index.perm].all()
    np.testing.assert_array_equal(index.x_rows[index.perm], x)
    live = index.knn_w > 0
    rows = np.repeat(np.arange(K * C)[:, None], CFG.n_neighbors, 1)
    assert (index.knn_idx[live] // C == rows[live] // C).all()
    assert index.valid_mask[index.knn_idx[live]].all() and index.valid_mask[rows[live]].all()
    assert index.fingerprint == jindex.fingerprint


# ---------------------------------------------------------------------------
# Ties: every top-k site returns jax.lax.top_k's indices in its order
# ---------------------------------------------------------------------------


def _tied_rows(rng, n, dim, levels=3):
    """Integer-valued rows (their fp32 distances are exact in both
    frameworks, so many are equal), each drawn row duplicated once."""
    half = rng.integers(0, levels, (n - n // 2, dim)).astype(np.float32)
    return np.concatenate([half, half[: n // 2]])[rng.permutation(n)]


@pytest.mark.parametrize("way", ["smallest_k_by_sort", "smallest_k_by_topk"])
@pytest.mark.parametrize("case", ["integers", "signed_zeros", "padding"])
def test_smallest_k_is_jax_top_k(case, way):
    """Values, indices and order of ``jax.lax.top_k(-d, k)`` on 64 × 300
    integer-valued distances in [0, 4), k 15 (``torch.topk`` differs on
    every row here); with -0.0 among the zeros (JAX's total order puts it
    first); and with BIG padding on part of each row."""
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, (64, 300)).astype(np.float32)
    if case == "signed_zeros":
        d[(d == 0) & (rng.uniform(size=d.shape) < 0.5)] = -0.0
    elif case == "padding":
        d[:, 200:] += np.float32(1e30)
    want_v, want_i = jax.lax.top_k(-jnp.asarray(d), 15)
    got_v, got_i = getattr(knn, way)(torch.from_numpy(d), 15)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), (-np.asarray(want_v)).view(np.int32))


def test_in_cell_knn_ties_equal_jax():
    """``batched_cluster_knn`` on cells of duplicated integer rows (some
    padded): the JAX package's slots in its order, and its Eq. 6 weights."""
    rng = np.random.default_rng(1)
    Kc, C, D, k = 4, 48, 5, 10
    blocks = np.stack([_tied_rows(rng, C, D) for _ in range(Kc)])
    valid = np.arange(C)[None, :] < np.array([48, 40, 25, 11])[:, None]
    want_idx, want_w = jax_batched_cluster_knn(jnp.asarray(blocks), jnp.asarray(valid), k, impl="jnp")
    got_idx, got_w = batched_cluster_knn(torch.from_numpy(blocks), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=0)


def test_query_knn_ties_equal_jax():
    """Serving's ``query_cluster_knn``: queries that are copies of cell
    rows (and of each other) against cells of duplicated integer rows, one
    cell shorter than k: the same slots in the same order, d² and mask."""
    rng = np.random.default_rng(2)
    K, C, D, k = 3, 40, 4, 15
    blocks = np.stack([_tied_rows(rng, C, D) for _ in range(K)])
    counts = np.array([40, 33, 9], np.int32)
    own = rng.integers(0, K, 90).astype(np.int32)
    q = blocks[own, rng.integers(0, 9, 90)]
    q[1::3] = rng.integers(0, 3, (30, D))
    want = jax_query_cluster_knn(jnp.asarray(q), jnp.asarray(own), jnp.asarray(blocks), jnp.asarray(counts), k,
                                 block=32)
    got = query_cluster_knn(torch.from_numpy(q), torch.from_numpy(own), torch.from_numpy(blocks),
                            torch.from_numpy(counts), k, block=32)
    for label, g, w in zip(("slot", "d2", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=label)


def test_candidate_pass_ties_equal_jax():
    """The capacity candidates: duplicated integer centroids, rows at and
    between them: each row's R nearest centroids in the JAX pass's order,
    ties to the lower centroid."""
    rng = np.random.default_rng(3)
    cents = _tied_rows(rng, 64, 6)
    x = np.concatenate([cents[rng.integers(0, 64, 150)], rng.integers(0, 3, (150, 6)).astype(np.float32)])
    want_idx, want_d2 = jax_candidate_pass(jnp.asarray(x), jnp.asarray(cents), 12, "jnp", 128)
    got_idx, got_d2 = build.candidate_pass(torch.from_numpy(x), torch.from_numpy(cents), 12, 128)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_d2.numpy(), np.asarray(want_d2))
