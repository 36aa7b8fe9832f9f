"""The port's serving path on the CPU: against the JAX package on the same
frozen map, and its own bit-equality contracts.

The frozen map comes from one JAX fit (``kernel_impl="jnp"``) at the size
of ``tests/test_serve.py``; the port freezes the same index and θ. Steps
that draw random numbers cannot match threefry bit for bit, so the JAX
side is given the port's draws (``nslot``) where a step is compared.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core import losses as jax_losses  # noqa: E402
from repro.core.cauchy import cauchy as jax_cauchy  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.index.knn import query_cluster_knn as jax_query_cluster_knn  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.serve import FrozenMap as JaxFrozenMap  # noqa: E402
from repro.serve import MapServer as JaxMapServer  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index.ann import index_from_arrays  # noqa: E402
from repro_torch.index.knn import query_cluster_knn  # noqa: E402
from repro_torch.kernels.kmeans_assign.ops import assign_nearest  # noqa: E402
from repro_torch.serve import FrozenMap, MapServer, TransformResult, resolve_serve_strategy  # noqa: E402
from repro_torch.serve import transform as tf  # noqa: E402

N, DIM, NQ = 1500, 16, 300
CFG = NomadConfig(
    n_points=N, dim=DIM, n_clusters=4, n_neighbors=10, n_noise=16, n_exact_negatives=4,
    batch_size=256, n_epochs=4, serve_microbatch=128, transform_steps=6,
)


@pytest.fixture(scope="module")
def data():
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    q, _ = gaussian_mixture(NQ, DIM, n_components=4, seed=7)
    return x, q


@pytest.fixture(scope="module")
def jax_map(data):
    """A JAX fit, frozen by both packages: (JAX FrozenMap, port FrozenMap)."""
    x, _ = data
    jcfg = JaxConfig(**dataclasses.asdict(CFG), kernel_impl="jnp")
    jres = JaxProjection(jcfg).fit(x)
    jfz = JaxFrozenMap.from_fit(jres, jcfg)
    theta = np.zeros((jres.index.n_clusters * jres.index.capacity, 2), np.float32)
    theta[jres.index.perm] = jres.embedding
    index = index_from_arrays(dataclasses.asdict(jres.index))
    return jfz, FrozenMap.from_index_theta(index, theta, CFG, device="cpu")


@pytest.fixture(scope="module")
def port_fit(data):
    x, _ = data
    est = NomadProjection(CFG, device="cpu")
    return est, est.fit(x)


# ---------------------------------------------------------------------------
# Against the JAX package, on the same frozen map
# ---------------------------------------------------------------------------


def test_frozen_map_matches_jax(jax_map):
    jfz, fz = jax_map
    np.testing.assert_array_equal(fz.inv_perm.numpy(), np.asarray(jfz.inv_perm))
    np.testing.assert_array_equal(fz.counts.numpy(), np.asarray(jfz.counts))
    np.testing.assert_allclose(fz.means.numpy(), np.asarray(jfz.means), rtol=1e-5, atol=1e-9)


def test_query_cluster_knn_matches_jax(jax_map, data):
    """Same slots, d² within 1e-5, given the same frozen blocks and cells."""
    jfz, fz = jax_map
    _, q = data
    own, _ = assign_nearest(torch.from_numpy(q), fz.centroids)
    k = CFG.n_neighbors
    slot, d2, valid = query_cluster_knn(torch.from_numpy(q), own, fz.x_blocks, fz.counts, k, block=64)
    K, C = jfz.n_clusters, jfz.capacity
    jslot, jd2, jvalid = jax_query_cluster_knn(
        jnp.asarray(q), jnp.asarray(own.numpy()), jfz.x_rows.reshape(K, C, DIM), jfz.counts, k, block=64
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)


def test_steps0_transform_matches_jax(jax_map, data):
    """The RNG-free transform (assign, kNN, Cauchy-weighted init): equal
    cells and neighbour ids, embedding and distances within 1e-5."""
    jfz, fz = jax_map
    _, q = data
    want = JaxMapServer(jfz, steps=0).transform(q, seed=0)
    got = MapServer(fz, steps=0).transform(q, seed=0)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.neighbor_ids, want.neighbor_ids)
    np.testing.assert_allclose(got.neighbor_dists, want.neighbor_dists, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.embedding, want.embedding, rtol=1e-5, atol=1e-5)


def test_neighbors_match_jax(jax_map, data):
    jfz, fz = jax_map
    _, q = data
    ids, dists = fz.neighbors(q[:50])
    jids, jdists = jfz.neighbors(q[:50])
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(dists, np.asarray(jdists), rtol=1e-5, atol=1e-5)
    one_ids, _ = fz.neighbors(q[0], k=3)
    np.testing.assert_array_equal(one_ids, ids[0, :3])


def _jax_frozen_step(jfz, theta, own, nb_theta, nb_w, nslot, valid, lr_t):
    """transform.py:159-175, composed from the JAX package's parts."""
    C, S = jfz.capacity, nslot.shape[1]
    n_noise = float(CFG.n_noise)
    p_cell = jfz.counts.astype(jnp.float32) / float(jfz.n_points)
    cell_w = n_noise * p_cell
    th_neg = jfz.theta_rows[own[:, None] * C + nslot]

    def loss_fn(th):
        m_tilde = jax_losses.nomad_mean_term(th, jfz.means, cell_w, own, "jnp")
        q_neg = jax_cauchy(th[:, None, :], th_neg)
        m_exact = (n_noise * p_cell[own] / S) * jnp.sum(q_neg, axis=-1)
        lb = jax_registry.dispatch("frozen_attract", th, nb_theta, nb_w, m_tilde + m_exact, impl="jnp")
        return jnp.sum(jnp.where(valid, lb, 0.0))

    loss, g = jax.value_and_grad(loss_fn)(theta)
    return theta - lr_t * g, loss


def test_frozen_step_matches_jax(jax_map, data):
    """One frozen step given the same negative slots: θ moves the same way
    within 1e-5 of the move, and the loss agrees."""
    jfz, fz = jax_map
    _, q = data
    B, k, S = 128, CFG.n_neighbors, CFG.n_exact_negatives
    own, nb_row, _, nb_valid = tf.assign_and_knn(fz, torch.from_numpy(q[:B]), k)
    nb_theta = fz.theta_rows[nb_row]
    nb_w = torch.where(nb_valid, torch.from_numpy(tf.rank_weight_table(k)), 0.0)
    theta0 = torch.from_numpy(MapServer(fz, steps=0).transform(q[:B]).embedding)
    rows = torch.arange(B, dtype=torch.int64)
    nslot = tf.sample_negative_slots(torch.full((B,), 3, dtype=torch.int64), rows, 0,
                                     torch.clamp_min(fz.counts[own], 1), S)
    valid = rows % 7 != 0
    lr_t = tf.annealed_lr(CFG.resolved_transform_lr(), 0, CFG.transform_steps)
    th1, loss = tf.frozen_step(theta0, fz, own, nb_theta, nb_w, nslot, valid, lr_t)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jth1, jloss = _jax_frozen_step(jfz, j(theta0), j(own).astype(jnp.int32), j(nb_theta), j(nb_w),
                                   j(nslot).astype(jnp.int32), j(valid), lr_t)
    want_move = np.asarray(jth1) - theta0.numpy()
    got_move = (th1 - theta0).numpy()
    assert np.abs(want_move).max() > 0
    np.testing.assert_allclose(got_move, want_move, rtol=1e-5, atol=1e-5 * np.abs(want_move).max())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


# ---------------------------------------------------------------------------
# The per-row random numbers
# ---------------------------------------------------------------------------


def test_negative_slots_per_row_and_in_range():
    """A row's draws depend on (seed, row, t) only: the same in any batch,
    in [0, cnt), near uniform, and different across seeds, rows and steps."""
    seeds = torch.tensor([0, 0, 5, 2**32 - 1, 7], dtype=torch.int64)
    rows = torch.tensor([0, 1, 1, 9, 2**31], dtype=torch.int64)
    cnt = torch.tensor([1, 3, 300, 17, 1000], dtype=torch.int64)
    full = tf.sample_negative_slots(seeds, rows, 4, cnt, 64)
    for i in range(5):
        one = tf.sample_negative_slots(seeds[i : i + 1], rows[i : i + 1], 4, cnt[i : i + 1], 64)
        assert torch.equal(one[0], full[i])
    assert (full >= 0).all() and (full < cnt[:, None]).all()
    assert not torch.equal(full[1], full[2])
    assert not torch.equal(full, tf.sample_negative_slots(seeds, rows, 5, cnt, 64))
    many = tf.sample_negative_slots(torch.zeros(4000, dtype=torch.int64), torch.arange(4000), 0,
                                    torch.full((4000,), 10, dtype=torch.int64), 4)
    freq = torch.bincount(many.reshape(-1), minlength=10).float() / many.numel()
    assert float((freq - 0.1).abs().max()) < 0.01


def test_counter_hash_stays_exact():
    """Every intermediate stays below 2^63: the hash of the largest inputs
    is a 32-bit value, the same through Python integers."""
    big = torch.tensor([2**32 - 1], dtype=torch.int64)
    h = int(tf.counter_hash(big, big, 2**32 - 1, big)[0])

    def mix(x):
        x = (((x >> 16) ^ x) * tf._MUL) & tf._M32
        x = (((x >> 16) ^ x) * tf._MUL) & tf._M32
        return (x >> 16) ^ x

    want = mix(2**32 - 1 ^ tf._SALT[0])
    for v, salt in zip((2**32 - 1,) * 3, tf._SALT[1:]):
        want = mix(want ^ v ^ salt)
    assert h == want and 0 <= h < 2**32


# ---------------------------------------------------------------------------
# The port's own contracts, bit for bit
# ---------------------------------------------------------------------------


def test_transform_deterministic_and_seeded(port_fit, data):
    est, _ = port_fit
    _, q = data
    a = est.transform(q, seed=0)
    assert a.shape == (NQ, 2) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, est.transform(q, seed=0))
    assert not np.array_equal(a, est.transform(q, seed=1))  # the in-cell negatives
    s0 = est.map_server(steps=0)
    np.testing.assert_array_equal(s0.transform(q, seed=0).embedding, s0.transform(q, seed=99).embedding)


def test_transform_microbatch_invariant(port_fit, data):
    est, _ = port_fit
    _, q = data
    a = est.map_server(microbatch=64).transform(q, seed=0)
    b = est.map_server(microbatch=256).transform(q, seed=0)
    np.testing.assert_array_equal(a.embedding, b.embedding)
    np.testing.assert_array_equal(a.neighbor_ids, b.neighbor_ids)
    assert len(a.batch_latency_s) == -(-NQ // 64)


def test_coalesced_mixed_seed_batch_equals_dedicated_calls(port_fit, data):
    """One batch holding rows of three requests (own seeds, own row ids)
    returns, row for row, what a dedicated transform per request does."""
    est, _ = port_fit
    _, q = data
    server = est.map_server()
    reqs = [(q[:50], 11), (q[50:90], 4), (q[90:120], 2**32 - 3)]
    B = server.batch_rows
    qb = np.zeros((B, DIM), np.float32)
    rows, seeds, valid = np.zeros(B, np.int64), np.zeros(B, np.int64), np.zeros(B, bool)
    at = 0
    for qr, seed in reqs:
        n = len(qr)
        qb[at : at + n], rows[at : at + n], seeds[at : at + n], valid[at : at + n] = qr, np.arange(n), seed, True
        at += n
    out = server.transform_batch(qb, rows, seeds, valid)
    at = 0
    for qr, seed in reqs:
        alone = server.transform(qr, seed=seed)
        np.testing.assert_array_equal(out.embedding[at : at + len(qr)], alone.embedding)
        np.testing.assert_array_equal(out.neighbor_ids[at : at + len(qr)], alone.neighbor_ids)
        at += len(qr)


def test_transform_never_mutates_theta(port_fit, data):
    est, res = port_fit
    _, q = data
    fz = est.map_server().frozen
    before = fz.theta_rows.clone()
    est.transform(q, seed=0)
    assert torch.equal(fz.theta_rows, before)
    np.testing.assert_array_equal(res.embedding, res.index.unpermute(fz.theta_rows.numpy()))


def test_return_neighbors_false_parity(port_fit, data):
    est, _ = port_fit
    _, q = data
    full = est.map_server().transform(q, seed=0)
    fast = est.map_server().transform(q, seed=0, return_neighbors=False)
    assert fast.neighbor_ids is None and fast.neighbor_dists is None
    np.testing.assert_array_equal(full.embedding, fast.embedding)
    np.testing.assert_array_equal(full.cells, fast.cells)


def test_training_rows_find_themselves(port_fit, data):
    """tests/test_serve.py's criterion: a training row sent as a query is
    its own nearest neighbour, and its steps=0 placement lies within its
    neighbour radius. Held on 50 rows the capacity bound left in their
    nearest cell: a row moved to another cell cannot find itself there."""
    est, res = port_fit
    x, _ = data
    cand = np.arange(200)
    home = res.index.perm[cand] // res.index.capacity
    take = cand[est.map_server().transform(x[cand], seed=0).cells == home][:50]
    assert take.size == 50
    r = est.map_server().transform(x[take], seed=0)
    assert (r.neighbor_dists[:, 0] < 1e-3).all() and (r.neighbor_ids[:, 0] == take).all()
    r0 = est.map_server(steps=0).transform(x[take], seed=0)
    gap = np.linalg.norm(r0.embedding - res.embedding[take], axis=1)
    radius = np.array([np.linalg.norm(res.embedding[ids[ids >= 0]] - res.embedding[i], axis=1).max()
                       for i, ids in zip(take, r0.neighbor_ids)])
    assert (gap <= radius + 1e-12).all()


def test_transform_result_fields(port_fit, data):
    est, _ = port_fit
    _, q = data
    r = est.map_server().transform(q, seed=0)
    assert isinstance(r, TransformResult) and r.n_queries == NQ and r.steps == CFG.transform_steps
    assert (r.cells >= 0).all() and (r.cells < CFG.n_clusters).all()
    assert r.neighbor_ids.shape == (NQ, CFG.n_neighbors)
    live = r.neighbor_ids >= 0
    assert (r.neighbor_ids[live] < N).all()
    d = np.where(live, r.neighbor_dists, np.inf)
    assert (np.diff(d, axis=1) >= -1e-6).all()
    assert len(r.batch_loss) == len(r.batch_latency_s) == -(-NQ // CFG.serve_microbatch)
    assert np.isfinite(r.p50_latency_s) and r.p99_latency_s >= r.p50_latency_s


def test_unported_serving_options_raise(port_fit, data, tmp_path):
    est, _ = port_fit
    _, q = data
    fz = est.map_server().frozen
    # "sharded" is ported (tests/test_torch_sharded.py); an unknown one raises
    with pytest.raises(ValueError, match="unknown serve_strategy"):
        MapServer(fz, strategy="pmap")
    assert resolve_serve_strategy("auto") == resolve_serve_strategy("local") == ("local", None)
    MapServer(fz, strategy="auto")  # local on one card
    # memmap and path queries are ported: they place as the array does
    path = str(tmp_path / "q.npy")
    np.save(path, q)
    want = MapServer(fz).transform(q, seed=0)
    for src in (np.load(path, mmap_mode="r"), path):
        got = MapServer(fz).transform(src, seed=0)
        np.testing.assert_array_equal(got.embedding, want.embedding)
        np.testing.assert_array_equal(got.neighbor_ids, want.neighbor_ids)
    with pytest.raises(ValueError, match="float64"):
        MapServer(fz).transform(q.astype(np.float64))
    with pytest.raises(RuntimeError, match="fitted map"):
        NomadProjection(CFG, device="cpu").transform(q)
