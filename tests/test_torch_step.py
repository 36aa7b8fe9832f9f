"""One SGD step: given the rows the JAX sampler draws from a fixed key, the
port's step moves θ like the JAX package's ``make_step_fn`` step, within
1e-5. Both start from one index (built by the JAX package) and one θ."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core import nomad as jax_nomad  # noqa: E402
from repro.index.build import IndexBuilder as JaxBuilder  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core import nomad  # noqa: E402
from repro_torch.core.strategy import LocalStrategy  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index.ann import index_from_arrays  # noqa: E402
from repro_torch.index.build import seeded_generator  # noqa: E402

CFG = NomadConfig(
    n_points=1500, dim=16, n_clusters=6, n_neighbors=8, n_noise=24,
    n_exact_negatives=6, batch_size=256, n_epochs=2,
)


@pytest.fixture(scope="module")
def state():
    x, _ = gaussian_mixture(CFG.n_points, CFG.dim, n_components=6, seed=3)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    jindex = JaxBuilder(jcfg, strategy="local").build(x)
    rows = jindex.n_clusters * jindex.capacity
    theta0 = np.random.default_rng(0).normal(0, 3, (rows, CFG.out_dim)).astype(np.float32)
    return jcfg, jindex, theta0


def _jax_idx(index):
    return {
        "knn_idx": jnp.asarray(index.knn_idx, jnp.int32),
        "knn_w": jnp.asarray(index.knn_w, jnp.float32),
        "counts": jnp.asarray(index.counts, jnp.int32),
        "cum_counts": jnp.asarray(np.cumsum(index.counts), jnp.int32),
    }


def test_local_means_match(state):
    _jcfg, jindex, theta0 = state
    want = jax_nomad.local_means(jnp.asarray(theta0), jnp.asarray(jindex.counts), jindex.capacity)
    got = nomad.local_means(torch.from_numpy(theta0), torch.from_numpy(jindex.counts), jindex.capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["nomad", "infonc"])
def test_step_moves_theta_like_jax(state, method):
    jcfg, jindex, theta0 = state
    jidx = _jax_idx(jindex)
    C, B = jcfg.cluster_capacity, jcfg.batch_size
    means = jax_nomad.local_means(jnp.asarray(theta0), jidx["counts"], C)
    counts_f = jidx["counts"].astype(jnp.float32)
    lr = jcfg.resolved_lr0()
    key = jax.random.key(11)
    want, want_loss = jax_nomad.make_step_fn(jcfg, method=method)(
        jnp.asarray(theta0), jidx, means, counts_f, lr, key
    )

    # the rows the JAX step drew from that key, by its own samplers
    k_head, k_neg = jax.random.split(key)
    rows, cl = jax_nomad.sample_points(k_head, B, jidx["cum_counts"], C)
    if method == "infonc":
        neg, _ = jax_nomad.sample_points(k_neg, B * jcfg.n_noise, jidx["cum_counts"], C)
        neg = neg.reshape(B, jcfg.n_noise)
    else:
        neg = jax_nomad.sample_in_cluster(k_neg, cl, jidx["counts"], C, jcfg.n_exact_negatives)

    strategy = LocalStrategy()
    theta = strategy.prepare(CFG, method, index_from_arrays(dataclasses.asdict(jindex)), theta0, "cpu")
    loss = nomad.step_update(
        theta, strategy.idx, torch.from_numpy(np.array(means)), strategy.idx["counts"].float(), lr,
        *(torch.from_numpy(np.asarray(a).astype(np.int64)) for a in (rows, cl, neg)),
        cfg=CFG, method=method,
    )
    assert not np.array_equal(np.asarray(want), theta0)  # the step moved θ
    np.testing.assert_allclose(theta.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)


def test_port_sampler_draws_valid_rows(state):
    """The port's own sampler: heads are real rows, spread over every cell;
    in-cell negatives are real rows of the head's cell."""
    _jcfg, jindex, theta0 = state
    strategy = LocalStrategy()
    strategy.prepare(CFG, "nomad", index_from_arrays(dataclasses.asdict(jindex)), theta0, "cpu")
    gen = seeded_generator(torch.device("cpu"), CFG.seed + 1, 0, 0)
    rows, cl, neg = nomad.sample_step_rows(gen, strategy.idx, CFG, "nomad")
    valid = torch.from_numpy(jindex.valid_mask)
    C = jindex.capacity
    assert rows.shape == (CFG.batch_size,) and neg.shape == (CFG.batch_size, CFG.n_exact_negatives)
    assert bool(valid[rows].all()) and bool(valid[neg].all())
    assert torch.equal(rows // C, cl) and bool((neg // C == cl[:, None]).all())
    assert set(cl.tolist()) == set(range(jindex.n_clusters))
    again = nomad.sample_step_rows(
        seeded_generator(torch.device("cpu"), CFG.seed + 1, 0, 0), strategy.idx, CFG, "nomad"
    )
    assert all(torch.equal(a, b) for a, b in zip((rows, cl, neg), again))
