"""``NomadProjection.partial_fit`` on the port, on the CPU: the JAX
package's partial_fit contracts (tests/test_partial_fit.py, all but the
service registry's), side by side with the JAX partial_fit on the same
data, a lineage grown across the two packages, store ≡ array growth,
place-only ≡ transform, and the fit's event API."""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.serve import FrozenMap as JaxFrozenMap  # noqa: E402
from repro.serve import MapServer as JaxMapServer  # noqa: E402
from repro_torch.checkpoint import VERSIONS_FILE, MapLineage  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.core.strategy import FitCallbacks, LocalStrategy, PartialRefineStrategy  # noqa: E402
from repro_torch.data.store import ShardedStore, write_sharded  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.metrics import map_stability, neighborhood_preservation  # noqa: E402
from repro_torch.serve import FrozenMap, MapServer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(n, *, dim=8, clusters=4, ckdir="", epochs=4, refine=2, seed=0, **kw):
    return NomadConfig(
        n_points=n, dim=dim, n_clusters=clusters, n_neighbors=5, n_noise=8, n_exact_negatives=4,
        batch_size=256, n_epochs=epochs, partial_refine_epochs=refine, strategy="local",
        build_strategy="local", seed=seed, checkpoint_dir=ckdir, **kw,
    )


def est_for(cfg):
    return NomadProjection(cfg, device="cpu")


def separated(n_per, n_modes, dim, scale, seed=0, which=None):
    """Modes 50 units apart: appends aimed at ``which`` stay in its cells."""
    rng = np.random.default_rng(seed)
    centers = np.eye(n_modes, dim, dtype=np.float32) * 50.0
    modes = [which] * n_per if which is not None else list(range(n_modes)) * n_per
    labels = np.asarray(sorted(modes))
    return (centers[labels] + rng.normal(0, scale, (len(labels), dim))).astype(np.float32)


def walk(root):
    return sorted(os.path.join(r, f) for r, _d, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def grown():
    """One fit → partial_fit pair shared by the invariant tests."""
    x, _ = gaussian_mixture(600, 8, n_components=4, seed=0)
    y, _ = gaussian_mixture(150, 8, n_components=4, seed=1)
    est = est_for(make_cfg(600))
    base = est.fit(x)
    pf = est.partial_fit(y)
    return x, y, base, pf, est


# ---------------------------------------------------------------------------
# The JAX package's partial_fit contracts
# ---------------------------------------------------------------------------


def test_append_invariants(grown):
    x, y, base, pf, _ = grown
    idx = pf.index
    n = len(x) + len(y)
    assert pf.n_points == idx.n_points == n
    assert pf.embedding.shape[0] == n and np.isfinite(pf.embedding).all()
    assert idx.capacity == base.index.capacity  # growth is new cells, never wider ones
    k2 = idx.counts.shape[0]
    assert int(idx.counts.sum()) == n == len(idx.perm)
    assert (idx.counts <= idx.capacity).all()
    assert len(np.unique(idx.perm)) == n
    assert idx.perm.min() >= 0 and idx.perm.max() < k2 * idx.capacity
    np.testing.assert_array_equal(np.asarray(idx.x_rows)[idx.perm], np.vstack([x, y]))
    assert idx.knn_idx.min() >= 0 and idx.knn_idx.max() < k2 * idx.capacity
    assert pf.losses and np.isfinite(pf.losses).all()
    assert set(pf.stage_s) == {"place", "admit", "patch_knn", "patch_rows", "refine"}


def test_old_rows_keep_their_neighborhoods(grown):
    x, _y, base, pf, _ = grown
    stab = map_stability(base.embedding, pf.embedding[: len(x)], k=10, n_queries=600, device="cpu")
    assert stab > 0.5, stab


def test_noop_partial_fit_bit_identical(tmp_path):
    """Growing by zero rows changes no artifact bit and writes nothing."""
    ckdir = str(tmp_path / "ck")
    x, _ = gaussian_mixture(400, 8, n_components=4, seed=2)
    est = est_for(make_cfg(400, ckdir=ckdir))
    base = est.fit(x)
    before = walk(ckdir)
    pf = est.partial_fit(np.zeros((0, 8), np.float32))
    assert pf.n_new == 0 and pf.version == ""
    np.testing.assert_array_equal(pf.embedding, base.embedding)
    np.testing.assert_array_equal(np.asarray(pf.index.x_rows), np.asarray(base.index.x_rows))
    np.testing.assert_array_equal(pf.index.perm, base.index.perm)
    assert walk(ckdir) == before
    assert not os.path.exists(os.path.join(ckdir, VERSIONS_FILE))


def test_unaffected_cells_bit_identical():
    """An append aimed at one mode must not move rows anywhere else."""
    x = separated(100, 8, 8, 0.5, seed=3)
    y = separated(40, 8, 8, 0.5, seed=4, which=0)
    est = est_for(make_cfg(800, clusters=8, seed=3))
    base = est.fit(x)
    pf = est.partial_fit(y)

    cap = base.index.capacity
    affected = set(np.asarray(pf.affected_cells).tolist())
    unaffected = [c for c in range(base.index.counts.shape[0]) if c not in affected]
    assert unaffected, "append touched every cell: test data not separated"
    old_x, new_x = np.asarray(base.index.x_rows), np.asarray(pf.index.x_rows)
    for c in unaffected:
        lo, hi = c * cap, (c + 1) * cap
        np.testing.assert_array_equal(new_x[lo:hi], old_x[lo:hi])
        np.testing.assert_array_equal(pf.index.knn_idx[lo:hi], base.index.knn_idx[lo:hi])
        np.testing.assert_array_equal(pf.index.knn_w[lo:hi], base.index.knn_w[lo:hi])
    ids = np.flatnonzero(~np.isin(base.index.perm // cap, np.asarray(pf.affected_cells)))
    assert ids.size > 0
    np.testing.assert_array_equal(pf.index.perm[ids], base.index.perm[ids])
    np.testing.assert_array_equal(pf.embedding[ids], base.embedding[ids])


def test_overflow_splits_and_stays_capacity_bounded():
    """Appending a whole mode's worth of rows must split, not overflow."""
    x = separated(80, 4, 8, 0.5, seed=5)
    y = separated(120, 4, 8, 0.5, seed=6, which=1)
    est = est_for(make_cfg(320, clusters=4, seed=5))
    base = est.fit(x)
    pf = est.partial_fit(y)
    assert pf.n_split_cells >= 1 and pf.n_new_cells >= 1
    assert pf.index.counts.shape[0] > base.index.counts.shape[0]
    assert (pf.index.counts <= pf.index.capacity).all()
    assert len(np.unique(pf.index.perm)) == 440
    np.testing.assert_array_equal(np.asarray(pf.index.x_rows)[pf.index.perm], np.vstack([x, y]))


QUALITY = dict(dim=16, clusters=8, epochs=8, refine=3, seed=7)


@pytest.fixture(scope="module")
def quality_data():
    x, _ = gaussian_mixture(1000, 16, n_components=8, seed=7)
    y, _ = gaussian_mixture(200, 16, n_components=8, seed=8)
    return x, y


@pytest.fixture(scope="module")
def port_quality(quality_data):
    x, y = quality_data
    est = est_for(make_cfg(1000, **QUALITY))
    base = est.fit(x)
    return base, est.partial_fit(y)


def test_quality_matches_joint_refit(quality_data, port_quality):
    """fit(X) + partial_fit(Y) ≈ fit(X ∥ Y) on the old rows."""
    x, y = quality_data
    _base, pf = port_quality
    joint = est_for(make_cfg(1200, **QUALITY)).fit(np.vstack([x, y]))
    np_partial = neighborhood_preservation(x, pf.embedding[:1000], k=10, n_queries=500, device="cpu")
    np_joint = neighborhood_preservation(x, joint.embedding[:1000], k=10, n_queries=500, device="cpu")
    assert np_partial >= np_joint - 0.05, (np_partial, np_joint)


def test_partial_fit_deterministic():
    x, _ = gaussian_mixture(400, 8, n_components=4, seed=9)
    y, _ = gaussian_mixture(100, 8, n_components=4, seed=10)
    runs = []
    for _ in range(2):
        est = est_for(make_cfg(400, seed=9))
        est.fit(x)
        runs.append(est.partial_fit(y))
    np.testing.assert_array_equal(runs[0].embedding, runs[1].embedding)
    np.testing.assert_array_equal(runs[0].index.perm, runs[1].index.perm)
    assert runs[0].losses == runs[1].losses


def test_partial_fit_before_fit_raises(tmp_path):
    est = est_for(make_cfg(100, ckdir=str(tmp_path / "empty")))
    with pytest.raises((RuntimeError, ValueError, FileNotFoundError)):
        est.partial_fit(np.zeros((5, 8), np.float32))
    with pytest.raises(RuntimeError):
        est_for(make_cfg(100)).partial_fit(np.zeros((5, 8), np.float32))


def test_lineage_chain_across_processes(tmp_path):
    """fit → partial_fit → (a new estimator from disk) → partial_fit: the
    versions.json chain records parentage and every version dir serves."""
    ckdir = str(tmp_path / "ck")
    x, _ = gaussian_mixture(400, 8, n_components=4, seed=11)
    y1, _ = gaussian_mixture(100, 8, n_components=4, seed=12)
    y2, _ = gaussian_mixture(80, 8, n_components=4, seed=13)

    est = est_for(make_cfg(400, ckdir=ckdir, seed=11))
    est.fit(x)
    pf1 = est.partial_fit(y1)
    assert pf1.version == "v1" and pf1.parent_version == "v0" and pf1.checkpoint_dir
    assert "version" in pf1.stage_s

    est2 = NomadProjection.from_checkpoint(ckdir, device="cpu")  # a fresh process's view
    pf2 = est2.partial_fit(y2)
    assert pf2.parent_version == pf1.version and pf2.n_points == 580

    lin = MapLineage(ckdir)
    versions = lin.load()
    assert [v.kind for v in versions] == ["fit", "partial_fit", "partial_fit"]
    assert versions[0].dirname == "."  # the base fit is v0, in the root
    assert versions[1].parent == versions[0].name and versions[2].parent == versions[1].name
    assert len({v.fingerprint for v in versions}) == 3
    assert [v.n_points for v in versions] == [400, 500, 580]
    for v, n in zip(versions, (400, 500, 580)):
        assert FrozenMap.from_checkpoint(v.path, device="cpu").n_points == n
    assert lin.resolve(None).name == versions[2].name
    # the grown estimator serves the grown map: ≡ the version dir's frozen map
    q = y2[:16] + 0.01
    want = MapServer(FrozenMap.from_checkpoint(versions[2].path, device="cpu")).transform(q, seed=3)
    np.testing.assert_array_equal(est2.transform(q, seed=3), want.embedding)


def test_store_backed_rows_patch(tmp_path):
    """A store-backed corpus grows by patching shards, never materialising
    them, into a store the version directory owns."""
    store_dir, ckdir = str(tmp_path / "corpus"), str(tmp_path / "ck")
    x, _ = gaussian_mixture(400, 8, n_components=4, seed=16)
    y, _ = gaussian_mixture(120, 8, n_components=4, seed=17)
    write_sharded(x, store_dir)
    est = est_for(make_cfg(400, ckdir=ckdir, seed=16, chunk_rows=128))
    est.fit(store_dir)
    pf = est.partial_fit(y)
    assert isinstance(pf.index.x_rows, ShardedStore)
    np.testing.assert_array_equal(pf.index.x_rows.materialize()[pf.index.perm], np.vstack([x, y]))
    assert pf.checkpoint_dir and os.path.isdir(pf.checkpoint_dir)
    assert os.path.commonpath([os.path.abspath(pf.index.x_rows.path), os.path.abspath(pf.checkpoint_dir)]) == \
        os.path.abspath(pf.checkpoint_dir)


def test_refine_zero_is_place_only():
    x, _ = gaussian_mixture(300, 8, n_components=4, seed=18)
    y, _ = gaussian_mixture(60, 8, n_components=4, seed=19)
    est = est_for(make_cfg(300, seed=18))
    base = est.fit(x)
    pf = est.partial_fit(y, refine_epochs=0)
    assert pf.refine_epochs == 0 and pf.losses == []
    np.testing.assert_array_equal(pf.embedding[:300], base.embedding)


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


def test_place_only_equals_transform(grown):
    """With no refinement the new rows sit where the frozen map's transform
    placed them, bit for bit."""
    x, y, base, _pf, _ = grown
    est = est_for(make_cfg(600))
    est.fit(x)
    want = est.map_server().transform(y, seed=5).embedding
    pf = est.partial_fit(y, refine_epochs=0, seed=5)
    np.testing.assert_array_equal(pf.embedding[600:], want)
    np.testing.assert_array_equal(pf.embedding[:600], base.embedding)


def test_store_fit_and_grow_equals_array(tmp_path):
    """A store-backed fit and grow (chunk_rows set, float32 store) equals the
    array fit and grow, bit for bit."""
    x, _ = gaussian_mixture(500, 8, n_components=4, seed=20)
    y, _ = gaussian_mixture(140, 8, n_components=4, seed=21)
    cfg = make_cfg(500, seed=20, chunk_rows=128)
    write_sharded(x, str(tmp_path / "st"), rows_per_shard=97)
    a, b = est_for(cfg), est_for(cfg.replace(checkpoint_dir=str(tmp_path / "ck")))
    a.fit(x)
    b.fit(str(tmp_path / "st"))
    pa, pb = a.partial_fit(y), b.partial_fit(y)
    assert isinstance(pb.index.x_rows, ShardedStore) and pa.n_split_cells == pb.n_split_cells
    np.testing.assert_array_equal(pa.embedding, pb.embedding)
    np.testing.assert_array_equal(np.asarray(pa.index.x_rows), pb.index.x_rows.materialize())
    for f in ("perm", "counts", "centroids", "knn_idx", "knn_w"):
        np.testing.assert_array_equal(getattr(pa.index, f), getattr(pb.index, f), err_msg=f)


def test_capacity_mismatch_raises(grown):
    x, y, _base, _pf, _ = grown
    est = est_for(make_cfg(600))
    est.fit(x)
    est.cfg = est.cfg.replace(capacity_slack=2.0)
    with pytest.raises(ValueError, match="capacity"):
        est.partial_fit(y)


def test_without_a_card_partial_fit_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NomadProjection(make_cfg(100)).partial_fit(np.zeros((5, 8), np.float32))


def test_refinement_touches_only_affected_rows(grown):
    """θ rows outside the affected cells never pass through a scatter."""
    _x, _y, _base, pf, est = grown
    idx = pf.index
    C = idx.capacity
    theta0 = np.zeros((idx.n_clusters * C, 2), np.float32)
    theta0[idx.perm] = pf.embedding
    aff = pf.affected_cells[:2]
    s = PartialRefineStrategy(aff)
    theta = s.prepare(est.cfg, "nomad", idx, theta0, torch.device("cpu"))
    theta, loss = s.run_epoch(theta, 0, 1.0, 0.5)
    out = ~np.isin(np.arange(theta0.shape[0]) // C, aff)
    assert np.isfinite(loss)
    np.testing.assert_array_equal(theta.numpy()[out], theta0[out])
    assert not np.array_equal(theta.numpy()[~out], theta0[~out])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


SIDE_SEEDS = (7, 8, 9)


@pytest.fixture(scope="module")
def jax_grown(tmp_path_factory, quality_data):
    """The JAX fit + partial_fit of the quality data for each seed of
    SIDE_SEEDS, the first written as a lineage."""
    x, y = quality_data
    root = str(tmp_path_factory.mktemp("jax_lineage"))
    runs = []
    for seed in SIDE_SEEDS:
        cfg = make_cfg(1000, ckdir=root if not runs else "", **dict(QUALITY, seed=seed))
        est = JaxProjection(JaxConfig(**dataclasses.asdict(cfg)))
        runs.append((est.fit(x), est.partial_fit(y)))
    return root, runs


def test_side_by_side_with_jax_partial_fit(quality_data, port_quality, jax_grown):
    """The two frameworks draw other rows, so their maps differ: over three
    seeds, the old rows' mean NP@10 and the mean stability of the map must
    stay within 0.05 of the JAX package's. One seed is too few: this test's
    readings on the CPU (seeds 7, 8, 9) were stability 0.7202, 0.7392,
    0.7636 for the port and 0.8210, 0.7040, 0.7462 for the JAX package,
    whose own seed-to-seed spread (0.117) exceeds the largest gap between
    the two on one seed (0.101 at seed 7); NP@10 0.1042, 0.1072, 0.1132
    against 0.1016, 0.1058, 0.1094. Each seed's gap is also held within the
    JAX package's own spread over the seeds plus 0.05, so the band on the
    means rests on a spread measured in the same run."""
    x, y = quality_data
    port = [port_quality] + [
        (lambda est: (est.fit(x), est.partial_fit(y)))(est_for(make_cfg(1000, **dict(QUALITY, seed=seed))))
        for seed in SIDE_SEEDS[1:]
    ]

    def scores(runs):
        np10 = [neighborhood_preservation(x, pf.embedding[:1000], k=10, n_queries=500, device="cpu")
                for _b, pf in runs]
        stab = [map_stability(b.embedding, pf.embedding[:1000], k=10, n_queries=500, device="cpu")
                for b, pf in runs]
        return np.array(np10), np.array(stab)

    (np_p, st_p), (np_j, st_j) = scores(port), scores(jax_grown[1])
    print({"seeds": SIDE_SEEDS, "np10_port": np_p.tolist(), "np10_jax": np_j.tolist(),
           "stability_port": st_p.tolist(), "stability_jax": st_j.tolist()})
    assert abs(np_p.mean() - np_j.mean()) <= 0.05, (np_p, np_j)
    assert abs(st_p.mean() - st_j.mean()) <= 0.05, (st_p, st_j)
    assert np.abs(np_p - np_j).max() <= np.ptp(np_j) + 0.05, (np_p, np_j)
    assert np.abs(st_p - st_j).max() <= np.ptp(st_j) + 0.05, (st_p, st_j)


def test_lineage_grows_across_frameworks(quality_data, jax_grown):
    """A JAX fit + partial_fit writes v1; the port grows v2 from the root
    without the corpus; the JAX package serves v2 like the port does."""
    x, y = quality_data
    root, ((_base, j_pf), *_rest) = jax_grown
    y2, _ = gaussian_mixture(90, 16, n_components=8, seed=30)
    pf2 = NomadProjection.from_checkpoint(root, device="cpu").partial_fit(y2)
    assert (pf2.parent_version, pf2.version) == (j_pf.version, "v2") == ("v1", "v2")
    assert pf2.n_points == 1290
    np.testing.assert_array_equal(np.asarray(pf2.index.x_rows)[pf2.index.perm], np.vstack([x, y, y2]))

    v2 = MapLineage(root).resolve("v2").path
    jfz = JaxFrozenMap.from_checkpoint(v2)
    fz = FrozenMap.from_checkpoint(v2, device="cpu")
    assert jfz.n_points == fz.n_points == 1290
    q = y2[:32] + 0.01
    j0 = JaxMapServer(jfz, steps=0).transform(q, seed=0)
    p0 = MapServer(fz, steps=0).transform(q, seed=0)
    np.testing.assert_array_equal(p0.cells, j0.cells)
    np.testing.assert_array_equal(p0.neighbor_ids, j0.neighbor_ids)
    np.testing.assert_allclose(p0.embedding, j0.embedding, rtol=1e-5, atol=1e-5)
    j = JaxMapServer(jfz).transform(q, seed=0)
    p = MapServer(fz).transform(q, seed=0)
    assert np.isfinite(j.embedding).all() and np.isfinite(p.embedding).all()
    np.testing.assert_array_equal(p.cells, j.cells)
    spread = float(np.ptp(np.asarray(fz.theta_rows), axis=0).max())
    assert float(np.median(np.linalg.norm(p.embedding - j.embedding, axis=1))) < 0.05 * spread


# ---------------------------------------------------------------------------
# The event API
# ---------------------------------------------------------------------------


class Recorder(FitCallbacks):
    def __init__(self, wants_embedding=True):
        self.wants_embedding = wants_embedding
        self.events = []

    def on_epoch_start(self, e):
        self.events.append(("start", e))

    def on_epoch_end(self, e):
        self.events.append(("end", e))

    def on_means_refresh(self, e):
        self.events.append(("refresh", e))

    def on_checkpoint(self, e):
        self.events.append(("checkpoint", e))


@pytest.fixture(scope="module")
def plain_fit():
    x, _ = gaussian_mixture(500, 8, n_components=4, seed=40)
    return x, est_for(make_cfg(500, epochs=3, seed=40)).fit(x)


def test_callbacks_leave_the_fit_bit_equal(plain_fit, tmp_path):
    x, want = plain_fit
    rec = Recorder()
    cfg = make_cfg(500, epochs=3, seed=40, ckdir=str(tmp_path), checkpoint_every_epochs=1)
    got = est_for(cfg).fit(x, callbacks=[rec])
    np.testing.assert_array_equal(got.embedding, want.embedding)
    assert got.losses == want.losses
    kinds = [k for k, _ in rec.events]
    assert kinds == ["start", "checkpoint", "refresh", "end"] * 3
    assert [e.directory for k, e in rec.events if k == "checkpoint"] == [str(tmp_path)] * 3
    ends = [e for k, e in rec.events if k == "end"]
    assert [e.epoch for e in ends] == [0, 1, 2] and [e.loss for e in ends] == want.losses
    # embeddings are unpermuted (N, d): the last one is the result
    assert ends[-1].embedding.shape == (500, 2)
    np.testing.assert_array_equal(ends[-1].embedding, want.embedding)
    starts = [e for k, e in rec.events if k == "start"]
    assert starts[0].lr0 == est_for(make_cfg(500)).cfg.resolved_lr0() and starts[-1].lr1 == 0.0


def test_no_embedding_wanted_fetches_nothing(plain_fit, monkeypatch):
    x, want = plain_fit
    fetches = []
    real = LocalStrategy.fetch
    monkeypatch.setattr(LocalStrategy, "fetch", lambda self, th: fetches.append(1) or real(self, th))
    rec = Recorder(wants_embedding=False)
    got = est_for(make_cfg(500, epochs=3, seed=40)).fit(x, callbacks=rec)
    assert len(fetches) == 1  # the result's own fetch
    assert all(e.embedding is None for k, e in rec.events if k == "end")
    np.testing.assert_array_equal(got.embedding, want.embedding)


def test_legacy_callback_warns_and_gets_unpermuted_embedding(plain_fit):
    x, want = plain_fit
    seen = []
    with pytest.warns(DeprecationWarning):
        est_for(make_cfg(500, epochs=3, seed=40)).fit(x, callback=lambda e, emb, loss: seen.append((e, emb, loss)))
    assert [s[0] for s in seen] == [0, 1, 2] and seen[-1][1].shape == (500, 2)
    np.testing.assert_array_equal(seen[-1][1], want.embedding)


def test_partial_fit_emits_refinement_epochs(grown):
    x, y, _base, pf, _ = grown
    est = est_for(make_cfg(600))
    est.fit(x)
    rec = Recorder()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = est.partial_fit(y, callbacks=rec)
    np.testing.assert_array_equal(got.embedding, pf.embedding)
    ends = [e for k, e in rec.events if k == "end"]
    assert [k for k, _ in rec.events] == ["start", "end"] * 2
    assert [e.strategy for e in ends] == ["partial", "partial"] and [e.loss for e in ends] == pf.losses
    np.testing.assert_array_equal(ends[-1].embedding, pf.embedding)
