"""The port's sharded NOMAD side on shard slots, on the CPU:

* one slot's step, given the same sampled rows and exchanged means, moves
  θ like the JAX package's sharded step (``losses.nomad_step_term``'s
  value and gradients, then the three scatters), within K1's 2e-5;
* the flat and 2×2 hierarchical exchanges (``cell_means``, ``cell_w``,
  ``own_base`` on every slot) ≡ the reference's formula built from
  ``repro.core.nomad.local_means`` on each slot's block, within 1e-6;
* 4-slot flat and 2×2 hierarchical fits: finite, the loss falls, NP@10 in
  the quality bands and within 0.05 of the JAX package's 4-device fits of
  the same data (one subprocess with 4 forced host devices);
* the 4-slot build: counts ≤ C, no kNN edge leaves its slot, the
  assignment ≡ the local one on the same centroids on ≥ 0.99 of rows; the
  distributed build on one process ≡ the sharded build; one slot ≡ local;
* 4-slot serving ≡ local serving bit for bit; a killed 4-slot fit resumed
  ≡ uninterrupted; ``process_row_range``/``assigned_shards`` ≡ the JAX
  package's on the same stores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import losses as jax_losses  # noqa: E402
from repro.core import nomad as jax_nomad  # noqa: E402
from repro.metrics import neighborhood_preservation, random_triplet_accuracy  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core import nomad  # noqa: E402
from repro_torch.core.distributed import cell_exchange, shard_index_arrays  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.core.strategy import FitCallbacks  # noqa: E402
from repro_torch.data.store import ArrayStore, write_sharded  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index.build import IndexBuilder, capacity_assign_device, seeded_generator  # noqa: E402
from repro_torch.launch.mesh import flat_mesh, make_mesh  # noqa: E402
from repro_torch.serve import MapServer  # noqa: E402

torch.set_num_threads(1)  # index_put_'s CPU sums repeat bit for bit on one thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FOUR = [CPU] * 4
# 8 cells over 4 slots (2 a slot) or 2 pods × 2 slots
CFG = NomadConfig(
    n_points=2000, dim=16, n_clusters=8, n_neighbors=15, n_noise=32,
    n_exact_negatives=8, batch_size=128, n_epochs=40,
)
BAND_NP10 = 10 * (10 / 2000)  # tests/test_nomad_quality.py: NP@10 > 10× chance
JAX_NP10_BAND = 0.05


@pytest.fixture(scope="module")
def data():
    x, _ = gaussian_mixture(CFG.n_points, CFG.dim, n_components=8, seed=1)
    return x


@pytest.fixture(scope="module")
def index(data):
    return IndexBuilder(CFG, device="cpu").build(data)


def _flat():
    return flat_mesh("data", FOUR)


def _pods():
    return make_mesh((2, 2), ("pod", "data"), FOUR)


# ---------------------------------------------------------------------------
# The exchange and one slot's step against the reference's formulas
# ---------------------------------------------------------------------------


def _ref_exchange(blocks, counts, C, shard, n_pods, hierarchical, n_noise, n_total):
    """``core/distributed.py:gather_cells`` of the JAX package, written out
    over the slots' blocks (its all-gathers are concatenations here)."""
    n = len(blocks)
    Kl = counts.shape[0] // n
    means = [jax_nomad.local_means(jnp.asarray(b), jnp.asarray(counts[s * Kl : (s + 1) * Kl]), C)
             for s, b in enumerate(blocks)]
    cg = jnp.asarray(counts, jnp.float32)
    if not hierarchical:
        return jnp.concatenate(means), float(n_noise) * cg / n_total, shard * Kl
    per_pod = n // n_pods
    Kp = Kl * per_pod
    pod = shard // per_pod
    supers, sizes = [], []
    for q in range(n_pods):
        mq = jnp.concatenate(means[q * per_pod : (q + 1) * per_pod])
        cq = cg[q * Kp : (q + 1) * Kp]
        supers.append(jnp.sum(mq * cq[:, None], 0) / jnp.maximum(jnp.sum(cq), 1.0))
        sizes.append(jnp.sum(cq))
    super_w = float(n_noise) * jnp.stack(sizes) / n_total
    super_w = jnp.where(jnp.arange(n_pods) == pod, 0.0, super_w)
    cell_means = jnp.concatenate([jnp.concatenate(means[pod * per_pod : (pod + 1) * per_pod]), jnp.stack(supers)])
    cell_w = jnp.concatenate([float(n_noise) * cg[pod * Kp : (pod + 1) * Kp] / n_total, super_w])
    return cell_means, cell_w, shard * Kl - pod * Kp


def _theta(index, seed=0):
    rows = index.n_clusters * index.capacity
    return np.random.default_rng(seed).normal(0, 3, (rows, CFG.out_dim)).astype(np.float32)


@pytest.mark.parametrize("hierarchical", [False, True])
def test_exchange_matches_reference_formula(index, hierarchical):
    theta = _theta(index)
    n, C = 4, index.capacity
    rows_per = theta.shape[0] // n
    Kl = index.n_clusters // n
    blocks = [theta[s * rows_per : (s + 1) * rows_per] for s in range(n)]
    counts = np.asarray(index.counts, np.int64)
    means = [nomad.local_means(torch.from_numpy(b), torch.from_numpy(counts[s * Kl : (s + 1) * Kl]), C)
             for s, b in enumerate(blocks)]
    for shard in range(n):
        got = cell_exchange(means, torch.from_numpy(counts), shard, n_noise=CFG.n_noise, n_total=CFG.n_points,
                            n_pods=2, hierarchical=hierarchical)
        want = _ref_exchange(blocks, counts, C, shard, 2, hierarchical, CFG.n_noise, CFG.n_points)
        assert got[0].shape == (index.n_clusters // 2 + 2 if hierarchical else index.n_clusters, 2)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
        assert got[2] == want[2]
        if hierarchical:  # the own pod's super-mean weighs nothing
            assert float(got[1][index.n_clusters // 2 + shard // 2]) == 0.0


@pytest.mark.parametrize("hierarchical,shard", [(False, 2), (True, 1), (True, 3)])
def test_one_slot_step_matches_jax(index, hierarchical, shard):
    """Slot ``shard`` of 4: the rows the port's sampler draws for it, the
    exchanged means, then the port's step against the JAX package's
    sharded step body on the same inputs (jnp ``nomad_step_term``)."""
    theta = _theta(index, seed=shard)
    n, C = 4, index.capacity
    rows_per = theta.shape[0] // n
    Kl = index.n_clusters // n
    arrays = shard_index_arrays(index, n)
    sl = slice(shard * rows_per, (shard + 1) * rows_per)
    counts_l = arrays["counts"][shard * Kl : (shard + 1) * Kl]
    idx_l = {
        "knn_idx": torch.from_numpy(arrays["knn_idx"][sl]), "knn_w": torch.from_numpy(arrays["knn_w"][sl]),
        "counts": torch.from_numpy(counts_l), "total": int(counts_l.sum()),
        "cum_counts": torch.from_numpy(arrays["cum_counts"][shard * Kl : (shard + 1) * Kl]),
    }
    blocks = [theta[s * rows_per : (s + 1) * rows_per] for s in range(n)]
    cell_means, cell_w, own_base = _ref_exchange(blocks, arrays["counts"], C, shard, 2, hierarchical,
                                                 CFG.n_noise, CFG.n_points)
    rows, cl, neg = nomad.sample_step_rows(seeded_generator(CPU, CFG.seed + 1, 0, shard, 0), idx_l, CFG, "nomad")
    lr = CFG.resolved_lr0()
    theta_l = torch.tensor(theta[sl])
    loss = nomad.step_update(theta_l, idx_l, torch.from_numpy(np.array(cell_means)), idx_l["counts"], lr, rows, cl,
                             neg, cfg=CFG, cell_w=torch.from_numpy(np.array(cell_w)), own_base=own_base)

    # the reference's sgd_step body (src/repro/core/distributed.py) on the same rows
    r, c, ng = (jnp.asarray(a.numpy()) for a in (rows, cl, neg))
    th = jnp.asarray(theta[sl])
    pos_rows = jnp.asarray(arrays["knn_idx"][sl])[r]
    pos_w = jnp.asarray(arrays["knn_w"][sl])[r]
    B, S = neg.shape
    p_own = jnp.asarray(counts_l, jnp.float32)[c] / CFG.n_points
    neg_w = jnp.broadcast_to((float(CFG.n_noise) * p_own / S)[:, None], (B, S))

    def loss_fn(ti, tp, tn):
        return jnp.mean(jax_losses.nomad_step_term(ti, tp, pos_w, tn, neg_w, cell_means, cell_w, c + own_base, "jnp"))

    want_loss, (g_i, g_pos, g_neg) = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(th[r], th[pos_rows], th[ng])
    want = th.at[r].add(-lr * g_i)
    want = want.at[pos_rows.reshape(-1)].add(-lr * g_pos.reshape(-1, 2))
    want = want.at[ng.reshape(-1)].add(-lr * g_neg.reshape(-1, 2))
    assert not np.array_equal(np.asarray(want), theta[sl])  # the step moved θ
    np.testing.assert_allclose(theta_l.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5, atol=2e-5)


def test_shard_index_arrays_rebase_and_refuse_crossing_edges(index):
    arrays = shard_index_arrays(index, 4)
    rows_per = index.n_clusters * index.capacity // 4
    for s in range(4):
        blk = arrays["knn_idx"][s * rows_per : (s + 1) * rows_per]
        assert blk.min() >= 0 and blk.max() < rows_per
    bad = dataclasses.replace(index, knn_idx=index.knn_idx.copy())
    bad.knn_idx[0, 0] = index.knn_idx.shape[0] - 1  # an edge into the last slot
    with pytest.raises(AssertionError, match="crosses shard boundary"):
        shard_index_arrays(bad, 4)


# ---------------------------------------------------------------------------
# 4-slot fits: quality, and beside the JAX package's 4-device fits
# ---------------------------------------------------------------------------

_JAX_FITS = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import NomadConfig
from repro.core.nomad import NomadProjection
from repro.metrics import neighborhood_preservation

cfg = NomadConfig(**json.loads(sys.argv[1]))
x = np.load(sys.argv[2])
devs = np.asarray(jax.devices()[:4])
assert devs.size == 4, jax.devices()
out = {}
for name, mesh, strategy in (("flat", Mesh(devs.reshape(4), ("data",)), "sharded"),
                             ("hierarchical", Mesh(devs.reshape(2, 2), ("pod", "data")), "hierarchical")):
    emb = NomadProjection(cfg, strategy=strategy, mesh=mesh).fit(x).embedding
    out[name] = float(neighborhood_preservation(x, emb, k=10, n_queries=500))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_four_device_np10(data, tmp_path_factory):
    """NP@10 of the JAX package's flat and 2×2 fits of ``data`` on 4 forced
    host devices, one subprocess (the flag must precede jax's start)."""
    path = str(tmp_path_factory.mktemp("jax4") / "x.npy")
    np.save(path, data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _JAX_FITS, json.dumps(dataclasses.asdict(CFG)), path],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and lines, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(lines[0][len("RESULT "):])


@pytest.mark.parametrize("name", ["flat", "hierarchical"])
def test_four_slot_fit_quality_and_beside_jax(data, index, jax_four_device_np10, name):
    mesh, strategy = (_flat(), "sharded") if name == "flat" else (_pods(), "hierarchical")
    res = NomadProjection(CFG, strategy=strategy, mesh=mesh, device="cpu").fit(data, index=index)
    assert res.strategy == strategy and res.n_shards == 4
    emb = res.embedding
    assert emb.shape == (CFG.n_points, 2) and np.isfinite(emb).all()
    assert res.losses[-1] < res.losses[0], res.losses
    np10 = neighborhood_preservation(data, emb, k=10, n_queries=500)
    assert np10 > BAND_NP10, np10
    assert random_triplet_accuracy(data, emb, 8000) > 0.6
    assert abs(np10 - jax_four_device_np10[name]) <= JAX_NP10_BAND, (np10, jax_four_device_np10)
    again = NomadProjection(CFG, strategy=strategy, mesh=mesh, device="cpu").fit(data, index=index)
    np.testing.assert_array_equal(again.embedding, emb)  # a rerun repeats bit for bit


class _Kill(Exception):
    pass


class _KillAfter(FitCallbacks):
    wants_embedding = False

    def __init__(self, epoch):
        self.epoch = epoch

    def on_epoch_end(self, ev):
        if ev.epoch == self.epoch:
            raise _Kill(ev.epoch)


def test_four_slot_kill_resume_matches_uninterrupted(data, index, tmp_path):
    """The fit's checkpoints hold θ in the global row layout (4 row-block
    shards here): a killed 4-slot fit resumed ≡ the uninterrupted one; the
    same checkpoint resumes under the local strategy too."""
    cfg = CFG.replace(n_epochs=6, checkpoint_every_epochs=2)
    full = NomadProjection(cfg.replace(checkpoint_dir=str(tmp_path / "a")), strategy="sharded", mesh=_flat(),
                           device="cpu").fit(data, index=index)
    ckdir = str(tmp_path / "b")
    with pytest.raises(_Kill):
        NomadProjection(cfg.replace(checkpoint_dir=ckdir), strategy="sharded", mesh=_flat(), device="cpu").fit(
            data, index=index, callbacks=_KillAfter(3))
    manifest = json.load(open(os.path.join(ckdir, "step_000000003", "manifest.json")))
    assert manifest["n_shards"] == 4 and manifest["metadata"]["strategy"] == "sharded"
    elastic = shutil.copytree(ckdir, str(tmp_path / "c"))
    est = NomadProjection.from_checkpoint(ckdir, device="cpu")
    est.strategy, est.mesh = "sharded", _flat()
    res = est.fit(data)
    assert res.resumed and res.start_epoch == 4 and res.index_build_strategy == "cache"
    np.testing.assert_array_equal(full.embedding, res.embedding)
    local = NomadProjection.from_checkpoint(elastic, device="cpu").fit(data)  # elastic: 4 shards → 1
    assert local.strategy == "local" and local.start_epoch == 4 and np.isfinite(local.embedding).all()


def test_fit_distributed_shim_is_deprecated(data, index):
    from repro_torch.core.distributed import fit_distributed

    cfg = CFG.replace(n_epochs=2)
    with pytest.warns(DeprecationWarning, match="fit_distributed"):
        emb, idx, losses = fit_distributed(cfg, data, _flat(), shard_axes=("data",), index=index, device="cpu")
    want = NomadProjection(cfg, strategy="sharded", mesh=_flat(), device="cpu").fit(data, index=index)
    np.testing.assert_array_equal(emb, want.embedding)
    assert losses == want.losses and idx is index


# ---------------------------------------------------------------------------
# The build over slots
# ---------------------------------------------------------------------------

_FIELDS = ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm")


def test_one_slot_build_equals_local(data, index):
    b = IndexBuilder(CFG, strategy="sharded", mesh=flat_mesh("data", [CPU]), device="cpu")
    got = b.build(data)
    assert b.report.strategy == "sharded" and b.report.n_shards == 1
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(index, f), err_msg=f)


def test_four_slot_build(data):
    cfg = CFG.replace(n_points=1999)  # rows do not divide the slots: one padded slot
    x = data[:1999]
    b = IndexBuilder(cfg, strategy="sharded", mesh=_flat(), device="cpu")
    idx = b.build(x)
    assert b.report.strategy == "sharded" and b.report.n_shards == 4
    C = idx.capacity
    assert (idx.counts <= C).all() and int(idx.counts.sum()) == 1999
    assert np.array_equal(np.sort(idx.perm), np.sort(np.unique(idx.perm)))  # a bijection onto rows
    np.testing.assert_array_equal(idx.x_rows[idx.perm], x)
    rows_per = idx.n_clusters * C // 4
    live = idx.knn_w > 0
    head = np.broadcast_to((np.arange(idx.knn_idx.shape[0]) // rows_per)[:, None], idx.knn_idx.shape)
    assert (idx.knn_idx[live] // rows_per == head[live]).all()  # no edge leaves its slot
    shard_index_arrays(idx, 4)  # and the fit's rebasing accepts it
    same = capacity_assign_device(x, idx.centroids, C, device="cpu", block=cfg.build_block_rows,
                                  max_rounds=cfg.build_max_rounds, n_cand=cfg.build_candidates)
    assert np.mean(same == idx.perm // C) >= 0.99
    # the distributed build on one process is the sharded build
    d = IndexBuilder(cfg, strategy="distributed", mesh=_flat(), device="cpu")
    got = d.build(ArrayStore(x))
    assert d.report.strategy == "distributed" and "place" in d.report.stage_s
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(idx, f), err_msg=f)


def test_build_strategy_resolution():
    from repro_torch.index.build import resolve_build_strategy

    assert resolve_build_strategy("auto", CFG, device=CPU) == ("local", None)
    assert resolve_build_strategy("local", CFG, mesh=_flat()) == ("local", None)
    name, mesh = resolve_build_strategy("auto", CFG, mesh=_flat())
    assert name == "sharded" and mesh.shape == {"build": 4}
    name, mesh = resolve_build_strategy("sharded", CFG.replace(n_clusters=6), mesh=_flat())
    assert mesh.shape == {"build": 3}  # the widest prefix K divides
    with pytest.raises(ValueError, match="unknown build_strategy"):
        IndexBuilder(CFG, strategy="hierarchical", device="cpu")


# ---------------------------------------------------------------------------
# Serving over slots
# ---------------------------------------------------------------------------


def test_four_slot_serving_equals_local(data, index):
    est = NomadProjection(CFG.replace(n_epochs=4, serve_microbatch=64), device="cpu")
    est.fit(data, index=index)
    fz = est.map_server().frozen
    q, _ = gaussian_mixture(300, CFG.dim, n_components=8, seed=7)
    want = MapServer(fz).transform(q, seed=3)
    for mesh in (_flat(), flat_mesh("data", [CPU])):
        srv = MapServer(fz, strategy="sharded", mesh=mesh)
        got = srv.transform(q, seed=3)
        assert got.strategy == "sharded" and got.n_shards == mesh.size and srv.batch_rows == 64 * mesh.size
        for f in ("embedding", "cells", "neighbor_ids", "neighbor_dists"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert np.isfinite(got.batch_loss).all()
    one = MapServer(fz, strategy="sharded", mesh=flat_mesh("data", [CPU])).transform(q, seed=3)
    assert one.batch_loss == want.batch_loss  # one slot: the local batches, losses too
    fast = MapServer(fz, strategy="sharded", mesh=_flat()).transform(q, seed=3, return_neighbors=False)
    np.testing.assert_array_equal(fast.embedding, want.embedding)
    # a 2-axis mesh serves over its slots as one flat axis
    assert MapServer(fz, strategy="sharded", mesh=_pods()).mesh.axis_names == ("serve",)


# ---------------------------------------------------------------------------
# Store row ranges against the JAX package's
# ---------------------------------------------------------------------------


def test_process_row_range_and_assigned_shards_match_jax(tmp_path):
    from repro.data.store import ArrayStore as JaxArrayStore
    from repro.data.store import ShardedStore as JaxShardedStore
    from repro_torch.data.store import ShardedStore

    x = np.arange(1001 * 3, dtype=np.float32).reshape(1001, 3)
    write_sharded(x, str(tmp_path / "st"), rows_per_shard=100)
    port, ref = ShardedStore(str(tmp_path / "st")), JaxShardedStore(str(tmp_path / "st"))
    for p in (1, 2, 3, 7):
        for i in range(p):
            want = JaxArrayStore(x).process_row_range(i, p)
            assert ArrayStore(x).process_row_range(i, p) == want == port.process_row_range(i, p)
            assert port.assigned_shards(i, p) == ref.assigned_shards(i, p)
        spans = [ArrayStore(x).process_row_range(i, p) for i in range(p)]
        assert spans[0][0] == 0 and spans[-1][1] == 1001
        assert all(spans[i][1] == spans[i + 1][0] for i in range(p - 1))
    with pytest.raises(ValueError):
        port.process_row_range(3, 3)
