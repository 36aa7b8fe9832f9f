"""The port's strategy layer: resolution by tests/test_strategy.py's rules
(``"auto"`` → local on one slot, the divisor rule, ``"infonc"`` needs the
local loop, ``"local"`` refused under several processes, the pod axis
found by itself), meshes of shard slots, provenance, and the sharded fit
on one slot ≡ the local fit bit for bit, beside the JAX package's
``strategy="sharded"`` on a 1-device mesh (quality bands)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.metrics import neighborhood_preservation, random_triplet_accuracy  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.core import strategy as strategy_mod  # noqa: E402
from repro_torch.core.strategy import (  # noqa: E402
    EpochEndEvent,
    FitCallbacks,
    HierarchicalStrategy,
    LocalStrategy,
    ShardedStrategy,
    default_mesh,
    resolve_strategy,
)
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import Slot, flat_mesh, make_mesh  # noqa: E402

torch.set_num_threads(1)  # index_put_'s CPU sums repeat bit for bit on one thread

N, DIM = 1500, 16
CFG = NomadConfig(
    n_points=N, dim=DIM, n_clusters=4, n_neighbors=10, n_noise=16,
    n_exact_negatives=4, batch_size=256, n_epochs=4,
)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    return gaussian_mixture(N, DIM, n_components=4, seed=0)


@pytest.fixture
def slots(monkeypatch):
    """Set this process's slot count in the global pool for one test."""
    def set_(n):
        monkeypatch.setattr(mesh_mod, "_LOCAL_SLOTS", n)

    return set_


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def test_auto_resolves_local_on_one_slot():
    assert mesh_mod.device_count() == 1
    assert isinstance(resolve_strategy("auto", CFG), LocalStrategy)
    assert isinstance(resolve_strategy("local", CFG), LocalStrategy)
    s = resolve_strategy("sharded", CFG)
    assert isinstance(s, ShardedStrategy) and not isinstance(s, HierarchicalStrategy)
    assert isinstance(resolve_strategy("hierarchical", CFG), HierarchicalStrategy)


def test_auto_with_mesh_resolves_sharded():
    s = resolve_strategy("auto", CFG, mesh=flat_mesh("data", [CPU]))
    assert isinstance(s, ShardedStrategy) and not isinstance(s, HierarchicalStrategy)
    pods = make_mesh((2, 2), ("pod", "data"), [CPU] * 4)
    assert isinstance(resolve_strategy("auto", CFG.replace(hierarchical=True), mesh=pods), HierarchicalStrategy)
    assert not isinstance(resolve_strategy("auto", CFG, mesh=pods), HierarchicalStrategy)


def test_auto_from_the_slot_pool(slots):
    slots(4)
    assert type(resolve_strategy("auto", CFG)) is ShardedStrategy
    assert isinstance(resolve_strategy("auto", CFG.replace(hierarchical=True)), HierarchicalStrategy)
    assert isinstance(resolve_strategy("auto", CFG.replace(method="infonc")), LocalStrategy)
    with pytest.warns(UserWarning, match="no divisor"):
        assert isinstance(resolve_strategy("auto", CFG.replace(n_clusters=5)), LocalStrategy)
    slots(3)  # K 4 and 3 slots: the widest divisor is 2 slots
    mesh = default_mesh(CFG, device=CPU)
    assert mesh.shape == {"data": 2} and CFG.n_clusters % mesh.size == 0


def test_strategy_instance_passthrough():
    s = LocalStrategy()
    assert resolve_strategy(s, CFG) is s


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="unknown strategy"):
        resolve_strategy("pmap", CFG)
    with pytest.raises(ValueError, match="unknown strategy"):
        NomadConfig(strategy="pmap")


def test_infonc_requires_local(data):
    x, _ = data
    proj = NomadProjection(CFG.replace(method="infonc"), strategy="sharded", mesh=flat_mesh("data", [CPU]),
                           device="cpu")
    with pytest.raises(ValueError, match="strategy='local'"):
        proj.fit(x)


def test_local_refused_under_several_processes(monkeypatch):
    monkeypatch.setattr(strategy_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="cannot run under torch.distributed"):
        resolve_strategy("local", CFG)


@pytest.mark.parametrize("n_slots,hierarchical,want", [
    (1, False, {"data": 1}), (4, False, {"data": 4}), (8, False, {"data": 4}),
    (4, True, {"pod": 2, "data": 2}), (8, True, {"pod": 2, "data": 2}), (1, True, {"data": 1}),
])
def test_default_mesh_divides_clusters(slots, n_slots, hierarchical, want):
    slots(n_slots)
    mesh = default_mesh(CFG, hierarchical=hierarchical, device=CPU)
    assert mesh.shape == want
    assert CFG.n_clusters % mesh.size == 0 and mesh.size <= n_slots
    assert all(s == Slot(0, CPU) for s in mesh.slots)


def test_mesh_checks():
    m = make_mesh((2, 2), ("pod", "data"), [CPU] * 4)
    assert m.size == 4 and m.axis_names == ("pod", "data")
    assert {k: int(v) for k, v in m.coords(2).items()} == {"pod": 1, "data": 0}
    assert m.local_indices() == [0, 1, 2, 3]
    got = m.all_gather([torch.full((2,), float(i)) for i in range(4)])
    assert [float(t[0]) for t in got] == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="needs 8 slots"):
        make_mesh((2, 4), ("pod", "data"), [CPU] * 4)
    with pytest.raises(ValueError, match="local slots"):
        m.all_gather([torch.zeros(1)])


def test_sharded_mesh_rules(data):
    x, _ = data
    # an axis neither sharded nor the pod axis would replicate θ silently
    two_axes = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    with pytest.raises(ValueError, match="covered by neither"):
        NomadProjection(CFG, strategy=ShardedStrategy(mesh=two_axes, shard_axes=("data",)), device="cpu").fit(x)
    with pytest.raises(ValueError, match="not divisible"):
        NomadProjection(CFG.replace(n_clusters=6), strategy="sharded", mesh=flat_mesh("data", [CPU] * 4),
                        device="cpu").fit(x)
    with pytest.raises(ValueError, match="pod axis"):
        NomadProjection(CFG, strategy="hierarchical", mesh=flat_mesh("data", [CPU] * 2), device="cpu").fit(x)


def test_pod_axis_autodetected_with_explicit_shard_axes(data):
    x, _ = data
    mesh = make_mesh((1, 1), ("pod", "data"), [CPU])
    strat = ShardedStrategy(mesh=mesh, shard_axes=("data",))
    res = NomadProjection(CFG.replace(n_epochs=1), strategy=strat, device="cpu").fit(x)
    assert strat.pod_axis == "pod"  # not silently dropped from the sharding
    assert res.n_shards == 1 and res.mesh_axes == ("pod", "data")


# ---------------------------------------------------------------------------
# Provenance
# ---------------------------------------------------------------------------


def test_describe_reports_process_topology():
    desc = resolve_strategy("local", CFG).describe()
    assert desc["process_count"] == 1 and desc["process_index"] == 0
    assert desc["strategy"] == "local" and desc["mesh_shape"] is None


def test_fit_result_records_process_provenance(data):
    x, _ = data
    res = NomadProjection(CFG.replace(n_epochs=1), device="cpu").fit(x)
    assert res.process_count == 1 and res.process_index == 0
    assert res.strategy == "local" and res.n_shards == 1


def test_sharded_fit_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NomadProjection(CFG, strategy="sharded")


# ---------------------------------------------------------------------------
# One slot ≡ local; one slot beside the JAX package's sharded fit
# ---------------------------------------------------------------------------


class Recorder(FitCallbacks):
    def __init__(self):
        self.ends, self.refreshes = [], []

    def on_epoch_end(self, ev):
        self.ends.append(ev)

    def on_means_refresh(self, ev):
        self.refreshes.append(ev)


def test_local_and_sharded_agree_on_one_slot(data):
    x, _ = data
    loc = NomadProjection(CFG, strategy="local", device="cpu").fit(x)
    rec = Recorder()
    sh = NomadProjection(CFG, strategy="sharded", mesh=flat_mesh("data", [CPU]), device="cpu").fit(
        x, index=loc.index, callbacks=rec)
    assert sh.strategy == "sharded" and sh.n_shards == 1
    assert sh.mesh_shape == (1,) and sh.mesh_axes == ("data",)
    np.testing.assert_array_equal(loc.embedding, sh.embedding)
    assert loc.losses == sh.losses
    assert all(isinstance(e, EpochEndEvent) and e.strategy == "sharded" for e in rec.ends)
    np.testing.assert_array_equal(rec.ends[-1].embedding, sh.embedding)  # unpermuted, (N, d)
    assert all(r.n_refreshes == 1 for r in rec.refreshes)
    # the default mesh over the one-slot pool is the same fit
    auto = NomadProjection(CFG, strategy="sharded", device="cpu").fit(x, index=loc.index)
    np.testing.assert_array_equal(auto.embedding, loc.embedding)


def test_one_slot_sharded_beside_jax_sharded():
    """The port's 1-slot sharded fit and the JAX package's sharded fit on a
    1-device mesh, same data and config: both in tests/test_nomad_quality.py's
    bands (NP@10 > 10× chance, triplet > 0.6), their NP@10 within 0.05 (the
    two draw different rows: Philox against threefry)."""
    x, _ = gaussian_mixture(2000, 16, n_components=8, seed=1)
    cfg = CFG.replace(n_points=2000, n_clusters=8, n_neighbors=15, n_noise=32, n_exact_negatives=8,
                      batch_size=128, n_epochs=40)
    port = NomadProjection(cfg, strategy="sharded", mesh=flat_mesh("data", [CPU]), device="cpu").fit(x)
    ref = JaxProjection(JaxConfig(**dataclasses.asdict(cfg)), strategy="sharded",
                        mesh=JaxMesh(np.asarray(jax.devices()[:1]), ("data",))).fit(x)
    np_p = neighborhood_preservation(x, port.embedding, k=10, n_queries=500)
    np_r = neighborhood_preservation(x, ref.embedding, k=10, n_queries=500)
    assert np_p > 10 * (10 / 2000) and np_r > 10 * (10 / 2000), (np_p, np_r)
    assert random_triplet_accuracy(x, port.embedding, 8000) > 0.6
    assert abs(np_p - np_r) <= 0.05, (np_p, np_r)
    assert port.losses[-1] < port.losses[0]
