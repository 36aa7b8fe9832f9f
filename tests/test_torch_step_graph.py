"""The epoch loop's CUDA graph of the step (``core/nomad.py:StepGraph``)
as far as the CPU can show it: on CPU tensors the epoch is the eager one
and counts every step under ``nomad.step.eager``; the graph's seeding
draws what ``seeded_generator`` draws; a capture's launches are recorded,
not counted, and each replay adds them. The graphed epoch itself runs on
the card only (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import NomadConfig  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.nomad import StepGraph, make_epoch_fn, make_step_fn, sample_partial_rows  # noqa: E402
from repro_torch.core.strategy import LocalStrategy, PartialRefineStrategy  # noqa: E402
from repro_torch.index.build import generator_seed, seeded_generator  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_counters():
    trace.reset()
    yield
    trace.reset()


def _index(K=8, C=40, k=5):
    """A tiny cluster-major index made with numpy, its config and θ."""
    rng = np.random.default_rng(3)
    counts = rng.integers(C // 2, C + 1, K)
    knn = np.zeros((K * C, k), np.int64)
    for c in range(K):
        for s in range(counts[c]):
            knn[c * C + s] = c * C + rng.integers(0, counts[c], k)
    index = SimpleNamespace(counts=counts, knn_idx=knn, knn_w=rng.random((K * C, k)).astype(np.float32),
                            n_points=int(counts.sum()))
    cfg = NomadConfig(n_points=K * C, dim=4, n_clusters=K, capacity_slack=1.0, n_neighbors=k,
                      n_noise=16, n_exact_negatives=4, batch_size=16, mean_refresh_steps=3)
    assert cfg.cluster_capacity == C
    return cfg, index, rng.normal(size=(K * C, 2)).astype(np.float32)


@pytest.mark.parametrize("strategy,method", [("local", "nomad"), ("local", "infonc"), ("partial", "nomad")])
def test_on_the_cpu_the_epoch_is_eager_and_counted_so(strategy, method):
    cfg, index, theta0 = _index()
    s = LocalStrategy() if strategy == "local" else PartialRefineStrategy(np.arange(0, 8, 2))
    theta = s.prepare(cfg, method, index, theta0, torch.device("cpu"))
    assert isinstance(s.graph, StepGraph) and s.steps > s.graph.WARMUP
    want = torch.from_numpy(theta0.copy())
    kw = {}
    if strategy == "partial":
        kw = dict(n_total=s.n_points, sampler=sample_partial_rows)
    epoch = make_epoch_fn(cfg, make_step_fn(cfg, method=method, **kw), s.steps)
    key = (cfg.seed + 1,) if strategy == "local" else (cfg.seed + 11, s.n_points)
    for e in range(2):
        theta, loss = s.run_epoch(theta, e, 2.0, 1.0)
        want, want_loss = epoch(want, s.idx, 2.0, 1.0, (*key, e))
        assert torch.equal(theta, want) and loss == float(want_loss)
    got = trace.counts()
    assert got["nomad.step.eager"] == 4 * s.steps  # the strategy's epochs and the reference's
    assert "nomad.step.graphed" not in got
    assert s.graph.key is None  # nothing was captured


@pytest.mark.parametrize("key", [(0,), (7, 3, 11), (2**31 + 5, 60, 366)])
def test_the_graph_seeding_draws_as_seeded_generator(key):
    gen = torch.Generator().manual_seed(generator_seed(*key))
    ref = seeded_generator(torch.device("cpu"), *key)
    assert torch.equal(torch.randint(0, 10**6, (64,), generator=gen), torch.randint(0, 10**6, (64,), generator=ref))
    assert torch.equal(torch.rand((8, 4), generator=gen), torch.rand((8, 4), generator=ref))


@pytest.mark.parametrize("steps", [1, StepGraph.WARMUP, StepGraph.WARMUP + 1, 367])
def test_the_graph_never_engages_on_the_cpu(steps):
    assert not StepGraph().engages(torch.zeros(4, 2), steps)


def test_a_capture_records_its_launches_and_each_replay_adds_them():
    k = registry.get("nomad_step_fwd")
    before = registry.launch_counts()
    with registry.recorded_launches() as got:
        registry.count_launch(k)
        worker = threading.Thread(target=registry.count_launch, args=(registry.get("nomad_step_bwd"),))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert got == {"nomad_step_fwd": 1, "nomad_step_bwd": 1}
    assert registry.launch_counts() == before
    registry.add_launches(got)
    registry.add_launches(got)
    after = registry.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {"nomad_step_fwd": 2,
                                                                                  "nomad_step_bwd": 2}
    registry.count_launch(k)
    assert registry.launch_counts()["nomad_step_fwd"] == after["nomad_step_fwd"] + 1
