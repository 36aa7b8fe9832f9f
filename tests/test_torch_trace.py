"""The port's spans and counters (``repro_torch.core.trace``): with no
profiler a span is one shared null context; under the profiler the epoch
step shows its phases, the build and the fit their stages, and nothing
moves a bit; k-means counts its passes over the rows and the streamed
build the seconds it waited on its reader."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import NomadConfig  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.data.store import ArrayStore  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.index import kmeans as km  # noqa: E402
from repro_torch.index.build import IndexBuilder, seeded_generator  # noqa: E402

STEP_CHILDREN = ["nomad.step.gather", "nomad.step.k1", "nomad.step.sample", "nomad.step.sample",
                 "nomad.step.scatter"]


@pytest.fixture(autouse=True)
def _one_thread_and_fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    torch.set_num_threads(threads)


def _epoch_state(K=8, C=40, d=2, k=5, refresh=2):
    """A tiny cluster-major index and θ, made with numpy, and its config."""
    rng = np.random.default_rng(3)
    counts = rng.integers(C // 2, C + 1, K)
    knn = np.zeros((K * C, k), np.int64)
    for c in range(K):
        for s in range(counts[c]):
            knn[c * C + s] = c * C + rng.integers(0, counts[c], k)
    idx = {
        "knn_idx": torch.from_numpy(knn),
        "knn_w": torch.from_numpy(rng.random((K * C, k)).astype(np.float32)),
        "counts": torch.from_numpy(counts.astype(np.int64)),
        "cum_counts": torch.from_numpy(np.cumsum(counts).astype(np.int64)),
        "total": int(counts.sum()),
    }
    cfg = NomadConfig(n_points=K * C, dim=4, n_clusters=K, capacity_slack=1.0, n_neighbors=k, n_noise=16,
                      n_exact_negatives=4, batch_size=32, mean_refresh_steps=refresh)
    assert cfg.cluster_capacity == C
    theta = torch.from_numpy(rng.normal(size=(K * C, d)).astype(np.float32))
    return cfg, theta, idx


def _annotations(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(("nomad.", "build.", "fit."))]


def _children(event) -> list:
    return sorted(c.name for c in event.cpu_children if c.name.startswith("nomad."))


def _build_cfg(**kw):
    base = dict(n_points=1200, dim=8, n_clusters=6, n_neighbors=5, n_noise=16, n_exact_negatives=4,
                batch_size=64, n_epochs=2, kmeans_iters=4, kmeans_tol=-1.0, build_block_rows=256)
    base.update(kw)
    return NomadConfig(**base)


def _rows(n=1200, d=8):
    x, _ = gaussian_mixture(n, d, n_components=6, seed=1)
    return x.astype(np.float32)


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = trace.span("nomad.step"), trace.span("build.kmeans")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        torch.ones(2).sum()
    assert trace.span_totals() == {}


def test_span_under_the_profiler_is_recorded_and_adds_up():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("nomad.outer"):
            with trace.span("nomad.inner"):
                torch.ones(8).sum()
    outer = [e for e in _annotations(prof) if e.name == "nomad.outer"]
    assert len(outer) == 1 and _children(outer[0]) == ["nomad.inner"]
    got = trace.span_totals()
    assert got["nomad.outer"][0] == 1 and got["nomad.inner"][0] == 1
    assert got["nomad.outer"][1] >= got["nomad.inner"][1] > 0
    assert isinstance(trace.span("nomad.after"), contextlib.nullcontext)


@pytest.mark.parametrize("refresh", [0, 2])
def test_an_epoch_under_the_profiler_shows_every_step_and_its_phases(refresh):
    from repro_torch.core.nomad import run_epoch

    cfg, theta, idx = _epoch_state(refresh=refresh)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_epoch(theta.clone(), idx, cfg, "nomad", steps, 1.0, 0.5, 3)
    events = _annotations(prof)
    named = lambda n: [e for e in events if e.name == n]  # noqa: E731
    assert len(named("nomad.epoch")) == 1
    means = -(-steps // (refresh or steps))
    assert len(named("nomad.means")) == means
    step_events = named("nomad.step")
    assert len(step_events) == steps
    for e in step_events:
        assert _children(e) == STEP_CHILDREN
    assert _children(named("nomad.epoch")[0]) == sorted(["nomad.means"] * means + ["nomad.step"] * steps)
    got = trace.span_totals()
    assert got["nomad.step"][0] == steps and got["nomad.step.sample"][0] == 2 * steps
    assert {n: got[n][0] for n in ("nomad.step.gather", "nomad.step.k1", "nomad.step.scatter")} == dict.fromkeys(
        ("nomad.step.gather", "nomad.step.k1", "nomad.step.scatter"), steps)
    children_s = sum(got[n][1] for n in set(STEP_CHILDREN))
    assert children_s <= got["nomad.step"][1]


@pytest.mark.parametrize("method", ["nomad", "infonc"])
def test_theta_and_loss_are_bit_equal_under_the_profiler(method):
    from repro_torch.core.nomad import run_epoch

    cfg, theta, idx = _epoch_state()
    plain, loss = run_epoch(theta.clone(), idx, cfg, method, 4, 1.0, 0.5, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, traced_loss = run_epoch(theta.clone(), idx, cfg, method, 4, 1.0, 0.5, 1)
    assert torch.equal(plain, traced) and torch.equal(loss, traced_loss)
    assert not torch.equal(plain, theta)


def test_stage_times_the_stage_and_names_its_span():
    stage_s, stage_rss = {}, {}
    with trace.stage("build", "kmeans", stage_s, torch.device("cpu"), stage_rss):
        torch.ones(16).sum()
    with trace.stage("build", "kmeans", stage_s, torch.device("cpu")):
        pass
    assert set(stage_s) == {"kmeans"} and stage_s["kmeans"] > 0 and stage_rss["kmeans"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.stage("fit", "init", stage_s, torch.device("cpu")):
            pass
    assert [e.name for e in _annotations(prof)] == ["fit.init"]


@pytest.mark.parametrize("converge", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_streamed_kmeans_counts_its_passes(converge, seeded):
    """The LSH seeding pass (unless ``cents0`` is given) and every E-step,
    the one that converged included."""
    x = _rows()
    store, dev = ArrayStore(x), torch.device("cpu")
    cents0 = torch.from_numpy(x[:6].copy()) if seeded else None
    tol = float("inf") if converge else -1.0
    km.kmeans_centroids_streamed(seeded_generator(dev, 0), store, 6, chunk_rows=300, n_iters=3, tol=tol, block=128,
                                 device=dev, cents0=cents0)
    e_steps = 1 if converge else 3
    assert trace.counts()["kmeans.passes"] == (0 if seeded else 1) + e_steps
    assert trace.counts()["stream.read_wait_s"] >= 0.0


@pytest.mark.parametrize("kind", ["streamed", "local", "sharded"])
def test_build_report_counts_kmeans_passes_and_reader_waits(kind, monkeypatch):
    """``BuildReport.kmeans_passes`` is 1 (the LSH seeding) + the E-steps
    k-means ran, counted here by the E-step's calls; ``read_wait_s`` is
    what the build waited on ``stream_chunks`` (no stream: 0)."""
    from repro_torch.launch.mesh import flat_mesh

    calls = []
    real = km.blocked_assign
    monkeypatch.setattr(km, "blocked_assign", lambda *a: calls.append(1) or real(*a))
    x = _rows()
    trace.count("kmeans.passes", 5)  # another's passes before the build
    if kind == "streamed":
        cfg, per_pass = _build_cfg(chunk_rows=300), 4  # 4 chunks a pass
        builder = IndexBuilder(cfg, device="cpu")
    elif kind == "local":
        cfg, per_pass = _build_cfg(), 1
        builder = IndexBuilder(cfg, strategy="local", device="cpu")
    else:
        cfg, per_pass = _build_cfg(), 2  # one call a slot
        builder = IndexBuilder(cfg, strategy="sharded", mesh=flat_mesh("data", ["cpu"] * 2), device="cpu")
    builder.build(x)
    report = builder.report
    assert report.strategy == kind
    assert len(calls) % per_pass == 0 and len(calls) // per_pass == cfg.kmeans_iters
    assert report.kmeans_passes == 1 + cfg.kmeans_iters
    assert set(report.stage_s) == {"kmeans", "assign", "stragglers", "permute", "knn"}
    if kind == "streamed":
        assert report.read_wait_s >= 0.0 and "stream.read_wait_s" in trace.counts()
    else:
        assert report.read_wait_s == 0.0


def test_fit_stages_keep_their_keys_and_show_as_spans():
    from repro_torch.core.nomad import NomadProjection

    cfg = _build_cfg(kmeans_tol=1e-4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = NomadProjection(cfg, device="cpu").fit(_rows())
    assert set(res.stage_s) == {"kmeans", "assign", "stragglers", "permute", "knn", "init", "epochs"}
    assert set(res.stage_rss_mb) == set(res.stage_s)
    assert len(res.epoch_times) == cfg.n_epochs and res.wall_time_s >= res.stage_s["epochs"]
    names = {e.name for e in _annotations(prof)}
    assert {"build.kmeans", "build.knn", "fit.init", "fit.epochs", "nomad.epoch", "nomad.step"} <= names
    steps = cfg.resolved_steps_per_epoch() * cfg.n_epochs
    assert trace.span_totals()["nomad.step"][0] == steps
