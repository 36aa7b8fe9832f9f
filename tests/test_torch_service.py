"""The port's service layer on the CPU: the contracts of
``tests/test_service.py`` on a port fit, and the port against the JAX
package's service on the same checkpoint.

* **coalesced ≡ direct** — concurrent ``project()`` requests return the
  bits of one dedicated ``MapServer.transform`` call per request;
* **cache hits skip device work** — the batcher's counters do not move;
* **a hot swap under load drops nothing** — every response equals a
  direct transform on the version it names;
* **parity** — on a JAX-written checkpoint at ``transform_steps=0`` the
  two services place alike; fingerprints and cache keys are the JAX
  package's values; the introspection bodies have its keys.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import NomadConfig as JaxConfig  # noqa: E402
from repro.core.nomad import NomadProjection as JaxProjection  # noqa: E402
from repro.serve import FrozenMap as JaxFrozenMap  # noqa: E402
from repro.serve.server import TransformResult as JaxTransformResult  # noqa: E402
from repro.service import MapService as JaxMapService  # noqa: E402
from repro.service import make_key as jax_make_key  # noqa: E402
from repro.service import map_fingerprint as jax_map_fingerprint  # noqa: E402
from repro.service import query_fingerprint as jax_query_fingerprint  # noqa: E402
from repro_torch.checkpoint import MapLineage  # noqa: E402
from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.serve import FrozenMap, MapServer, TransformResult  # noqa: E402
from repro_torch.service import (  # noqa: E402
    Batcher,
    BatcherClosed,
    MapRegistry,
    MapService,
    ResultCache,
    make_key,
    map_fingerprint,
    query_fingerprint,
)
from repro_torch.service.cache import EXACT_FINGERPRINT_ROWS  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, MICRO = 600, 8, 32

CFG = NomadConfig(
    n_points=N,
    dim=DIM,
    n_clusters=4,
    n_neighbors=5,
    n_noise=8,
    n_exact_negatives=4,
    batch_size=128,
    n_epochs=2,
    serve_microbatch=MICRO,
    transform_steps=4,
    service_max_delay_s=0.003,
)


def _fit(seed: int, ckdir: str = ""):
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=seed)
    est = NomadProjection(CFG.replace(seed=seed, checkpoint_dir=ckdir), device="cpu")
    est.fit(x)
    return est


@pytest.fixture(scope="module")
def fitted():
    return _fit(0)


@pytest.fixture(scope="module")
def fitted_b(tmp_path_factory):
    """A second, genuinely different map (another seed), checkpointed: the
    swap target."""
    ckdir = str(tmp_path_factory.mktemp("svc") / "ck_b")
    return _fit(1, ckdir), ckdir


@pytest.fixture(scope="module")
def jax_ck(tmp_path_factory):
    """A JAX fit (jnp kernels) with its checkpoint directory."""
    ckdir = str(tmp_path_factory.mktemp("jax_svc") / "ck")
    jcfg = JaxConfig(**dataclasses.asdict(CFG.replace(checkpoint_dir=ckdir)), kernel_impl="jnp")
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    JaxProjection(jcfg).fit(x)
    return ckdir


def queries(n, seed):
    q, _ = gaussian_mixture(n, DIM, n_components=4, seed=seed)
    return q


def frozen(est) -> FrozenMap:
    return FrozenMap.from_fit(est._fit_result, est.cfg, device="cpu")


def assert_result_equal(got: TransformResult, want: TransformResult):
    np.testing.assert_array_equal(got.embedding, want.embedding)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.neighbor_ids, want.neighbor_ids)
    np.testing.assert_array_equal(got.neighbor_dists, want.neighbor_dists)


# ---------------------------------------------------------------------------
# The serve layer's fields the service reads
# ---------------------------------------------------------------------------


def test_transform_result_fields_match_jax():
    got = [f.name for f in dataclasses.fields(TransformResult)]
    assert got == [f.name for f in dataclasses.fields(JaxTransformResult)]


def test_map_server_reports_strategy_and_shards(fitted):
    server = fitted.map_server()
    assert (server.strategy, server.n_shards) == ("local", 1)
    r = server.transform(queries(5, 1), seed=0)
    assert (r.strategy, r.n_shards) == ("local", 1)


# ---------------------------------------------------------------------------
# Batching engine: coalesced ≡ direct, bit for bit
# ---------------------------------------------------------------------------


def test_batcher_single_request_equals_direct(fitted):
    server = fitted.map_server()
    batcher = Batcher(server, max_delay_s=0.0)
    q = queries(50, 11)
    try:
        got = batcher.project(q, seed=3)
    finally:
        batcher.close()
    assert_result_equal(got, server.transform(q, seed=3))
    assert got.n_queries == 50 and np.isnan(got.batch_loss).all()
    assert (got.strategy, got.n_shards) == ("local", 1)


def test_batcher_concurrent_requests_bit_equal_direct(fitted):
    """4 client threads, 3 requests each, ragged sizes and distinct seeds:
    however the worker coalesces them, each request gets the bits of a
    dedicated transform call."""
    server = fitted.map_server()
    rng = np.random.RandomState(7)
    n_clients, per_client = 4, 3
    reqs = [[(queries(int(rng.randint(1, 3 * MICRO)), 100 + 10 * c + i), 1000 + 10 * c + i)
             for i in range(per_client)] for c in range(n_clients)]
    want = [[server.transform(q, seed=s) for q, s in rs] for rs in reqs]

    batcher = Batcher(server, max_delay_s=0.01)
    got = [[None] * per_client for _ in range(n_clients)]
    errs = []
    start = threading.Barrier(n_clients)

    def client(c):
        try:
            start.wait()
            for i, (q, s) in enumerate(reqs[c]):
                got[c][i] = batcher.project(q, seed=s)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    assert not errs
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert_result_equal(g, w)
    assert batcher.stats.n_requests == n_clients * per_client


def test_batcher_coalesces_backlog_into_full_batches(fitted):
    server = fitted.map_server()
    B = server.batch_rows
    batcher = Batcher(server, max_delay_s=0.5, autostart=False)
    per_req, n_req = B // 4, 8  # 8 × B/4 = 2 full batches
    reqs = [batcher.submit(queries(per_req, 30 + i), seed=i) for i in range(n_req)]
    batcher.start()
    for r in reqs:
        assert r.done.wait(30.0) and r.error is None
    batcher.close()
    assert batcher.stats.n_batches == (n_req * per_req) // B == 2
    assert batcher.stats.batch_fill == 1.0
    assert batcher.stats.n_requests == n_req


def test_batcher_splits_oversize_requests(fitted):
    server = fitted.map_server()
    B = server.batch_rows
    q = queries(2 * B + B // 2, 41)
    batcher = Batcher(server, max_delay_s=0.0)
    try:
        got = batcher.project(q, seed=5)
    finally:
        batcher.close()
    assert_result_equal(got, server.transform(q, seed=5))
    assert len(got.batch_latency_s) >= 3


def test_batcher_closed_rejects_and_drains(fitted):
    batcher = Batcher(fitted.map_server(), max_delay_s=0.2)
    req = batcher.submit(queries(8, 50), seed=0)
    batcher.close(drain=True)  # flushes the partial batch at once
    assert req.done.is_set() and req.error is None
    with pytest.raises(BatcherClosed):
        batcher.submit(queries(4, 51))
    assert batcher.queue_depth() == 0


def test_batcher_return_neighbors_false_matches(fitted):
    server = fitted.map_server()
    q = queries(40, 60)
    batcher = Batcher(server, max_delay_s=0.0)
    try:
        got = batcher.project(q, seed=2, return_neighbors=False)
    finally:
        batcher.close()
    want = server.transform(q, seed=2)
    np.testing.assert_array_equal(got.embedding, want.embedding)
    np.testing.assert_array_equal(got.cells, want.cells)
    assert got.neighbor_ids is None and got.neighbor_dists is None


def test_batcher_reads_config_delay(fitted):
    batcher = Batcher(fitted.map_server())
    try:
        assert batcher.max_delay_s == fitted.cfg.service_max_delay_s == 0.003
    finally:
        batcher.close()


# ---------------------------------------------------------------------------
# Result cache
# ---------------------------------------------------------------------------


def test_cache_hit_skips_device_work_entirely(fitted):
    svc = MapService(device="cpu")
    handle = svc.registry.add(frozen(fitted))
    q = queries(20, 70)
    first = svc.project(q, seed=1)
    assert not first.cache_hit
    batches_after_miss = handle.batcher.stats.n_batches
    second = svc.project(q, seed=1)
    assert second.cache_hit
    assert handle.batcher.stats.n_batches == batches_after_miss
    assert second.result is first.result
    assert svc.metrics.count("project.cache_hits") == 1
    svc.close()


def test_cache_key_sensitivity(fitted):
    fp = map_fingerprint(frozen(fitted))
    q = queries(10, 80)
    base = make_key(fp, q, 0, 4, True)
    assert make_key(fp, q, 0, 4, True) == base
    assert make_key(fp, q, 1, 4, True) != base
    assert make_key(fp, q, 0, 5, True) != base
    assert make_key(fp, q, 0, 4, False) != base
    assert make_key("other-map", q, 0, 4, True) != base
    q2 = q.copy()
    q2[3, 2] += 1e-3
    assert make_key(fp, q2, 0, 4, True) != base
    assert query_fingerprint(np.asfortranarray(q)) == query_fingerprint(q)


def test_cache_lru_eviction():
    cache = ResultCache(capacity=2)
    r = TransformResult(np.zeros((1, 2)), np.zeros(1), None, None)
    ka, kb, kc = ("m", "a", 0, 1, True), ("m", "b", 0, 1, True), ("m", "c", 0, 1, True)
    cache.put(ka, r)
    cache.put(kb, r)
    assert cache.get(ka) is r  # touch a → b is now LRU
    cache.put(kc, r)
    assert cache.get(kb) is None and cache.get(ka) is r and cache.get(kc) is r
    assert len(cache) == 2
    st = cache.stats()
    assert st["hits"] == 3 and st["misses"] == 1


def test_cache_capacity_zero_disables():
    cache = ResultCache(capacity=0)
    k = ("m", "q", 0, 1, True)
    cache.put(k, TransformResult(np.zeros((1, 2)), np.zeros(1), None, None))
    assert cache.get(k) is None and len(cache) == 0
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=-1)


# ---------------------------------------------------------------------------
# Registry + hot swap
# ---------------------------------------------------------------------------


def test_registry_versioning_and_activation(fitted):
    reg = MapRegistry(device="cpu")
    fz = frozen(fitted)
    h1 = reg.add(fz, warm=False)
    h2 = reg.add(fz, warm=False, activate=False)
    assert (h1.version, h2.version) == ("v1", "v2")
    assert reg.active_version == "v1"
    assert [d["active"] for d in reg.versions()] == [True, False]
    reg.activate("v2")
    assert reg.get().version == "v2"
    with pytest.raises(KeyError, match="unknown map version"):
        reg.get("v9")
    with pytest.raises(ValueError, match="refusing to retire the active"):
        reg.retire("v2")
    reg.retire("v1")
    assert [d["version"] for d in reg.versions()] == ["v2"]
    with pytest.raises(ValueError, match="already registered"):
        reg.add(fz, version="v2", warm=False)
    with pytest.raises(ValueError, match="server options"):
        reg.add(MapServer(fz), warm=False, steps=2)
    reg.close()
    with pytest.raises(RuntimeError, match="no active map"):
        reg.get()


def test_map_fingerprint_is_content_derived(fitted, fitted_b):
    est_b, ckdir_b = fitted_b
    fz_a, fz_b = frozen(fitted), frozen(est_b)
    assert map_fingerprint(fz_a) == map_fingerprint(frozen(fitted))
    assert map_fingerprint(fz_a) != map_fingerprint(fz_b)
    # the checkpoint of b serves the same content
    assert map_fingerprint(FrozenMap.from_checkpoint(ckdir_b, device="cpu")) == map_fingerprint(fz_b)


def test_hot_swap_under_concurrent_load(fitted, fitted_b):
    """Clients hammer project() while the registry swaps v1 → v2 (a port
    checkpoint) and retires v1: no request errors or is dropped, and every
    response equals a direct transform on the version it names."""
    est_b, ckdir_b = fitted_b
    svc = MapService(cache_entries=0, device="cpu")  # every request reaches a batcher
    svc.registry.add(frozen(fitted), version="v1")
    servers = {"v1": fitted.map_server(), "v2": est_b.map_server()}

    n_threads = 4
    results = [[] for _ in range(n_threads)]
    errs = []
    start = threading.Barrier(n_threads + 1)
    stop = threading.Event()  # set only after the swap has completed

    def client(t):
        try:
            start.wait()
            i, tail_after_stop = 0, 0
            # keep firing until the swap is done, then two more requests
            # that must be served by v2
            while tail_after_stop < 2 and i < 5000:
                stopped = stop.is_set()
                seed = t * 1000 + i
                q = queries(11 + (7 * t + i) % 40, seed)
                results[t].append((q, seed, svc.project(q, seed=seed)))
                i += 1
                if stopped:
                    tail_after_stop += 1
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    handle = svc.registry.swap(ckdir_b, version="v2")  # load + warm + activate + retire v1
    assert handle.version == "v2" and svc.registry.active_version == "v2"
    assert handle.source == ckdir_b
    stop.set()
    for t in threads:
        t.join()

    assert not errs
    versions_seen = set()
    for bucket in results:
        assert len(bucket) >= 2
        for q, seed, out in bucket:
            versions_seen.add(out.map_version)
            want = servers[out.map_version].transform(q, seed=seed)
            np.testing.assert_array_equal(out.result.embedding, want.embedding)
            np.testing.assert_array_equal(out.result.neighbor_ids, want.neighbor_ids)
        assert bucket[-1][2].map_version == "v2"
    assert "v2" in versions_seen
    assert [d["version"] for d in svc.registry.versions()] == ["v2"]
    svc.close()


def test_swap_retry_on_retired_handle(fitted, fitted_b):
    _, ckdir_b = fitted_b
    svc = MapService(cache_entries=0, device="cpu")
    svc.registry.add(frozen(fitted), version="v1")
    h2 = svc.registry.load(ckdir_b, version="v2", activate=True)
    old = svc.registry.get("v1")
    svc.registry.retire("v1")
    with pytest.raises(BatcherClosed):
        old.batcher.project(queries(4, 90), seed=0)
    out = svc.project(queries(4, 90), seed=0)
    assert out.map_version == "v2"
    with pytest.raises(KeyError, match="unknown map version"):
        svc.project(queries(4, 91), seed=0, map_version="v1")
    assert h2.batcher.stats.n_errors == 0
    svc.close()


def test_load_lineage_serves_each_version(tmp_path):
    """A lineage grown on the port (fit → v1 → v2): ``load_lineage`` serves
    the newest version by default and any named one, each ≡ the
    estimator's transform at that version."""
    root = str(tmp_path / "lineage")
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    est = NomadProjection(CFG.replace(checkpoint_dir=root), device="cpu")
    est.fit(x)
    q = queries(30, 97)
    want = {"v0": est.map_server().transform(q, seed=2)}
    for name, seed in (("v1", 5), ("v2", 6)):
        pf = est.partial_fit(queries(80, seed))
        assert pf.version == name
        want[name] = est.map_server().transform(q, seed=2)
    assert [v.name for v in MapLineage(root).load()] == ["v0", "v1", "v2"]
    svc = MapService(device="cpu")
    try:
        newest = svc.registry.load_lineage(root)
        assert newest.version == "v2" and newest.frozen.n_points == N + 160
        first = svc.registry.load_lineage(root, map_version="v0", activate=False)
        assert first.version == "v0" and first.frozen.n_points == N
        for name in ("v0", "v2"):
            got = svc.project(q, seed=2, map_version=name)
            assert got.map_version == name
            assert_result_equal(got.result, want[name])
        relabelled = svc.registry.load_lineage(root, map_version="v1", version="grown-1", activate=False)
        assert_result_equal(svc.project(q, seed=2, map_version="grown-1").result, want["v1"])
        assert relabelled.source == MapLineage(root).resolve("v1").path
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Service-level plumbing
# ---------------------------------------------------------------------------


def test_service_validation_gate(fitted):
    svc = MapService(device="cpu")
    svc.registry.add(frozen(fitted))
    with pytest.raises(ValueError, match="dim"):
        svc.project(np.zeros((4, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        svc.project(np.full((4, DIM), np.nan, np.float32))
    with pytest.raises(ValueError, match="float64"):
        svc.project(np.zeros((4, DIM), np.float64))
    with pytest.raises(ValueError, match="transform_steps"):
        svc.project(queries(4, 95), steps=CFG.transform_steps + 1)
    svc.close()


def test_metrics_snapshot_shape(fitted):
    svc = MapService(device="cpu")
    svc.registry.add(frozen(fitted))
    q = queries(8, 96)
    svc.project(q, seed=0)
    svc.project(q, seed=0)  # hit
    snap = svc.metrics_snapshot()
    assert snap["counters"]["project.requests"] == 2
    assert snap["counters"]["project.cache_hits"] == 1
    assert snap["cache"]["hits"] == 1 and snap["cache"]["misses"] == 1
    lat = snap["latency"]["project"]
    assert lat["count"] == 2 and lat["p50_s"] > 0 and lat["p99_s"] >= lat["p50_s"]
    (version,) = snap["maps"]
    per_map = snap["maps"][version]
    assert per_map["active"] and per_map["queue_depth"] == 0
    assert per_map["n_batches"] >= 1 and 0 < per_map["batch_fill"] <= 1.0
    assert per_map["batch_p50_s"] > 0
    assert snap["active_map"] == version
    svc.close()


def test_service_config_validation():
    with pytest.raises(ValueError, match="service_max_delay_s"):
        NomadConfig(service_max_delay_s=-0.1)
    with pytest.raises(ValueError, match="service_cache_entries"):
        NomadConfig(service_cache_entries=-1)


def test_service_imports_without_fastapi():
    """``import repro_torch.service`` needs no fastapi; ``create_app()``
    raises the install hint (fastapi hidden, whether or not installed)."""
    code = (
        "import sys\n"
        "sys.modules['fastapi'] = None\n"
        "sys.modules['pydantic'] = None\n"
        "import repro_torch.service as s\n"
        "from repro_torch.service import app\n"
        "assert not app.HAVE_FASTAPI\n"
        "try:\n"
        "    s.create_app()\n"
        "except RuntimeError as e:\n"
        "    print(e)\n"
        "else:\n"
        "    sys.exit(1)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "pip install 'repro-nomad[service]'" in out.stdout


# ---------------------------------------------------------------------------
# Against the JAX package's service
# ---------------------------------------------------------------------------


def test_project_matches_jax_on_jax_checkpoint(jax_ck):
    """The RNG-free service path (steps=0) on one JAX-written checkpoint:
    equal cells and neighbour ids, embedding and distances within 1e-5."""
    q = queries(70, 99)
    jsvc, psvc = JaxMapService(), MapService(device="cpu")
    try:
        jsvc.registry.load(jax_ck, steps=0)
        psvc.registry.load(jax_ck, steps=0)
        want = jsvc.project(q, seed=4)
        got = psvc.project(q, seed=4)
        assert got.map_fingerprint == want.map_fingerprint
        assert got.map_version == want.map_version == "v1"
        g, w = got.result, want.result
        np.testing.assert_array_equal(g.cells, w.cells)
        np.testing.assert_array_equal(g.neighbor_ids, w.neighbor_ids)
        np.testing.assert_allclose(g.embedding, w.embedding, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.neighbor_dists, w.neighbor_dists, rtol=1e-5, atol=1e-5)
        assert (g.strategy, g.n_shards, g.steps, g.n_queries) == (w.strategy, w.n_shards, w.steps, w.n_queries)
    finally:
        jsvc.close()
        psvc.close()


def test_fingerprints_and_keys_match_jax(jax_ck):
    jfz = JaxFrozenMap.from_checkpoint(jax_ck)
    fz = FrozenMap.from_checkpoint(jax_ck, device="cpu")
    assert map_fingerprint(fz) == jax_map_fingerprint(jfz)
    rng = np.random.default_rng(3)
    small = rng.normal(size=(17, DIM)).astype(np.float32)
    big = rng.normal(size=(EXACT_FINGERPRINT_ROWS + 1, 2)).astype(np.float32)  # the sampled scheme
    for q in (small, big, np.asfortranarray(small)):
        assert query_fingerprint(q) == jax_query_fingerprint(q)
    for args in ((0, 4, True), (7, 0, False)):
        assert make_key(map_fingerprint(fz), small, *args) == jax_make_key(jax_map_fingerprint(jfz), small, *args)


def _keys(body):
    """The nested key structure of a JSON-like body."""
    if isinstance(body, dict):
        return {k: _keys(v) for k, v in body.items()}
    if isinstance(body, list):
        return [_keys(v) for v in body]
    return None


def test_introspection_keys_match_jax(jax_ck):
    q = queries(9, 98)
    jsvc, psvc = JaxMapService(), MapService(device="cpu")
    try:
        for svc in (jsvc, psvc):
            svc.registry.load(jax_ck, version="v1")
            svc.project(q, seed=0)
            svc.project(q, seed=0)
        assert _keys(psvc.registry.get().describe()) == _keys(jsvc.registry.get().describe())
        assert _keys(psvc.health()) == _keys(jsvc.health())
        assert _keys(psvc.maps()) == _keys(jsvc.maps())
        assert _keys(psvc.metrics_snapshot()) == _keys(jsvc.metrics_snapshot())
        assert psvc.health() == jsvc.health()
        pd, jd = psvc.registry.get().describe(), jsvc.registry.get().describe()
        for k in ("version", "fingerprint", "n_points", "dim", "out_dim", "n_clusters", "steps", "strategy",
                  "n_shards", "microbatch", "batch_rows", "has_inverse"):
            assert pd[k] == jd[k], k
    finally:
        jsvc.close()
        psvc.close()
