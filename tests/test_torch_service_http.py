"""The port's HTTP skin (``repro_torch.service.app.create_app``): the
endpoint contracts of ``tests/test_service_http.py`` over the port's
service, on a port fit on the CPU.

Skipped wholesale where fastapi (and httpx, the test client's transport)
is not installed; ``tests/test_torch_service.py`` checks that the service
imports without it and that ``create_app()`` raises the install hint.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
fastapi = pytest.importorskip("fastapi")
pytest.importorskip("httpx")  # fastapi.testclient's transport

from fastapi.testclient import TestClient  # noqa: E402

from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.serve import FrozenMap  # noqa: E402
from repro_torch.service import MapService  # noqa: E402
from repro_torch.service.app import create_app  # noqa: E402

N, DIM = 600, 8

CFG = NomadConfig(
    n_points=N,
    dim=DIM,
    n_clusters=4,
    n_neighbors=5,
    n_noise=8,
    n_exact_negatives=4,
    batch_size=128,
    n_epochs=2,
    serve_microbatch=32,
    transform_steps=4,
)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("http") / "ck")
    x, _ = gaussian_mixture(N, DIM, n_components=4, seed=0)
    est = NomadProjection(CFG.replace(checkpoint_dir=ckdir), device="cpu")
    est.fit(x)
    return est, ckdir


@pytest.fixture()
def service(fitted):
    est, _ = fitted
    svc = MapService(device="cpu")
    svc.registry.add(FrozenMap.from_fit(est._fit_result, est.cfg, device="cpu"), version="v1")
    yield svc
    svc.close()


@pytest.fixture()
def client(service):
    with TestClient(create_app(service)) as c:
        yield c


def rows(n, seed):
    q, _ = gaussian_mixture(n, DIM, n_components=4, seed=seed)
    return q


def test_health_ok_and_empty(client):
    body = client.get("/health").json()
    assert body["status"] == "ok" and body["active_map"] == "v1"
    empty = TestClient(create_app(MapService(device="cpu")))
    r = empty.get("/health")
    assert r.status_code == 503 and r.json()["detail"]["status"] == "empty"


def test_project_roundtrip_equals_direct(client, fitted):
    est, _ = fitted
    q = rows(20, 5)
    r = client.post("/project", json={"rows": q.tolist(), "seed": 3})
    assert r.status_code == 200
    body = r.json()
    want = est.map_server().transform(q, seed=3)
    np.testing.assert_array_equal(
        np.asarray(body["embedding"], np.float32), want.embedding
    )
    np.testing.assert_array_equal(np.asarray(body["cells"]), want.cells)
    np.testing.assert_array_equal(np.asarray(body["neighbor_ids"]), want.neighbor_ids)
    # dead edges (-1 ids) marshal their inf distances as -1.0, live ones exact
    dists = np.asarray(body["neighbor_dists"], np.float32)
    ids = np.asarray(body["neighbor_ids"])
    np.testing.assert_array_equal(dists[ids >= 0], want.neighbor_dists[ids >= 0])
    assert (dists[ids < 0] == -1.0).all()
    assert body["map_version"] == "v1" and not body["cache_hit"]
    assert body["n_queries"] == 20 and body["n_batches"] >= 1


def test_project_cache_hit_and_placement_only(client):
    q = rows(10, 6)
    a = client.post("/project", json={"rows": q.tolist(), "seed": 0}).json()
    b = client.post("/project", json={"rows": q.tolist(), "seed": 0}).json()
    assert not a["cache_hit"] and b["cache_hit"]
    assert b["embedding"] == a["embedding"]
    c = client.post(
        "/project",
        json={"rows": q.tolist(), "seed": 0, "return_neighbors": False},
    ).json()
    assert "neighbor_ids" not in c and c["embedding"] == a["embedding"]


def test_project_error_codes(client):
    bad_dim = rows(4, 7)[:, :-1]
    r = client.post("/project", json={"rows": bad_dim.tolist()})
    assert r.status_code == 400 and "dim" in r.json()["detail"]
    r = client.post(
        "/project", json={"rows": rows(4, 7).tolist(), "map_version": "nope"}
    )
    assert r.status_code == 404
    r = client.post("/project", json={"rows": []})
    assert r.status_code == 400


def test_maps_listing_and_swap_endpoint(client, fitted):
    _, ckdir = fitted
    body = client.get("/maps").json()
    assert body["active"] == "v1" and len(body["maps"]) == 1
    assert body["maps"][0]["n_points"] == N

    r = client.post("/maps", json={"checkpoint_dir": ckdir, "version": "v2"})
    assert r.status_code == 200 and r.json()["activated"] == "v2"
    body = client.get("/maps").json()
    assert body["active"] == "v2"
    # retire_old drained and dropped v1
    assert [m["version"] for m in body["maps"]] == ["v2"]

    r = client.post("/maps", json={"checkpoint_dir": "/nonexistent/ck"})
    assert r.status_code == 400


def test_activate_endpoint(client, fitted):
    _, ckdir = fitted
    client.post(
        "/maps",
        json={"checkpoint_dir": ckdir, "version": "v2", "retire_old": False},
    )
    r = client.post("/maps/v1/activate")
    assert r.status_code == 200 and r.json()["activated"] == "v1"
    assert client.get("/maps").json()["active"] == "v1"
    assert client.post("/maps/v9/activate").status_code == 404


def test_metrics_endpoint_counts_and_latency(client):
    q = rows(6, 8)
    client.post("/project", json={"rows": q.tolist()})
    client.post("/project", json={"rows": q.tolist()})
    client.get("/health")
    m = client.get("/metrics").json()
    assert m["counters"]["http./project"] == 2
    assert m["counters"]["http./health"] == 1
    assert m["counters"]["project.cache_hits"] == 1
    assert m["cache"]["size"] == 1
    assert m["active_map"] == "v1"
    v1 = m["maps"]["v1"]
    assert v1["active"] and v1["n_batches"] >= 1 and 0 < v1["batch_fill"] <= 1
    assert m["latency"]["project"]["count"] == 2
