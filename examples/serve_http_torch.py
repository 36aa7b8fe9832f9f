"""Serving a map over HTTP on the PyTorch port: fit → checkpoint → uvicorn →
POST /project.

    PYTHONPATH=src python examples/serve_http_torch.py [--n 5000] [--port 8787] [--device cpu]

``examples/serve_http.py`` on ``repro_torch``, flag for flag and line for
line: fit once with a checkpoint dir, build the service (registry + result
cache + batching engine) from the checkpoint alone, run the FastAPI app
under uvicorn in a background thread on localhost and talk to it with
plain ``urllib.request`` POSTs. Verifies that the HTTP round trip returns
exactly the placements of an in-process ``MapServer.transform``, shows a
warm cache hit and dumps ``/metrics``. It runs on the card unless
``--device`` names another device.

Needs fastapi and uvicorn; prints a pointer and exits 0 without them, so
smoke harnesses can always run it.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np


def http_json(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5_000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    try:
        import uvicorn  # noqa: F401
        from repro_torch.service.app import create_app
    except ImportError:
        print("this example needs the HTTP extras: pip install -e '.[service]'")
        return 0

    from repro_torch.configs.base import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.serve import FrozenMap, MapServer
    from repro_torch.service import MapService

    # -- 1. fit with a checkpoint dir ----------------------------------------
    ckdir = os.path.join(tempfile.mkdtemp(prefix="nomad_http_"), "ck")
    comps = 8
    x, _ = gaussian_mixture(args.n, args.dim, n_components=comps, seed=0)
    cfg = NomadConfig(
        n_points=args.n, dim=args.dim,
        n_clusters=args.clusters, n_neighbors=15,
        n_epochs=args.epochs, batch_size=min(1024, args.n),
        checkpoint_dir=ckdir,
        serve_microbatch=args.microbatch,
    )
    print(f"fitting {args.n} points … (checkpoints → {ckdir})")
    NomadProjection(cfg, device=args.device).fit(x)
    del x  # the service below never sees the training data

    # -- 2. service from the checkpoint alone, uvicorn in a thread -----------
    svc = MapService(device=args.device)
    svc.registry.load(ckdir, version="v1")
    server = uvicorn.Server(
        uvicorn.Config(
            create_app(svc), host="127.0.0.1", port=args.port, log_level="warning"
        )
    )
    threading.Thread(target=server.run, daemon=True).start()
    base = f"http://127.0.0.1:{args.port}"
    for _ in range(100):
        if server.started:
            break
        time.sleep(0.05)
    health = http_json("GET", f"{base}/health")
    print(f"serving {base}: {health}")

    # -- 3. clients: POST /project, verify against the in-process path -------
    q, _ = gaussian_mixture(args.queries, args.dim, n_components=comps, seed=99)
    t0 = time.time()
    body = http_json("POST", f"{base}/project", {"rows": q.tolist(), "seed": 7})
    wall = time.time() - t0
    got = np.asarray(body["embedding"], np.float32)
    want = MapServer(FrozenMap.from_checkpoint(ckdir, device=args.device)).transform(q, seed=7)
    np.testing.assert_array_equal(got, want.embedding)
    print(f"POST /project: {body['n_queries']} rows in {wall * 1e3:.0f}ms "
          f"({body['n_batches']} device batches) — bit-equal to in-process transform")

    t0 = time.time()
    again = http_json("POST", f"{base}/project", {"rows": q.tolist(), "seed": 7})
    print(f"again: cache_hit={again['cache_hit']} in {(time.time() - t0) * 1e3:.0f}ms")
    assert again["cache_hit"] and again["embedding"] == body["embedding"]

    m = http_json("GET", f"{base}/metrics")
    v1 = m["maps"]["v1"]
    print(f"/metrics: {m['counters']} "
          f"| batch_fill={v1['batch_fill']:.2f} n_batches={v1['n_batches']}")

    server.should_exit = True
    svc.close()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
