"""Serving a map on the PyTorch port: fit → checkpoint → frozen MapServer →
transform.

    PYTHONPATH=src python examples/serve_map_torch.py [--n 10000] [--queries 2000] [--device cpu]

``examples/serve_map.py`` on ``repro_torch``, flag for flag and line for
line: fit once with a checkpoint dir, bring up a server from the
checkpoint alone (no training array in sight) and place unseen points on
the frozen map with ``transform``. Prints per-batch placement latency and
checks that queries drawn from the training distribution land among their
high-dim neighbours. It runs on the card unless ``--device`` names another
device.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.configs.base import NomadConfig
from repro_torch.core.nomad import NomadProjection
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.serve import FrozenMap, MapServer


def main(argv=None):
    """Run the example; returns what it built (``cfg``, the corpus ``x``,
    the ``fit``, the ``frozen`` map, the ``queries`` and their ``placed``
    rows) for a caller that checks it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=512)
    ap.add_argument("--checkpoint-dir", default="", help="default: a temp dir")
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    ckdir = args.checkpoint_dir or os.path.join(
        tempfile.mkdtemp(prefix="nomad_serve_"), "ck"
    )
    comps = 12
    x, _ = gaussian_mixture(args.n, args.dim, n_components=comps, seed=0)

    # -- 1. fit with a checkpoint dir (θ + index cache land beside it) -------
    cfg = NomadConfig(
        n_points=args.n, dim=args.dim,
        n_clusters=args.clusters, n_neighbors=15,
        n_epochs=args.epochs, batch_size=min(1024, args.n),
        checkpoint_dir=ckdir,
        serve_microbatch=args.microbatch,
    )
    print(f"fitting {args.n} points … (checkpoints → {ckdir})")
    res = NomadProjection(cfg, device=args.device).fit(x)
    print(f"fit done in {res.wall_time_s:.1f}s, loss {res.losses[-1]:.4f}")
    built = {"cfg": cfg, "x": x, "fit": res}
    del x, res  # the server below never sees the training data

    # -- 2. bring up a server from the checkpoint alone ----------------------
    frozen = FrozenMap.from_checkpoint(ckdir, device=args.device)
    server = MapServer(frozen)
    print(f"serving: strategy={server.strategy}, shards={server.n_shards}, "
          f"microbatch={server.microbatch}, steps={server.steps}")

    # -- 3. place unseen points ----------------------------------------------
    q, _ = gaussian_mixture(args.queries, args.dim, n_components=comps, seed=99)
    out = server.transform(q, seed=0)
    lat = 1e3 * np.asarray(out.batch_latency_s)
    print(f"placed {out.n_queries} queries in {out.wall_time_s:.2f}s "
          f"({len(lat)} batches: p50 {np.percentile(lat, 50):.1f}ms, "
          f"max {lat.max():.1f}ms, "
          f"{out.n_queries / out.wall_time_s:.0f} pts/s)")

    # each query's placement should sit inside its frozen kNN's 2-D spread
    emb_rows = frozen.theta_rows.cpu().numpy()
    live = out.neighbor_ids >= 0
    inv = frozen.inv_perm.cpu().numpy()
    pos = {int(o): r for r, o in enumerate(inv) if o >= 0}
    ok = 0
    for b in range(out.n_queries):
        ids = out.neighbor_ids[b][live[b]]
        nb = emb_rows[[pos[int(i)] for i in ids]]
        radius = np.linalg.norm(nb - nb.mean(0), axis=1).max()
        ok += np.linalg.norm(out.embedding[b] - nb.mean(0)) <= 3 * radius + 1e-9
    frac = ok / out.n_queries
    print(f"{frac:.1%} of placements within 3× their neighborhood radius")
    assert frac > 0.9, "placements drifted off their frozen neighborhoods"
    assert np.isfinite(out.embedding).all()
    print("OK")
    return {**built, "frozen": frozen, "queries": q, "placed": out.embedding}


if __name__ == "__main__":
    main()
