"""Quickstart on the PyTorch port: map a synthetic embedding corpus with
NOMAD Projection.

    PYTHONPATH=src python examples/quickstart_torch.py [--n 10000] [--epochs 40] [--device cpu]

``examples/quickstart.py`` on ``repro_torch``, flag for flag and line for
line: the LSH-initialised K-means ANN index, the NOMAD optimisation (PCA
init, lr n/10 linearly annealed, the paper's §3.4 recipe) through the
``NomadProjection`` estimator (``strategy="auto"`` picks local or sharded
from the shard slots), progress through the event API, NP@10 / triplet
accuracy, and an ASCII density sketch of the map. It runs on the card
unless ``--device`` names another device.

The ``--n 1500 --epochs 4`` point is the CI smoke test.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.configs.base import NomadConfig
from repro_torch.core.nomad import NomadProjection
from repro_torch.core.strategy import FitCallbacks
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy


def ascii_density(emb: np.ndarray, labels: np.ndarray, w: int = 72, h: int = 24) -> str:
    gx = np.clip(((emb[:, 0] - emb[:, 0].min()) / np.ptp(emb[:, 0]) * (w - 1)), 0, w - 1).astype(int)
    gy = np.clip(((emb[:, 1] - emb[:, 1].min()) / np.ptp(emb[:, 1]) * (h - 1)), 0, h - 1).astype(int)
    grid = np.full((h, w), " ", dtype="<U1")
    glyphs = "0123456789abcdefghijklmnop"
    for x, y, l in zip(gx, gy, labels):
        grid[y, x] = glyphs[l % len(glyphs)]
    return "\n".join("".join(row) for row in grid)


class Progress(FitCallbacks):
    """Structured fit events: loss curve + checkpoint notices."""

    wants_embedding = False  # loss/time only — skip the per-epoch host copy

    def on_epoch_end(self, ev):
        if ev.epoch % 10 == 0 or ev.epoch == ev.n_epochs - 1:
            print(f"  epoch {ev.epoch:3d}/{ev.n_epochs}  loss {ev.loss:.4f}  "
                  f"({ev.time_s:.2f}s, {ev.strategy})")

    def on_checkpoint(self, ev):
        print(f"  checkpoint @ epoch {ev.epoch} → {ev.directory}")


def main(argv=None):
    """Run the example; returns what it built (``cfg``, the corpus ``x``,
    the estimator ``est`` and its ``fit``) for a caller that checks it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--checkpoint-dir", default="", help="enable checkpoint/resume")
    ap.add_argument(
        "--store", action="store_true",
        help="round-trip the corpus through a sharded on-disk store and fit "
        "from disk (the larger-than-RAM ingestion path; same map bit-for-bit "
        "when cfg.chunk_rows matches)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    n, dim, comps = args.n, args.dim, 12
    print(f"generating {n} points, {dim}-d, {comps} clusters …")
    x, labels = gaussian_mixture(n, dim, n_components=comps, seed=0)

    cfg = NomadConfig(
        n_points=n, dim=dim,
        n_clusters=args.clusters, n_neighbors=15,    # §3.2 index
        n_noise=48, n_exact_negatives=8,             # §3.3 loss
        batch_size=min(1024, n), n_epochs=args.epochs,  # §3.4 schedule (lr0 = n/10)
        strategy="auto",                             # local vs sharded, from the slots
        checkpoint_dir=args.checkpoint_dir,
    )
    fit_input = x
    if args.store:
        import tempfile

        from repro_torch.data.store import write_sharded

        store_dir = tempfile.mkdtemp(prefix="quickstart-store-")
        fit_input = write_sharded(x, store_dir, rows_per_shard=4096)
        print(f"fitting from disk-backed store at {store_dir} "
              f"({len(fit_input._files)} shards) …")
    print("fitting NOMAD Projection …")
    est = NomadProjection(cfg, device=args.device)
    res = est.fit(fit_input, callbacks=Progress())
    if args.store:
        assert res.index_build_strategy == "streamed", res.index_build_strategy
    print(f"done in {res.wall_time_s:.1f}s "
          f"({np.mean(res.epoch_times[1:] or res.epoch_times):.2f}s/epoch after warmup) "
          f"[strategy={res.strategy}, shards={res.n_shards}]")
    print(f"loss {res.losses[0]:.4f} → {res.losses[-1]:.4f}")

    np10 = neighborhood_preservation(x, res.embedding, k=10, n_queries=min(1000, n), device=est.device)
    rta = random_triplet_accuracy(x, res.embedding, 20_000)
    print(f"NP@10 = {np10:.4f}   random-triplet accuracy = {rta:.4f}")
    chance = 10 / n
    assert np10 > 3 * chance, f"map no better than chance (NP@10={np10:.4f})"
    assert np.isfinite(res.embedding).all()
    print("\nmap (digits = cluster labels):")
    print(ascii_density(res.embedding, labels))
    print("OK")
    return {"cfg": cfg, "x": x, "est": est, "fit": res}


if __name__ == "__main__":
    main()
