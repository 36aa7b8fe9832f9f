"""Distributed NOMAD Projection on the PyTorch port, on 8 shard slots of one
device (paper Fig. 2).

    PYTHONPATH=src python examples/distributed_map_torch.py [--hierarchical] [--device cpu]

``examples/distributed_map.py`` on ``repro_torch``, line for line: clusters
sharded across a (data=2, model=4) mesh, or a (pod=2, data=2, model=2)
mesh with the hierarchical super-mean exchange when ``--hierarchical`` is
given, with the per-epoch means all-gather as the only exchange. The 8
"devices" are 8 shard slots of one device (``launch.mesh.set_local_slots``,
the counterpart of XLA's forced host devices), which run one after another.
Compares quality and wall time against the single-device fit on the same
index. It runs on the card unless ``--device`` names another device.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import NomadConfig
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.runtime import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.index import build_index
    from repro_torch.launch.mesh import make_mesh, set_local_slots
    from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy

    device = resolve_device(args.device)
    set_local_slots(8)
    hier = args.hierarchical
    n, dim = 12_000, 64
    x, labels = gaussian_mixture(n, dim, n_components=10, seed=0)
    cfg = NomadConfig(
        n_points=n, dim=dim, n_clusters=16, n_neighbors=15, n_noise=48,
        n_exact_negatives=8, batch_size=1024, n_epochs=30,
    )
    print("building index …")
    index = build_index(x, cfg, device=device)

    print("single-device reference …")
    t0 = time.time()
    ref = NomadProjection(cfg, strategy="local", device=device).fit(x, index=index)
    t_ref = time.time() - t0

    # same estimator, different execution strategy: two keyword arguments
    if hier:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device=device)
        proj = NomadProjection(cfg, strategy="hierarchical", mesh=mesh, pod_axis="pod", device=device)
        print("8 shards, hierarchical (pod super-means across the slow axis) …")
    else:
        mesh = make_mesh((2, 4), ("data", "model"), device=device)
        proj = NomadProjection(cfg, strategy="sharded", mesh=mesh, device=device)
        print("8 shards, flat mean exchange (the paper's strategy) …")
    t0 = time.time()
    dist = proj.fit(x, index=index)
    t_dist = time.time() - t0
    print(f"ran as strategy={dist.strategy} on mesh {dist.mesh_shape} "
          f"({dist.n_shards} shards)")

    for name, e, t in (("1-device", ref.embedding, t_ref), ("8-shard", dist.embedding, t_dist)):
        np10 = neighborhood_preservation(x, e, k=10, n_queries=800, device=device)
        rta = random_triplet_accuracy(x, e, 20_000)
        print(f"{name:9s}: {t:6.1f}s  NP@10={np10:.4f}  triplet={rta:.4f}")
    print("(the 8 shard slots share one device and run one after another — "
          "wall-clock parity is the expectation here; on 8 cards the 8-shard "
          "fit runs its shards side by side)")


if __name__ == "__main__":
    main()
