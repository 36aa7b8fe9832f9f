"""Multi-slot correctness selftest of the NOMAD side (port of the JAX
package's ``launch/selftest.py``), on 8 shard slots of one device:

    python -m repro_torch.launch.selftest                 # on the card
    python -m repro_torch.launch.selftest --device cpu

Checks, with the reference's data, config and bounds:
  1. the sharded (2, 4) fit's quality ≈ the local fit's on the same index
     (the paper's multi-GPU ≈ single-GPU claim);
  2. the sharded fit is deterministic (run twice → bit-identical);
  2b. the deprecated ``fit_distributed`` shim still serves its tuple;
  3. the hierarchical (2, 2, 2) fit runs, stays finite and near the local
     quality, and its flat counterpart on the same mesh runs;
  4. ``kmeans_fit_sharded`` over 8 row blocks ≡ single-slot EM (err < 1e-2).

Part 4 hands ``kmeans_fit_sharded`` the row blocks it takes; the
reference's part 4 passes an array placed outside a mesh context, which
jax 0.9 refuses, and has no counterpart here. Prints ``SELFTEST PASS``.
"""

from __future__ import annotations

import argparse
import sys
import warnings

import numpy as np

SLOTS = 8


def run(device=None, *, keep: bool = False) -> dict:
    """The four parts on ``SLOTS`` slots of ``device`` (default: the card);
    raises AssertionError on a failed check. Returns the measured values,
    and with ``keep`` also, under ``"kept"``, what the parts ran on (the
    config, data, index, meshes, fits and part 4's row blocks and
    centroids), so that a caller can check the kernels on those inputs."""
    import torch

    from repro_torch.configs.base import NomadConfig
    from repro_torch.core.distributed import fit_distributed
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.runtime import resolve_device
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.index.ann import build_index
    from repro_torch.index.kmeans import em_loop, kmeans_fit_sharded, lsh_init_centroids
    from repro_torch.launch.mesh import local_slot_count, make_mesh, set_local_slots
    from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy

    device = resolve_device(device)
    slots_before = local_slot_count()
    set_local_slots(SLOTS)
    out: dict = {}
    try:
        x, _labels = gaussian_mixture(8000, 32, n_components=8, seed=0)
        cfg = NomadConfig(n_points=8000, dim=32, n_clusters=16, n_neighbors=10, n_noise=32,
                          n_exact_negatives=8, batch_size=1024, n_epochs=15)
        index = build_index(x, cfg, device=device)

        # 1. quality parity
        ref = NomadProjection(cfg, strategy="local", device=device).fit(x, index=index)
        np_ref = neighborhood_preservation(x, ref.embedding, k=10, n_queries=400, device=device)
        mesh = make_mesh((2, 4), ("data", "model"), device=device)
        dist = NomadProjection(cfg, strategy="sharded", mesh=mesh, shard_axes=("data", "model"),
                               device=device).fit(x, index=index)
        emb = dist.embedding
        assert dist.strategy == "sharded" and dist.n_shards == 8, dist
        assert np.isfinite(emb).all(), "distributed embedding has NaNs"
        np_dist = neighborhood_preservation(x, emb, k=10, n_queries=400, device=device)
        rta_ref = random_triplet_accuracy(x, ref.embedding, 4000)
        rta_dist = random_triplet_accuracy(x, emb, 4000)
        print(f"NP@10 ref={np_ref:.4f} dist={np_dist:.4f}; RTA ref={rta_ref:.3f} dist={rta_dist:.3f}", flush=True)
        assert np_dist > 0.5 * np_ref - 0.01, (np_ref, np_dist)
        assert rta_dist > 0.8 * rta_ref, (rta_ref, rta_dist)
        out.update(np_ref=np_ref, np_dist=np_dist, rta_ref=rta_ref, rta_dist=rta_dist)

        # 2. determinism
        emb2 = NomadProjection(cfg, strategy="sharded", mesh=mesh, shard_axes=("data", "model"),
                               device=device).fit_transform(x, index=index)
        assert np.array_equal(emb, emb2), "distributed run is not deterministic"
        print("determinism: OK", flush=True)

        # 2b. the deprecation shim still serves the legacy tuple
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            emb_shim, _, _ = fit_distributed(cfg.replace(n_epochs=2), x, mesh, index=index, device=device)
        assert any(issubclass(w.category, DeprecationWarning) for w in caught)
        assert np.isfinite(emb_shim).all()
        print("fit_distributed shim: OK (DeprecationWarning emitted)", flush=True)

        # 3. hierarchical multi-pod
        mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device=device)
        hier = NomadProjection(cfg, strategy="hierarchical", mesh=mesh3, shard_axes=("data", "model"),
                               pod_axis="pod", device=device).fit(x, index=index)
        emb_h = hier.embedding
        assert hier.strategy == "hierarchical" and hier.n_shards == 8, hier
        assert np.isfinite(emb_h).all()
        np_h = neighborhood_preservation(x, emb_h, k=10, n_queries=400, device=device)
        print(f"hierarchical NP@10={np_h:.4f} (flat dist={np_dist:.4f})", flush=True)
        assert np_h > 0.4 * np_ref - 0.01, (np_ref, np_h)
        out["np_hier"] = np_h
        emb_f = NomadProjection(cfg, strategy="sharded", mesh=mesh3, shard_axes=("data", "model"),
                                pod_axis="pod", device=device).fit_transform(x, index=index)
        assert np.isfinite(emb_f).all()

        # 4. distributed k-means ≡ single-slot EM
        mesh1 = make_mesh((SLOTS,), ("data",), device=device)
        xd = torch.from_numpy(x).to(device)
        rows = x.shape[0] // SLOTS
        blocks = [xd[i * rows : (i + 1) * rows] for i in mesh1.local_indices()]
        cents_d = kmeans_fit_sharded(torch.Generator(device=device).manual_seed(0), blocks, 16, mesh1, n_iters=5)
        cents0 = lsh_init_centroids(torch.Generator(device=device).manual_seed(0), xd, 16)
        cents = em_loop(xd, cents0, 16, 5, 0.0, xd.shape[0])
        err = float(torch.max(torch.abs(cents_d - cents)))
        print("distributed kmeans max err:", err, flush=True)
        # the slots' partial sums add in another order than one scatter, and
        # a borderline point that flips its assignment amplifies the drift
        # over 5 EM passes: 1e-2 bounds that and still catches a wrong
        # factorisation (the reference's bound)
        assert err < 1e-2, err
        out["kmeans_err"] = err
        if keep:
            out["kept"] = dict(cfg=cfg, x=x, index=index, mesh=mesh, dist=dist, mesh3=mesh3, hier=hier,
                               mesh1=mesh1, blocks=blocks, cents_d=cents_d)
    finally:
        set_local_slots(slots_before)
    print("SELFTEST PASS", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device of the slots (default: the card)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
