"""NOMAD Projection end-to-end training launcher, on one device or on a mesh
of shard slots.

A thin CLI over the estimator; everything fault-tolerant lives in
``NomadProjection.fit``:

* the index build (K-means + in-cluster kNN) is cached beside the
  checkpoints (``<checkpoint-dir>/index.npz``, fingerprint-checked): a
  restart reloads it (``index: cache``) instead of rebuilding;
* one checkpoint every ``--checkpoint-every`` epochs, written by the
  asynchronous writer and committed by an atomic rename, so a crash loses
  at most the save in flight, never the one before it;
* ``--resume`` restores θ and the epoch and continues bit for bit: every
  epoch draws from its own seeded generator, so a run resumed from any
  checkpoint ends on the uninterrupted run's embedding.

The data is ``hierarchical_mixture(n_points, dim, seed)``. Printed lines
are the JAX package's launcher's (``epoch …``, ``checkpoint: …``,
``resume: …``, ``index: …``, ``embedding → …``, ``NP@10=…``), so a script
reading one reads the other; ``stages {…}`` adds the fit's stage times
(seconds, JSON).

The mesh, as the JAX package's launcher builds it: ``--host-devices N``
gives the process N shard slots on its device (the counterpart of XLA's
forced host devices), and ``--mesh 2x4`` (or ``8``, or ``2x2x2``) lays
them out over ``("data",)``, ``("data", "model")`` or ``("pod", "data",
"model")``; the fit then shards its clusters over every axis but ``pod``,
hierarchically over the pods with ``--hierarchical``. Without ``--mesh``
the mesh is every slot on one axis; on one slot the fit is the local one
(which the one-slot sharded fit equals bit for bit). A fit over several
processes is ``python -m repro_torch.launch.distributed``'s.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --workload nomad_quickstart \\
      --epochs 10 --checkpoint-dir /tmp/nomad_ckpt --checkpoint-every 2
  … kill it mid-run (or --fail-at-epoch 5), then:
  PYTHONPATH=src python -m repro_torch.launch.train --workload nomad_quickstart \\
      --epochs 10 --checkpoint-dir /tmp/nomad_ckpt --resume --out emb.npy
  PYTHONPATH=src python -m repro_torch.launch.train --host-devices 8 --mesh 2x2x2 --hierarchical
Add ``--device cpu`` to run the plain path without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

AXIS_NAMES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--workload", default="nomad_quickstart")
    ap.add_argument("--n-points", type=int, default=0, help="override workload size")
    ap.add_argument("--epochs", type=int, default=0, help="override epoch count")
    ap.add_argument("--mesh", default="", help="e.g. 8, 2x4 or 2x2x2 (pod x data x model); default: every slot")
    ap.add_argument("--host-devices", type=int, default=0, help="shard slots on this process's device")
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA device)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--hierarchical", action="store_true", help="hierarchical means over the pod axis")
    ap.add_argument("--fail-at-epoch", type=int, default=-1, help="crash injection (tests)")
    ap.add_argument("--out", default="", help="write final embedding .npy here")
    ap.add_argument("--metrics", action="store_true", help="NP@10/triplet at the end")
    return ap


def parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        args.dims = tuple(int(d) for d in args.mesh.split("x")) if args.mesh else None
    except ValueError:
        args.dims = ()
    if args.dims is not None and not (1 <= len(args.dims) <= 3 and min(args.dims) >= 1):
        ap.error(f"--mesh {args.mesh}: want 1 to 3 sizes joined by 'x', e.g. 8, 2x4 or 2x2x2")
    return args, ap


def build_mesh(args, ap, device):
    """(mesh, axis names, pod axis, shard axes, shard count) of ``--mesh``
    over this process's ``--host-devices`` slots; a mesh larger than the
    pool exits with status 2."""
    from repro_torch.launch import mesh as mesh_lib

    if args.host_devices:
        mesh_lib.set_local_slots(args.host_devices)
    dims = args.dims or (mesh_lib.device_count(),)
    axis_names = AXIS_NAMES[len(dims)]
    try:
        mesh = mesh_lib.make_mesh(dims, axis_names, device=device)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh or dims[0]}: {e} (give the process more with --host-devices)")
    pod_axis = "pod" if "pod" in axis_names else None
    shard_axes = tuple(a for a in axis_names if a != "pod")
    return mesh, axis_names, pod_axis, shard_axes, mesh.size


def main(argv=None) -> int:
    args, ap = parse_args(argv)

    from repro_torch.checkpoint import latest_step, load_metadata
    from repro_torch.configs import get_nomad
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.runtime import resolve_device
    from repro_torch.core.strategy import FitCallbacks
    from repro_torch.data.synthetic import hierarchical_mixture

    cfg = get_nomad(args.workload)
    if args.n_points:
        cfg = cfg.replace(n_points=args.n_points)
    if args.epochs:
        cfg = cfg.replace(n_epochs=args.epochs)
    if args.hierarchical:
        cfg = cfg.replace(hierarchical=True)
    if args.checkpoint_dir:
        cfg = cfg.replace(checkpoint_dir=args.checkpoint_dir)
    if args.checkpoint_every:
        cfg = cfg.replace(checkpoint_every_epochs=args.checkpoint_every)
    device = resolve_device(args.device)
    mesh, axis_names, pod_axis, shard_axes, n_shards = build_mesh(args, ap, device)
    print(f"mesh {mesh.devices.shape} axes {axis_names}; {n_shards} shards", flush=True)
    if n_shards == 1:
        print(f"device {device}; 1 shard", flush=True)

    # the index is owned by fit: fingerprint-checked checkpoint_dir/index.npz
    # cache > IndexBuilder on the device
    x, _sup, _sub = hierarchical_mixture(cfg.n_points, cfg.dim, seed=cfg.seed)
    ckdir = cfg.checkpoint_dir

    resume = bool(args.resume and ckdir and latest_step(ckdir) is not None)
    if resume:
        meta = load_metadata(ckdir)
        print(f"resume: epoch {int(meta['epoch']) + 1} (ckpt step {meta['epoch']})", flush=True)

    class Progress(FitCallbacks):
        wants_embedding = False

        def on_epoch_start(self, ev):
            if ev.epoch == args.fail_at_epoch:
                print(f"CRASH INJECTION at epoch {ev.epoch}", flush=True)
                os._exit(17)

        def on_epoch_end(self, ev):
            print(f"epoch {ev.epoch:4d} loss {ev.loss:.5f} ({ev.time_s:.2f}s)", flush=True)

        def on_checkpoint(self, ev):
            print(f"checkpoint: epoch {ev.epoch} → {ev.directory}", flush=True)

    if n_shards == 1:
        proj = NomadProjection(cfg, device=device)
    else:
        strategy = "hierarchical" if (cfg.hierarchical and pod_axis) else "sharded"
        proj = NomadProjection(cfg, strategy=strategy, mesh=mesh, shard_axes=shard_axes, pod_axis=pod_axis,
                               device=device)
    res = proj.fit(x, callbacks=Progress(), resume=resume)
    print(
        f"index: {res.index_build_strategy}"
        + (f" build in {res.index_build_s:.1f}s" if res.index_build_s else ""),
        flush=True,
    )
    print("stages " + json.dumps(res.stage_s), flush=True)

    emb = res.embedding
    if args.out:
        import numpy as np

        np.save(args.out, emb)
        print("embedding →", args.out, flush=True)
    if args.metrics:
        from repro_torch.metrics import neighborhood_preservation, random_triplet_accuracy

        np10 = neighborhood_preservation(x, emb, k=10, n_queries=min(1000, cfg.n_points), device=device)
        rta = random_triplet_accuracy(x, emb, 10_000)
        print(f"NP@10={np10:.4f} triplet={rta:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
