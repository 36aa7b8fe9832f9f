"""Multi-process NOMAD fit: the process group's bootstrap and the
per-process CLI.

The paper's headline is that NOMAD Projection runs across accelerators:
clusters shard over one global mesh of shard slots
(:mod:`repro_torch.launch.mesh`) and the one exchange of the optimisation
loop, the per-refresh all-gather of the cell means, crosses processes as
it crosses slots. This module is the host-side glue:

* :func:`initialize_distributed` — ``torch.distributed.init_process_group``
  over TCP at ``--coordinator``, NCCL when the process runs on a card and
  gloo on the CPU, under ``--init-timeout``. After it the global slot pool
  (``mesh.devices``) spans every process and each mesh built from it
  exchanges across them.
* ``python -m repro_torch.launch.distributed`` — one invocation a process
  (``--process-id i``), all at one ``--coordinator host:port``; or
  ``--spawn K`` to start K local workers against a free local port. Every
  process must see the same data: ``--store`` (a store on a shared
  filesystem) for anything big, of which each process reads only the rows
  its own slots shard (the ``"distributed"`` index build). ``--host-devices
  N`` gives a process N slots on its one device, the counterpart of the
  reference's simulated host devices; NCCL takes one process a card.

Contract (``tests/test_torch_multiprocess.py``): a P-process fit ≡ the
1-process fit over the same global slot count, bit for bit; the process
layout changes where shards run, never what they compute. A crash
(``--fail-at-epoch``, exit 17) resumes from the last checkpoint to the
uninterrupted run's embedding. A missing or unreachable coordinator exits
with status 3 ("distributed init failed") within the timeout.

Examples (the CPU, over gloo)::

  PYTHONPATH=src python -m repro_torch.launch.distributed --device cpu --spawn 2 \\
      --n-points 4000 --dim 16 --epochs 3 --out emb.npy
  PYTHONPATH=src python -m repro_torch.launch.distributed --device cpu --host-devices 2 \\
      --n-points 4000 --dim 16 --epochs 3 --out emb1.npy          # ≡ emb.npy
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

from repro_torch.core.runtime import barrier

CRASH_RC = 17  # the exit status of --fail-at-epoch, as launch/train.py's
INIT_FAILED_RC = 3


def pick_free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port the OS picks (closed again: the coordinator's bind
    reports it loudly in the rare case another process takes it first)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return int(s.getsockname()[1])


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU; never one for the other."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: str, num_processes: int, process_id: int, *, device,
                           timeout_s: int = 60) -> str:
    """Join (or, as process 0, host) the process group at ``coordinator``
    (``host:port``) with ``backend_for(device)``; returns the backend.

    One process with no coordinator takes a free local port: a world of
    one still runs the collectives (NCCL's on the card). Raises when a
    multi-process run has no coordinator, or when the rendezvous does not
    complete within ``timeout_s``."""
    import torch
    import torch.distributed as dist

    if num_processes > 1 and not coordinator:
        raise ValueError("multi-process init needs a coordinator address (host:port of process 0)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    device = torch.device(device)
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
    address = coordinator or f"127.0.0.1:{pick_free_port()}"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return backend


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The per-process entry point
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.distributed",
        description="Per-process NOMAD fit worker (torch.distributed).",
    )
    ap.add_argument("--coordinator", default="", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--spawn", type=int, default=0, help="launch K local worker processes against a local coordinator")
    ap.add_argument("--host-devices", type=int, default=0, help="shard slots per process on its device (default 1)")
    ap.add_argument("--init-timeout", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="'cpu' (gloo) or a CUDA device (NCCL); default cuda:<process id mod cards>")
    # workload
    ap.add_argument("--workload", default="nomad_quickstart")
    ap.add_argument("--store", default="", help="shared embedding store (dir or .npy)")
    ap.add_argument("--n-points", type=int, default=0)
    ap.add_argument("--dim", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=0)
    ap.add_argument("--neighbors", type=int, default=0)
    ap.add_argument("--chunk-rows", type=int, default=0)
    # fault tolerance
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-epoch", type=int, default=-1, help="crash injection (tests)")
    # outputs (process 0 writes; --stats is per process)
    ap.add_argument("--out", default="", help="final embedding .npy (process 0)")
    ap.add_argument("--dump-index", default="", help="index arrays .npz (process 0)")
    ap.add_argument("--stats", default="", help="per-process stage walls + RSS JSON")
    return ap.parse_args(argv)


def _spawn_workers(args, argv, grace_s: float = 30.0) -> int:
    """``--spawn K``: K local workers against a local coordinator, one
    intra-op thread each unless the caller's environment says otherwise.
    Once a worker fails the others get ``grace_s`` to end before they are
    killed, so a worker stuck in a collective never hangs the launch.
    Returns the first non-zero status in process order, else 0."""
    port = pick_free_port()
    child_common, it = [], iter(argv)
    for a in it:
        if a == "--spawn":
            next(it, None)
        elif not a.startswith("--spawn="):
            child_common.append(a)
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.distributed", *child_common,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(args.spawn), "--process-id", str(i)],
            env=env,
        )
        for i in range(args.spawn)
    ]
    failed_at = None
    while any(p.poll() is None for p in procs):
        if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
            failed_at = time.time()
        if failed_at is not None and time.time() - failed_at > grace_s:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    rcs = [p.wait() for p in procs]
    bad = [rc for rc in rcs if rc != 0]
    return bad[0] if bad else 0


def _device_for(args):
    import torch

    if args.device:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass --device cpu to run over gloo on the CPU")
    return torch.device("cuda", args.process_id % torch.cuda.device_count())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.spawn > 0:
        return _spawn_workers(args, argv)

    t_start = time.time()
    try:
        device = _device_for(args)
        backend = initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=device,
                                         timeout_s=args.init_timeout)
    except Exception as e:  # noqa: BLE001 — fail loud, fast and with the cause
        print(
            f"distributed init failed (coordinator {args.coordinator!r}, process "
            f"{args.process_id}/{args.num_processes}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return INIT_FAILED_RC
    try:
        return _run(args, device, backend, t_start)
    finally:
        shutdown()


def _run(args, device, backend: str, t_start: float) -> int:
    import numpy as np

    from repro_torch.checkpoint import latest_step, load_metadata
    from repro_torch.configs import get_nomad
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.core.strategy import FitCallbacks
    from repro_torch.core.trace import rss_mb
    from repro_torch.data.store import as_store
    from repro_torch.index.build import IndexBuilder
    from repro_torch.launch import mesh

    if args.host_devices:
        mesh.set_local_slots(args.host_devices)
    pid, nproc = mesh.process_index(), mesh.process_count()
    print(f"process {pid}/{nproc}: {mesh.local_slot_count()} local / {mesh.device_count()} global slots "
          f"on {device}, backend {backend}", flush=True)

    cfg = get_nomad(args.workload)
    # every process runs the cross-process build: each reads its own rows
    cfg = cfg.replace(build_strategy="distributed")
    if args.store:
        x = as_store(args.store)
        cfg = cfg.replace(n_points=x.n_rows, dim=x.dim)
    else:
        if args.n_points:
            cfg = cfg.replace(n_points=args.n_points)
        if args.dim:
            cfg = cfg.replace(dim=args.dim)
        from repro_torch.data.synthetic import hierarchical_mixture

        x, _sup, _sub = hierarchical_mixture(cfg.n_points, cfg.dim, seed=cfg.seed)
    for flag, field in (("epochs", "n_epochs"), ("clusters", "n_clusters"), ("neighbors", "n_neighbors"),
                        ("chunk_rows", "chunk_rows"), ("checkpoint_dir", "checkpoint_dir"),
                        ("checkpoint_every", "checkpoint_every_epochs")):
        if getattr(args, flag):
            cfg = cfg.replace(**{field: getattr(args, flag)})

    ckdir = cfg.checkpoint_dir
    resume = bool(args.resume and ckdir and latest_step(ckdir) is not None)
    if resume and pid == 0:
        meta = load_metadata(ckdir)
        print(f"resume: epoch {int(meta['epoch']) + 1} (ckpt step {meta['epoch']})", flush=True)

    class Progress(FitCallbacks):
        wants_embedding = False

        def on_epoch_start(self, ev):
            if ev.epoch == args.fail_at_epoch:
                print(f"CRASH INJECTION at epoch {ev.epoch}", flush=True)
                os._exit(CRASH_RC)

        def on_epoch_end(self, ev):
            if pid == 0:
                print(f"epoch {ev.epoch:4d} loss {ev.loss:.5f} ({ev.time_s:.2f}s)", flush=True)

        def on_checkpoint(self, ev):
            if pid == 0:
                print(f"checkpoint: epoch {ev.epoch} → {ev.directory}", flush=True)

    index, build_stage_s = None, {}
    if args.stats:  # an explicit build, so its stage walls land in the stats
        builder = IndexBuilder(cfg, device=device)
        index = builder.build(x)
        build_stage_s = dict(builder.report.stage_s)
        print(f"index: {builder.report.strategy} ({builder.report.n_shards} shards, "
              f"{builder.report.total_s:.1f}s)", flush=True)

    res = NomadProjection(cfg, strategy="auto", device=device).fit(x, index=index, callbacks=Progress(),
                                                                   resume=resume)
    if pid == 0:
        print(f"index: {res.index_build_strategy}"
              + (f" build in {res.index_build_s:.1f}s" if res.index_build_s else ""), flush=True)
        print(f"fit: strategy={res.strategy} shards={res.n_shards} processes={res.process_count} "
              f"backend={backend}", flush=True)
        print("stages " + json.dumps(res.stage_s), flush=True)
        if args.out:
            np.save(args.out, res.embedding)
            print("embedding →", args.out, flush=True)
        if args.dump_index:
            idx = res.index
            np.savez(args.dump_index, knn_idx=idx.knn_idx, knn_w=idx.knn_w, counts=idx.counts,
                     centroids=idx.centroids, perm=idx.perm)
            print("index arrays →", args.dump_index, flush=True)
    if args.stats:
        # spawned workers share one argv: one file a process
        path = args.stats
        if nproc > 1:
            root, ext = os.path.splitext(path)
            path = f"{root}.p{pid}{ext}"
        stats = {
            "process": pid,
            "n_processes": nproc,
            "backend": backend,
            "local_slots": mesh.local_slot_count(),
            "global_slots": mesh.device_count(),
            "peak_rss_mb": rss_mb(),
            "stage_seconds": {**build_stage_s, "fit": float(sum(res.epoch_times)),
                              "total": float(time.time() - t_start)},
            "epoch_seconds": [float(t) for t in res.epoch_times],
            "losses": [float(v) for v in res.losses],
        }
        with open(path, "w") as f:
            json.dump(stats, f, indent=1)
        print("stats →", path, flush=True)

    barrier("fit-done")  # no process leaves while its peers may still need it
    print(f"process {pid}: DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
