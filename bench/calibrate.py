"""The readings that set the limits of a cell's numbers, on the card.

    python3 bench/calibrate.py --workload pubmed.train --seeds 1,2,3 --control-seeds 4,5,6

For each ``--seeds`` seed the program's readings: the cell's set-up, a
short window of the cell's own work (one unit; the serving cell as many
requests as a run checks), and the check. For each
``--control-seeds`` seed the control's: the reference at bfloat16 put in
the program's place (its index build, its training epochs, its fit and
placements), judged by the same comparisons, and for a training cell the
readings of its faults (``fault_readings``). Writes every reading and,
per number, the program's largest and the control's smallest to
``--out`` (default ``chiprun_out/calib_<workload>.json``). Not part of
any run of the benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import datagen, harness, judge  # noqa: E402
from bench import reference as ref  # noqa: E402

BF16 = torch.bfloat16


def program_readings(cell, seed: int, device) -> dict:
    work = harness.load_kind(cell.bench_dir, cell.traffic["kind"])(cell, seed, device)
    work.setup()
    for _ in range(max(1, int(cell.traffic.get("check_requests", 0)))):
        work.unit()
    work.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return work.check()


def train_readings(cfgd: dict, th_rows, index: dict, seed: int, device, dtype, n_steps=None,
                   fault=contextlib.nullcontext) -> dict:
    """The warm-up epoch and the next from ``th_rows``, the reference at
    ``dtype`` in the program's place (``n_steps`` of each epoch's steps,
    under ``fault()``), judged against the float64 reference from the same
    starts."""
    th0 = np.asarray(th_rows, np.float64)
    with fault():
        l0, th1 = ref.epoch_from(cfgd, th0, index, seed, 0, device, dtype, n_steps)
        l1, th2 = ref.epoch_from(cfgd, th1, index, seed, 1, device, dtype, n_steps)
    want = [ref.epoch_from(cfgd, th, index, seed, e, device, torch.float64) for e, th in ((0, th0), (1, th1))]
    return judge.train_numbers([(l0, th0, th1), (l1, th1, th2)], want)


@contextlib.contextmanager
def half_batch():
    """Each step's loss and update over the first half of its heads."""
    orig = ref.sample_step_rows

    def half(*args):
        rows, cell, neg = orig(*args)
        h = rows.shape[0] // 2
        return rows[:h], cell[:h], neg[:h]

    ref.sample_step_rows = half
    try:
        yield
    finally:
        ref.sample_step_rows = orig


def fault_readings(cell, work, index: dict, th_rows, seed: int, device) -> dict:
    """The faults a training cell can have, planted in the float32
    reference put in the program's place: k-means returning its LSH
    seeding (its E-steps left out), half of each batch left out, half of
    each epoch's steps left out."""
    cfgd, F32 = work.cfgd, torch.float32
    K = cfgd["n_clusters"]
    stats = {}
    want = ref.objective(work.x, ref.kmeans(work.x.double(), K, cfgd["kmeans_iters"], cfgd["kmeans_tol"],
                                            ref.seeded_generator(device, seed), stats))
    seeding = ref.kmeans(work.x, K, 0, cfgd["kmeans_tol"], ref.seeded_generator(device, seed))
    out = {"kmeans_seeding": {"kmeans_gap": max(0.0, ref.objective(work.x, seeding) - want) / want},
           "reference": {"e_steps": stats["e_steps"]}}
    out["half_batch"] = train_readings(cfgd, th_rows, index, seed, device, F32, fault=half_batch)
    steps = ref.TrainState(cfgd, th_rows, index["knn_idx"], index["knn_w"], index["counts"], device,
                           F32).steps_per_epoch()
    out["half_steps"] = train_readings(cfgd, th_rows, index, seed, device, F32, n_steps=steps // 2)
    return out


def control_readings(cell, seed: int, device, faults=None) -> dict:
    """The bfloat16 reference in the program's place, judged as the
    program is. A training cell's faults (:func:`fault_readings`) go into
    ``faults`` where it is given."""
    work = harness.Work(cell, seed, device)
    work.make_data()
    cfgd, kind, tr = work.cfgd, cell.traffic["kind"], cell.traffic
    index = ref.build(work.x, cfgd, seed, BF16)
    numbers = judge.index_numbers(work.x, index, cfgd, seed)
    if kind == "builds":
        return numbers
    th0 = datagen.pca_init(work.x, cfgd["out_dim"], cfgd["init_scale"]).cpu().numpy()
    th_rows = np.zeros((index["x_rows"].shape[0], cfgd["out_dim"]), np.float32)
    th_rows[index["perm"]] = th0
    if kind == "epochs":
        numbers.update(train_readings(cfgd, th_rows, index, seed, device, BF16))
        if faults is not None:
            faults.update(fault_readings(cell, work, index, th_rows, seed, device))
        return numbers
    st = ref.TrainState(cfgd, th_rows, index["knn_idx"], index["knn_w"], index["counts"], device, BF16)
    for e in range(int(tr["fit_epochs"])):
        st.epoch(seed, e, *ref.epoch_lrs(cfgd, e))
    fit_theta = st.theta.float()
    cap = ref.capacity(cfgd)
    counts = torch.as_tensor(index["counts"], device=device)
    inv = np.full(th_rows.shape[0], -1, np.int64)
    inv[index["perm"]] = np.arange(len(index["perm"]))
    fz = {"theta_rows": fit_theta, "x_rows": torch.as_tensor(index["x_rows"], device=device),
          "centroids": torch.as_tensor(index["centroids"], device=device), "counts": counts,
          "means": ref.local_means(fit_theta.to(BF16), counts, cap).float(),
          "inv_perm": torch.as_tensor(inv, device=device)}
    numbers.update(judge.map_numbers(fz, index, fit_theta.cpu().numpy(), cfgd))
    rows = int(tr["request_rows"])
    worst = {}
    for i in range(int(tr["check_requests"])):
        q = datagen.mixture_rows(cell.config["data"], work.centres, rows, seed, datagen.QUERY_STREAM, i)
        seeds = torch.full((rows,), datagen.sub_seed(seed, 3, i) & 0xFFFFFFFF, dtype=torch.int64, device=device)
        rid = torch.arange(rows, device=device)
        theta, own, nb_rows, nb_valid = ref.transform(cfgd, fz, q, seeds, rid, BF16)
        d2 = ((q.to(BF16)[:, None, :] - fz["x_rows"][nb_rows].to(BF16)) ** 2).sum(-1).float()
        out = {"embedding": theta.float().cpu().numpy(), "cells": own.cpu().numpy(),
               "neighbor_ids": torch.where(nb_valid, fz["inv_perm"][nb_rows], -1).cpu().numpy(),
               "neighbor_dists": torch.where(nb_valid, d2.sqrt(), torch.inf).cpu().numpy()}
        got = judge.query_numbers(cfgd, fz, index["perm"], q, seeds, rid, out)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    numbers.update(worst)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = torch.device("cuda:0")
    cell = harness.load_cell(ROOT, args.workload)
    out = Path(args.out or ROOT / "chiprun_out" / f"calib_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    rec = {"workload": args.workload, "device": torch.cuda.get_device_name(device), "program": {}, "control": {},
           "faults": {}}

    def save():
        for side, agg in (("program", max), ("control", min)):
            names = sorted({k for r in rec[side].values() for k in r})
            rec[side + "_" + agg.__name__] = {k: agg(r[k] for r in rec[side].values() if k in r) for k in names}
        out.write_text(json.dumps(rec, indent=1, default=float))

    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in [int(v) for v in seeds.split(",") if v]:
            t0 = time.time()
            faults = {}
            got = program_readings(cell, s, device) if side == "program" else control_readings(cell, s, device, faults)
            rec[side][str(s)] = got
            for name, nums in faults.items():
                rec["faults"].setdefault(name, {})[str(s)] = nums
            print(side, s, f"{time.time() - t0:.1f}s", json.dumps(got), json.dumps(faults), flush=True)
            save()
            torch.cuda.empty_cache()
    save()
    print("program max", json.dumps(rec.get("program_max")))
    print("control min", json.dumps(rec.get("control_min")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
