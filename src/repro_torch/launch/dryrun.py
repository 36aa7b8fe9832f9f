"""One-card dry run: a cell's step cost and memory on meta tensors, against
the H100's peaks (the port's counterpart of the JAX package's
``launch/dryrun.py``, which lowers and compiles for a TPU mesh).

For every (architecture × supported input shape) cell this script builds
the step of the cell's kind (train, prefill or decode) on the cell's
``input_specs`` (meta tensors: nothing is allocated) and runs it once under
:func:`repro_torch.roofline.op_cost.analyze_ops`, then records

* ``memory``: argument, output, temp and alias bytes and
  ``per_device_total``, with ``fits`` against the card's 80 GB (a cell
  that does not fit is reported so, not as an error);
* ``op_cost``: FLOPs, HBM bytes and matrix-product FLOPs of every aten op
  the step dispatches (in place of the JAX package's ``hlo_cost``);
* ``model_flops`` and the roofline ``terms`` at ``HW_H100`` with one chip.

The NOMAD workloads (``--arch nomad_pubmed`` / ``nomad_wiki60m``) report
the analytic epoch terms (``nomad_analytic_terms``) and the epoch state's
bytes (θ, kNN graph and counts at K·C rows): the registry's kernels run on
CUDA or CPU tensors, not on meta, so the epoch is not traced.

One card only (no ``--mesh``: multi-GPU is ROADMAP.md queue 1 item 5).
Results land in ``<out>/h100x1/<arch>__<shape>.json``, one file a cell,
written as each cell ends (``--skip-existing`` resumes a sweep). It runs
on the CPU; ``--arch all`` takes minutes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nomad_pubmed
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

TAG = "h100x1"


def _terms_record(terms) -> dict:
    return {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "useful_ratio": terms.useful_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "bound_s": terms.bound_s,
    }


def run_lm_cell(arch, shape) -> dict:
    """Dry-run one LM cell. ``arch`` is an ``ARCHS`` name or an
    :class:`~repro_torch.configs.base.ArchConfig`, ``shape`` a ``SHAPES``
    name or a :class:`~repro_torch.configs.base.ShapeConfig`."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.roofline.analysis import HW_H100, model_flops, roofline_terms
    from repro_torch.roofline.op_cost import analyze_ops, memory_analysis

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    # the reference's steps: train microbatched with its AdamW
    optimizer = AdamW(schedule=warmup_cosine(3e-4, 2000, 100_000), moment_dtype=cfg.opt_moment_dtype)
    if shape.kind == "train":
        step = steps_lib.make_train_step(cfg, optimizer, microbatched=True)
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg)
    else:
        step = steps_lib.make_decode_step(cfg)
    t0 = time.time()
    specs = steps_lib.input_specs(cfg, shape, optimizer)
    specs_s = time.time() - t0
    t0 = time.time()
    out, rep = analyze_ops(step, *specs)
    trace_s = time.time() - t0
    memory = memory_analysis(specs, out, rep)
    memory["fits"] = memory["per_device_total"] <= HW_H100["hbm_bytes"]
    mf = model_flops(cfg, shape)
    terms = roofline_terms(rep, 1, mf, HW_H100)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "device": TAG,
        "hw": HW_H100["name"],
        "n_chips": 1,
        "kind": shape.kind,
        "ok": True,
        "specs_s": round(specs_s, 2),
        "trace_s": round(trace_s, 2),
        "memory": memory,
        "op_cost": {
            "flops": rep.flops,
            "bytes": rep.bytes,
            "collective_bytes": rep.collective_bytes,
            "coll_by_type": rep.coll_by_type,
            "coll_ops": rep.coll_ops,
            "dot_flops": rep.dot_flops,
            "unknown_trip_whiles": rep.unknown_trip_whiles,
            "temp_bytes": rep.temp_bytes,
            "ops": rep.ops,
            "dot_by_op": rep.dot_by_op,
        },
        "model_flops": mf,
        "terms": _terms_record(terms),
    }


def nomad_state_bytes(cfg) -> dict:
    """The epoch state on the device, by array: θ (K·C, out_dim) fp32, the
    kNN graph (K·C, k) int32 + fp32, the counts and cumulative counts (K,)
    int32 and the global counts (K,) fp32."""
    rows, K = cfg.n_clusters * cfg.cluster_capacity, cfg.n_clusters
    return {
        "theta": rows * cfg.out_dim * 4,
        "knn_idx": rows * cfg.n_neighbors * 4,
        "knn_w": rows * cfg.n_neighbors * 4,
        "counts": K * 4,
        "cum_counts": K * 4,
        "counts_global": K * 4,
    }


def run_nomad_cell(workload) -> dict:
    """The NOMAD epoch of ``workload`` (a ``NOMAD_WORKLOADS`` name or a
    :class:`~repro_torch.configs.base.NomadConfig`) on one card: the
    analytic terms, the model FLOPs and the epoch state's bytes. Not
    traced: the kernels run on CUDA or CPU tensors, not on meta."""
    from repro_torch.configs import get_nomad
    from repro_torch.roofline.analysis import HW_H100, nomad_analytic_terms, nomad_model_flops

    cfg = get_nomad(workload) if isinstance(workload, str) else workload
    steps = max(1, cfg.resolved_steps_per_epoch())
    state = nomad_state_bytes(cfg)
    total = float(sum(state.values()))
    terms = nomad_analytic_terms(cfg, 1, steps, HW_H100)
    bound = max(terms.values())
    return {
        "arch": cfg.name,
        "shape": "epoch",
        "device": TAG,
        "hw": HW_H100["name"],
        "n_chips": 1,
        "kind": "nomad-epoch",
        "ok": True,
        "traced": False,
        "steps_per_epoch": steps,
        "rows": cfg.n_clusters * cfg.cluster_capacity,
        "memory": {"state_bytes": state, "argument_bytes": total, "per_device_total": total,
                   "fits": total <= HW_H100["hbm_bytes"]},
        "model_flops": nomad_model_flops(cfg.n_points, cfg.batch_size, cfg.n_neighbors, cfg.n_exact_negatives,
                                         cfg.n_clusters, steps),
        "analytic_terms": terms,
        "terms": {**terms, "dominant": max(terms, key=terms.get).removesuffix("_s"), "bound_s": bound},
    }


def cells(arch: str, shape: str) -> list:
    """The (arch, shape) cells ``--arch``/``--shape`` name, unsupported
    shapes skipped with a line."""
    from repro_torch.configs import ARCHS, NOMAD_WORKLOADS

    arch_list = list(ARCHS) + ["nomad_pubmed", "nomad_wiki60m"] if arch == "all" else [arch]
    out = []
    for a in arch_list:
        if a in NOMAD_WORKLOADS:
            out.append((a, "epoch"))
            continue
        cfg = ARCHS[a]
        for s in cfg.supported_shapes() if shape == "all" else [shape]:
            if s not in cfg.supported_shapes():
                print(f"SKIP {a} × {s}: unsupported")
                continue
            out.append((a, s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all", help="arch id | nomad workload | 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=os.path.join("results", "dryrun_torch"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import NOMAD_WORKLOADS

    out_dir = os.path.join(args.out, TAG)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape in cells(args.arch, args.shape):
        out_path = os.path.join(out_dir, f"{arch}__{shape}.json")
        if args.skip_existing and os.path.exists(out_path):
            print(f"SKIP (exists) {arch} × {shape}")
            continue
        print(f"=== {arch} × {shape} × {TAG} ===", flush=True)
        try:
            rec = run_nomad_cell(arch) if arch in NOMAD_WORKLOADS else run_lm_cell(arch, shape)
            t, m = rec["terms"], rec["memory"]
            print(
                f"  ok: mem/dev {m['per_device_total'] / 2**30:.2f} GiB (fits {m['fits']}) | "
                f"compute {t['compute_s'] * 1e3:.2f} ms, memory {t['memory_s'] * 1e3:.2f} ms, "
                f"collective {t['collective_s'] * 1e3:.2f} ms → {t['dominant']}-bound",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            rec = {"arch": arch, "shape": shape, "device": TAG, "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  FAIL: {rec['error']}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        results.append(rec)

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ran OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
