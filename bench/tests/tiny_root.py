"""A checkout-shaped directory for the CPU tests: the benchmark's files and
``BENCHMARK.json``, with a tiny configuration, traffic mixes and cells
added as new files and entries only. Besides the training cell, the tiny
cells drive the ``builds`` and ``queries`` kinds, which no cell of
``BENCHMARK.json`` uses yet: their end-to-end and per-layer metrics, and
their limits, are entered here."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(name="tiny", n_points=3000, dim=16, n_clusters=8, n_neighbors=5, n_noise=16, n_exact_negatives=4,
            batch_size=256, n_epochs=4, kmeans_iters=10, serve_microbatch=128, transform_steps=4,
            build_block_rows=1024, chunk_rows=1024)
DATA = dict(kind="hierarchical_mixture", n_groups=2, per_group=8, group_spread=0.8, spread=0.3)
CELLS = {"tiny.train": "train_epochs", "tiny.build": "index_build", "tiny.serve": "tiny_queries"}
SEED = 2**31 + 11
INDEX_LIMITS = {"layout": 0, "kmeans_gap": 0.01, "assign_gap": 0.01, "knn_gap": 0.01, "knn_w_gap": 0.01}
SERVE_LIMITS = {"map_layout": 0, "means_gap": 1e-4, "query_layout": 0, "cell_gap": 1e-2, "qknn_gap": 1e-3,
                "qdist_gap": 3e-4, "place_gap": 1e-3}
END_TO_END = [{"name": "build_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock",
               "workloads": ["tiny.build"]},
              {"name": "serve_qps", "unit": "queries/s", "better": "higher", "bound": 0.25, "source": "host_clock",
               "workloads": ["tiny.serve"]}]
PER_LAYER = {"build_s": ("index build", ["build.stragglers_s", "build_mfu", "k23_roofline", "idle.build"]),
             "serve_qps": ("serving", ["serve.batch_p95_ms", "serve_mfu", "k45_roofline", "idle.serve"])}

UNITS = {"build.stragglers_s": "s", "serve.batch_p95_ms": "ms", "idle.build": "%", "idle.serve": "%"}


def make(dest: Path) -> Path:
    """Copy the benchmark under ``dest`` and add the tiny cells as files."""
    shutil.copytree(ROOT / "bench", dest / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/nomad_pubmed.json").read_text())
    cfg.update(TINY, data=DATA)
    (dest / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    train = json.loads((ROOT / "bench/limits/pubmed.train.json").read_text())
    limits = {"tiny.train": train, "tiny.build": INDEX_LIMITS, "tiny.serve": dict(INDEX_LIMITS, **SERVE_LIMITS)}
    for name, lim in limits.items():
        (dest / f"bench/limits/{name}.json").write_text(json.dumps(lim))
    tq = json.loads((ROOT / "bench/traffic/place_queries.json").read_text())
    tq.update(request_rows=128, pool_requests=4, check_requests=3, fit_epochs=2, trace_units=2)
    (dest / "bench/traffic/tiny_queries.json").write_text(json.dumps(tq))
    spec["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2505.15511",
                            "file": "bench/configs/tiny.json", "reduced": ["n_points"], "why": "CPU tests"})
    for name, traffic in CELLS.items():
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": traffic, "chips": 1, "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("pubmed.", "tiny.") for w in m["workloads"] if w.startswith("pubmed.")]
    spec["end_to_end"] += END_TO_END
    for moves, (layer, names) in PER_LAYER.items():
        cell = [m["workloads"] for m in END_TO_END if m["name"] == moves][0]
        spec["per_layer"] += [{"name": n, "unit": UNITS.get(n, "%"), "better": "lower" if n in UNITS else "higher",
                               "source": "device_trace", "layer": layer, "moves": moves, "workloads": list(cell)}
                              for n in names]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def run(root: Path, workload: str, trace: bool = False, seconds: float = 0.3, seed: int = SEED):
    from bench import harness

    torch.set_num_threads(1)
    return harness.run(root, workload, seed, seconds, trace, "cpu", time.perf_counter())
