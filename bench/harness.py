"""One run of one cell: set-up, the measured window, an optional profiled
slice, and the check that decides ``correct``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``:

* ``<paths[0]>/configs/<config>.json`` the configuration as it is run
  (the ``NomadConfig`` fields, and a ``data`` block for the generator);
* ``<paths[0]>/traffic/<traffic>.json`` the traffic mix: which entry of
  the program the window drives (``kind``), its parameters, and which
  window statistic each end-to-end metric is;
* ``<paths[0]>/metrics/<metric>.py`` a per-layer metric: ``read(ctx)``
  returns a number, or ``None`` where it finds nothing to read;
* ``<paths[0]>/limits/<workload>.json`` the limit of each number the
  cell's check compares.

* ``<paths[0]>/kinds/<kind>.py`` a kind of work (``Kind``, a subclass of
  :class:`Work`): set-up, one unit of the window, and the check.

The three kinds drive the program's entries as a user of the library
would: ``epochs`` (``LocalStrategy.run_epoch``, the loop inside
``NomadProjection.fit``), ``builds`` (``IndexBuilder.build``) and
``queries`` (``MapServer.transform``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from bench import datagen, judge, tracing

F64 = torch.float64


@dataclasses.dataclass
class Cell:
    root: Path
    bench_dir: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _for_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` and its files."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench_dir = root / spec["paths"][0]
    return Cell(
        root=root,
        bench_dir=bench_dir,
        workload=w,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _for_cell(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _for_cell(m, workload)],
    )


def load_reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_kind(bench_dir: Path, name: str):
    """The ``Work`` subclass of a traffic mix's ``kind``, from
    ``<paths[0]>/kinds/<kind>.py``."""
    path = bench_dir / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_kind_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Kind


def nomad_config(config: dict, seed: int):
    """The program's config from the configuration file, seeded by the run."""
    from repro_torch.configs.base import NomadConfig

    names = {f.name for f in dataclasses.fields(NomadConfig)}
    return NomadConfig(**{k: v for k, v in config.items() if k in names}, seed=int(seed))


def _index_arrays(index) -> dict:
    return {k: getattr(index, k) for k in ("x_rows", "knn_idx", "knn_w", "counts", "centroids", "perm")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The base of every kind of work (``kinds/<kind>.py``)
# ---------------------------------------------------------------------------


class Work:
    """Set-up, one unit of the window, the profiled unit and the check."""

    span = "bench.unit"

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = cell.traffic
        self.cfg = nomad_config(cell.config, seed)
        self.cfgd = dataclasses.asdict(self.cfg)
        self.stage_s = []
        self.parts = {}  # set-up's parts, host seconds

    def part(self, name: str, since: float) -> float:
        _sync(self.device)
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - since
        return now

    def make_data(self):
        data, cfg = self.cell.config["data"], self.cfg
        t = time.perf_counter()
        self.centres = datagen.mixture_centres(data, cfg.dim, self.seed, self.device)
        self.x = datagen.mixture_rows(data, self.centres, cfg.n_points, self.seed, datagen.TRAIN_STREAM)
        t = self.part("data", t)
        self.x_host = datagen.to_host(self.x)
        self.part("data_to_host", t)

    def build_index(self):
        from repro_torch.index.build import IndexBuilder

        t = time.perf_counter()
        builder = IndexBuilder(self.cfg, device=self.device)
        index = builder.build(self.x_host)
        self.part("build", t)
        self.parts["build_stage_s"] = {k: round(v, 3) for k, v in builder.report.stage_s.items()}
        return index, builder.report

    def theta_rows(self, index) -> np.ndarray:
        """The benchmark's start of θ (PCA of the rows) in the index's row layout."""
        t = time.perf_counter()
        th0 = datagen.pca_init(self.x, self.cfg.out_dim, self.cfg.init_scale).cpu().numpy()
        rows = np.zeros((index.n_clusters * index.capacity, self.cfg.out_dim), np.float32)
        rows[index.perm] = th0
        self.part("theta0", t)
        return rows

    def window_stats(self, seconds: float, units: int, unit_s: list) -> dict:
        rows = units * int(self.traffic.get("request_rows", 1))
        return {
            "seconds": seconds, "units": units, "rows": rows, "unit_s": list(unit_s), "stage_s": list(self.stage_s),
            "seconds_per_unit": seconds / units, "rows_per_second": rows / seconds,
        }





# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def run(root, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run of ``workload``: (the result line's object, with ``checks``
    last; set-up's parts and the check in host seconds). Never prints."""
    device = torch.device(device)
    cell = load_cell(root, workload)
    tr = cell.traffic
    work = load_kind(cell.bench_dir, tr["kind"])(cell, seed, device)
    on_cuda = device.type == "cuda"
    t = time.perf_counter()
    if on_cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context, before its statistics are reset
        torch.cuda.reset_peak_memory_stats(device)
    work.parts["start"] = t - t_start
    work.part("context", t)
    work.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    unit_s, t0 = [], time.perf_counter()
    while True:
        ts = time.perf_counter()
        work.unit()
        te = time.perf_counter()
        unit_s.append(te - ts)
        if te - t0 >= seconds:
            break
    window = work.window_stats(te - t0, len(unit_s), unit_s)
    work.parts["unit_s_0_25_50_75_95_100"] = [float(v) for v in np.percentile(unit_s, [0, 25, 50, 75, 95, 100])]
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0

    summary = None
    if trace:
        summary = tracing.profile_slice(work.unit, int(tr["trace_units"]), work.span, on_cuda)
    work.free()
    if on_cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = work.check()
    work.part("check", t)
    correct, checks = judge.verdict(numbers, cell.limits)

    metrics = {}
    if not trace:
        stats = dict(window, setup_s=setup_s)
        for m in cell.end_to_end:
            stat = "setup_s" if m["name"] == "setup_s" else tr["end_to_end"].get(m["name"])
            if stat is None:
                raise SystemExit(f"traffic {cell.workload['traffic']!r} gives no {m['name']!r}")
            metrics[m["name"]] = {"value": float(stats[stat]), "unit": m["unit"]}
    else:
        ctx = {"cfg": work.cfgd, "traffic": tr, "window": window, "trace": summary,
               "counts": np.asarray(getattr(getattr(work, "index", None) or getattr(work, "last", None),
                                            "counts", np.zeros(0)))}
        for m in cell.per_layer:
            value = load_reader(cell.bench_dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
           "count": 1, "memory_peak_bytes": mem_peak}
    out = {"correct": bool(correct) and window["units"] > 0, "attempted": window["units"], "failed": 0,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out, work.parts


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['limit'] is not None and math.isfinite(c['value']) and c['value'] <= c['limit'] else 'FAIL'}"
            for name, c in checks.items()]
