"""The harness finds its files by name, runs each kind of work at a tiny
size on the CPU, and reports rates over the whole window."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench import harness
from bench import run as run_mod
from bench.tests import tiny_root

ROOT = tiny_root.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root.make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_finds_its_files_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert issubclass(harness.load_kind(cell.bench_dir, cell.traffic["kind"]), harness.Work)
    assert cell.config["name"] == cell.workload["config"]
    for m in cell.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in cell.traffic["end_to_end"]
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(cell.bench_dir, m["name"]))
    harness.nomad_config(cell.config, 2**31 + 5)  # every field is the program's


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", list(tiny_root.CELLS))
def test_tiny_run_result_line(root, workload, trace):
    out, parts = tiny_root.run(root, workload, trace)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) == set(KEYS + ["checks"] + (["breakdown"] if trace else []))
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    cell = harness.load_cell(root, workload)
    names = set(out["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert names <= {m["name"] for m in cell.per_layer} and names
    else:
        assert names == {m["name"] for m in cell.end_to_end}
    assert parts["check"] > 0
    err, line = run_mod.report(out, parts)
    assert json.loads(line) == out and list(json.loads(line)) == keys
    assert err[0].startswith("parts_s ") and err[-len(out["checks"]):] == harness.check_lines(out["checks"])


def test_dummy_cell_and_metric_added_as_files(tmp_path):
    """A new traffic mix, a new cell and a new per-layer metric, added as
    files and entries only, run without an edit to the harness."""
    root = tiny_root.make(tmp_path)
    (root / "bench/metrics/dummy_units.py").write_text("def read(ctx):\n    return float(ctx['window']['units'])\n")
    traffic = json.loads((root / "bench/traffic/index_build.json").read_text())
    traffic.update(trace_units=1)
    (root / "bench/traffic/dummy_builds.json").write_text(json.dumps(traffic))
    (root / "bench/limits/tiny.dummy.json").write_text((root / "bench/limits/tiny.build.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.dummy", "config": "tiny", "traffic": "dummy_builds", "chips": 1,
                              "why": "a cell added by files"})
    spec["per_layer"].append({"name": "dummy_units", "unit": "1", "better": "higher", "source": "host_clock",
                              "layer": "index build", "moves": "build_s", "workloads": ["tiny.dummy"]})
    for m in spec["end_to_end"]:
        if m["name"] == "build_s":
            m["workloads"].append("tiny.dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out, _ = tiny_root.run(root, "tiny.dummy", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["dummy_units"]["value"] == out["attempted"]
    out, _ = tiny_root.run(root, "tiny.dummy", trace=False)
    assert set(out["metrics"]) == {"setup_s", "build_s"}


def test_rates_are_all_work_over_the_whole_window():
    w = harness.Work.__new__(harness.Work)
    w.traffic, w.stage_s = {"request_rows": 1024}, []
    st = w.window_stats(30.5, 61, [0.5] * 61)
    assert st["seconds_per_unit"] == 30.5 / 61
    assert st["rows_per_second"] == 61 * 1024 / 30.5


def test_p95_is_over_every_request():
    unit_s = [0.08] * 190 + [0.5 + 0.01 * i for i in range(10)]
    read = harness.load_reader(ROOT / "bench", "serve.batch_p95_ms")
    ctx = {"traffic": {"kind": "queries"}, "window": {"units": len(unit_s), "unit_s": unit_s}}
    assert read(ctx) == pytest.approx(float(np.percentile(unit_s, 95)) * 1e3)
    assert read(ctx) > 80.0


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "pubmed.train", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _cli(ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_no_result_in_a_bare_directory(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _cli(tmp_path, env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "not importable" in r.stderr
