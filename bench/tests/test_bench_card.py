"""On the card: one short run of each cell through the command line,
correct, and a tiny cell on four cards, one process a card. Skips where
there is no card, or fewer than the cell asks for (decided inside the
test)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench.tests import tiny_root

CELLS = [w["name"] for w in json.loads((tiny_root.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                        "--seconds", "3", "--trace", "0"], cwd=tiny_root.ROOT, capture_output=True, text=True,
                       timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_four_cards(tmp_path, trace):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    root = tiny_root.make(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(tiny_root.ROOT / "src"))
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", "tiny.ranks4", "--seed", str(2**31 + 98),
                        "--seconds", "3", "--trace", str(trace)], cwd=root, env=env, capture_output=True, text=True,
                       timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    peaks = [json.loads(line.split(" ", 1)[1]) for line in r.stderr.splitlines()
             if line.startswith("card_memory_peak_bytes ")][-1]
    assert out["correct"] is True and out["device"]["platform"] == "gpu" and out["device"]["count"] == 4
    assert len(peaks) == 4 and out["device"]["memory_peak_bytes"] == max(peaks) == peaks[3] > peaks[0]
    if trace:
        assert out["device"]["busy_s"] > 0 and "idle.ranks" in out["metrics"]
    print(r.stderr[-1500:])
