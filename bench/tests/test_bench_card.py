"""On the card: one short run of each cell through the command line,
correct. Skips where there is no card (decided inside the test)."""

import json
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
