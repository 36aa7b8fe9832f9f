"""The control, the plain reference computed in bfloat16 and put in the
program's place, comes out not correct under each cell's limits; the
reference in float64 put in its place comes out correct. At a size a test
run holds (the chip runs the same at each cell's own size:
``bench/calibrate.py --control-seeds``)."""

import pytest
import torch

from bench import calibrate, harness, judge
from bench.tests import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root.make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("workload", list(tiny_root.CELLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 3_000_000_019])
def test_control_is_refused(root, workload, seed):
    torch.set_num_threads(1)
    cell = harness.load_cell(root, workload)
    numbers = calibrate.control_readings(cell, seed, torch.device("cpu"))
    ok, checks = judge.verdict(numbers, cell.limits)
    assert not ok, checks
    failed = [n for n, c in checks.items() if not c["value"] <= c["limit"]]
    assert "knn_gap" in failed


@pytest.mark.parametrize("workload", list(tiny_root.CELLS))
def test_program_readings_pass(root, workload):
    torch.set_num_threads(1)
    cell = harness.load_cell(root, workload)
    numbers = calibrate.program_readings(cell, 5, torch.device("cpu"))
    ok, checks = judge.verdict(numbers, cell.limits)
    assert ok, checks
