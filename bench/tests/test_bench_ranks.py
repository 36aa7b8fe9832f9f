"""A cell on several cards, run on the CPU over gloo: one process a rank,
one result line from rank 0, the same units on every rank, the worst
rank's numbers judged, and a rank that dies, hangs or loads JAX fails the
run within its timeout and leaves no process behind. A cell on one card
joins no process group."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import ranks
from bench.tests import tiny_root

SRC = str(tiny_root.ROOT / "src")
RANK_TIMEOUT_S = 8


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root.make(tmp_path_factory.mktemp("checkout"))


def _run(root: Path, workload: str, trace: int = 0, seconds: float = 1.0):
    """``bench/run.py`` with the look for a card skipped, in a process of
    its own: (status, standard output, standard error, seconds)."""
    argv = ["--workload", workload, "--seed", str(tiny_root.SEED), "--seconds", str(seconds), "--trace", str(trace)]
    code = (f"import sys\nfrom bench import run\n"
            f"sys.exit(run.main({argv!r}, device_type='cpu', rank_timeout_s={RANK_TIMEOUT_S}))")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                       timeout=ranks.RUN_DEADLINE_S)
    return r.returncode, r.stdout, r.stderr, time.monotonic() - t


def _stderr_list(err: str, key: str) -> list:
    return [json.loads(line[len(key) + 1:]) for line in err.splitlines() if line.startswith(key + " ")][-1]


def _leftovers(root: Path) -> list:
    """Processes whose command line names this checkout."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if str(root) in cmd and int(pid) != os.getpid():
            found.append(cmd)
    return found


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["tiny.ranks2", "tiny.ranks4"])
def test_one_result_line_from_rank_0(root, workload, trace):
    rc, out, err, _ = _run(root, workload, trace)
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    chips = tiny_root.RANK_CELLS[workload][1]
    assert res["correct"] is True and res["device"]["count"] == chips
    peaks = _stderr_list(err, "card_memory_peak_bytes")
    assert len(peaks) == chips and res["device"]["memory_peak_bytes"] == max(peaks)
    assert err.strip().splitlines()[-len(res["checks"]):] == [f"check sum_gap {res['checks']['sum_gap']['value']!r} "
                                                               f"limit 1e-06 ok"]
    assert ("breakdown" in res) == bool(trace)
    assert not _leftovers(root)


@pytest.mark.parametrize("workload", ["tiny.ranks2", "tiny.ranks4"])
def test_every_rank_runs_the_same_units(root, workload):
    rc, out, err, _ = _run(root, workload, seconds=1.5)
    assert rc == 0, err[-3000:]
    units = _stderr_list(err, "rank_units")
    res = json.loads(out.strip().splitlines()[-1])
    assert len(units) == tiny_root.RANK_CELLS[workload][1]
    assert set(units) == {res["attempted"]} and res["attempted"] > 3
    mean_us, max_us = _stderr_list(err, "agree_us_mean_max")
    assert 0 < mean_us <= max_us


def test_a_fault_on_rank_1_alone_is_not_correct(root):
    rc, out, err, _ = _run(root, "tiny.ranks2.fault")
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["sum_gap"]["value"] > 0.1


@pytest.mark.parametrize("workload,window", [("tiny.ranks2.exit", 30.0), ("tiny.ranks2.hang", 30.0),
                                             ("tiny.ranks2.jax", 1.0)])
def test_a_failed_rank_fails_the_run(root, workload, window):
    rc, out, err, seconds = _run(root, workload, seconds=window)
    assert rc != 0 and out.strip() == ""
    assert "rank 1: exit status" in err
    assert seconds < window + RANK_TIMEOUT_S + ranks.GRACE_S
    if workload.endswith("exit"):
        assert seconds < window  # found at once, not at the window's close
    if workload.endswith("jax"):
        assert "JAX or the JAX package was loaded into this process: ['jax']" in err
    assert not _leftovers(root)


def test_the_worst_rank_decides():
    got = ranks.worst([{"a": 1e-7, "b": 0, "c": 2.0}, {"a": 3e-7, "b": 0, "c": float("nan")}, {"a": 2e-7}])
    assert got["a"] == 3e-7 and got["b"] == float("inf")
    assert got["c"] != got["c"]


def test_a_one_card_cell_joins_no_process_group(root, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a collective in a cell on one card")

    for name in ("init_process_group", "broadcast", "all_reduce", "all_gather_object", "barrier"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    out, parts = tiny_root.run(root, "tiny.train")
    assert not torch.distributed.is_initialized()
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["device"]["count"] == 1
    assert not {"card_memory_peak_bytes", "rank_units", "agree_us_mean_max"} & set(parts)
