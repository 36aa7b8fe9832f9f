"""The port's launcher (``python -m repro_torch.launch.train``) by
subprocess on the CPU: a run killed at an epoch (exit 17) and resumed from
its asynchronous checkpoint reloads the cached index and ends on the
uninterrupted run's embedding bit for bit; the multi-device options exit
with status 2. The JAX package's ``tests/test_distributed.py`` crash test,
on one device, with the resumed embedding held to the uninterrupted one.

One intra-op thread (``OMP_NUM_THREADS=1``): on the CPU a fit is
bit-repeatable with one thread (``index_put_`` accumulates in thread
order otherwise).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], capture_output=True, text=True,
                          env=ENV, cwd=ROOT, timeout=timeout)


def _common(tmp_path, ck: str):
    return ["--workload", "nomad_quickstart", "--n-points", "4000", "--epochs", "6", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / ck), "--checkpoint-every", "2"]


def test_crash_resume_equals_uninterrupted(tmp_path):
    r0 = _run(_common(tmp_path, "ck_a") + ["--out", str(tmp_path / "a.npy")])
    assert r0.returncode == 0, r0.stdout[-2000:] + r0.stderr[-2000:]
    assert "index: local" in r0.stdout and "epoch    5" in r0.stdout
    assert "checkpoint: epoch 1 → " in r0.stdout and "embedding → " in r0.stdout

    r1 = _run(_common(tmp_path, "ck_b") + ["--fail-at-epoch", "4"])
    assert r1.returncode == 17, r1.stdout[-2000:] + r1.stderr[-2000:]
    assert "CRASH INJECTION at epoch 4" in r1.stdout
    assert "epoch    3" in r1.stdout and "epoch    4" not in r1.stdout

    # the save of epoch 3 may still be in flight at the crash (atomic
    # commit: never a torn one), so the resume point is epoch 4 or 2
    r2 = _run(_common(tmp_path, "ck_b") + ["--resume", "--metrics", "--out", str(tmp_path / "b.npy")])
    assert r2.returncode == 0, r2.stdout[-2000:] + r2.stderr[-2000:]
    assert "resume: epoch 4 (ckpt step 3)" in r2.stdout or "resume: epoch 2 (ckpt step 1)" in r2.stdout, r2.stdout
    assert "index: cache" in r2.stdout, r2.stdout
    assert "NP@10=" in r2.stdout and " triplet=" in r2.stdout
    a, b = np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy")
    assert a.shape == (4000, 2) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    r = _run(["--workload", "nomad_quickstart", "--n-points", "1500", "--epochs", "2", "--device", "cpu", "--resume",
              "--checkpoint-dir", str(tmp_path / "none")])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "resume:" not in r.stdout and "index: local" in r.stdout
    assert "stages {" in r.stdout


@pytest.mark.parametrize("args", [["--mesh", "2x4"], ["--mesh", "4"], ["--host-devices", "8"], ["--hierarchical"]])
def test_multi_device_options_exit_2(args):
    r = _run(args + ["--device", "cpu"], timeout=60)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "queue 1 item 5" in r.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal of a machine without a card")
def test_default_device_is_the_card():
    r = _run(["--n-points", "1000", "--epochs", "1"], timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
