"""The port's launcher (``python -m repro_torch.launch.train``) by
subprocess on the CPU: a run killed at an epoch (exit 17) and resumed from
its asynchronous checkpoint reloads the cached index and ends on the
uninterrupted run's embedding bit for bit, on one device and on a mesh of
shard slots (``--host-devices``/``--mesh``/``--hierarchical``), where the
embedding also equals the in-process strategy fit on the same slots. The
JAX package's ``tests/test_distributed.py`` crash test, with the resumed
embedding held to the uninterrupted one.

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


def _in_process_fit(n: int, epochs: int, dims, axes, strategy: str, hierarchical: bool = False):
    """The fit the launcher runs, built here: its config and data, the
    strategy named, on a mesh of ``prod(dims)`` CPU slots."""
    from repro_torch.configs import get_nomad
    from repro_torch.core import NomadProjection
    from repro_torch.data.synthetic import hierarchical_mixture
    from repro_torch.launch.mesh import make_mesh

    cfg = get_nomad("nomad_quickstart").replace(n_points=n, n_epochs=epochs, hierarchical=hierarchical)
    x, _sup, _sub = hierarchical_mixture(cfg.n_points, cfg.dim, seed=cfg.seed)
    mesh = make_mesh(dims, axes, ["cpu"] * int(np.prod(dims)))
    torch.set_num_threads(1)
    res = NomadProjection(cfg, strategy=strategy, mesh=mesh, device="cpu").fit(x)
    return res


def _mesh_run(tmp_path, name: str, args, n: int = 2000, epochs: int = 3):
    out = tmp_path / f"{name}.npy"
    r = _run(["--workload", "nomad_quickstart", "--n-points", str(n), "--epochs", str(epochs), "--device", "cpu",
              "--out", str(out), *args])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r, np.load(out)


def test_mesh_2x4_equals_sharded_strategy(tmp_path):
    r, emb = _mesh_run(tmp_path, "m", ["--host-devices", "8", "--mesh", "2x4"])
    assert "mesh (2, 4) axes ('data', 'model'); 8 shards" in r.stdout
    assert "index: sharded" in r.stdout and "stages {" in r.stdout
    res = _in_process_fit(2000, 3, (2, 4), ("data", "model"), "sharded")
    assert res.strategy == "sharded" and res.n_shards == 8
    assert emb.shape == (2000, 2) and np.isfinite(emb).all()
    np.testing.assert_array_equal(emb, res.embedding)


def test_mesh_2x2x2_hierarchical_equals_hierarchical_strategy(tmp_path):
    r, emb = _mesh_run(tmp_path, "h", ["--host-devices", "8", "--mesh", "2x2x2", "--hierarchical"])
    assert "mesh (2, 2, 2) axes ('pod', 'data', 'model'); 8 shards" in r.stdout
    res = _in_process_fit(2000, 3, (2, 2, 2), ("pod", "data", "model"), "hierarchical", hierarchical=True)
    assert res.strategy == "hierarchical"
    np.testing.assert_array_equal(emb, res.embedding)
    # the flat exchange on the same slots is another fit
    flat = _in_process_fit(2000, 3, (2, 2, 2), ("pod", "data", "model"), "sharded")
    assert not np.array_equal(emb, flat.embedding)


def test_mesh_crash_resume_equals_uninterrupted(tmp_path):
    mesh = ["--host-devices", "8", "--mesh", "2x4", "--checkpoint-every", "1"]
    _r0, a = _mesh_run(tmp_path, "a", mesh + ["--checkpoint-dir", str(tmp_path / "ck_a")], epochs=5)
    ck = ["--workload", "nomad_quickstart", "--n-points", "2000", "--epochs", "5", "--device", "cpu",
          "--checkpoint-dir", str(tmp_path / "ck_b"), *mesh]
    r1 = _run(ck + ["--fail-at-epoch", "3"])
    assert r1.returncode == 17, r1.stdout[-2000:] + r1.stderr[-2000:]
    assert "CRASH INJECTION at epoch 3" in r1.stdout
    r2 = _run(ck + ["--resume", "--metrics", "--out", str(tmp_path / "b.npy")])
    assert r2.returncode == 0, r2.stdout[-2000:] + r2.stderr[-2000:]
    assert "resume: epoch 3 (ckpt step 2)" in r2.stdout or "resume: epoch 2 (ckpt step 1)" in r2.stdout, r2.stdout
    assert "index: cache" in r2.stdout and "NP@10=" in r2.stdout
    np.testing.assert_array_equal(a, np.load(tmp_path / "b.npy"))


@pytest.mark.parametrize("args,needs", [(["--mesh", "4"], "needs 4 slots"), (["--mesh", "2x4"], "needs 8 slots"),
                                        (["--host-devices", "2", "--mesh", "2x2x2"], "needs 8 slots")])
def test_mesh_larger_than_the_slots_exits_2(args, needs):
    r = _run(args + ["--device", "cpu"], timeout=60)
    assert r.returncode == 2, r.stdout + r.stderr
    assert needs in r.stderr and "Traceback" not in r.stderr


def test_one_slot_prints_the_mesh_line_and_fits_locally(tmp_path):
    r, emb = _mesh_run(tmp_path, "one", ["--mesh", "1"], n=1500, epochs=2)
    assert "mesh (1,) axes ('data',); 1 shards" in r.stdout and "device cpu; 1 shard" in r.stdout
    assert "index: local" in r.stdout
    r2, emb2 = _mesh_run(tmp_path, "none", [], n=1500, epochs=2)
    assert "mesh (1,) axes ('data',); 1 shards" in r2.stdout
    np.testing.assert_array_equal(emb, emb2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal of a machine without a card")
def test_default_device_is_the_card():
    r = _run(["--n-points", "1000", "--epochs", "1"], timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
