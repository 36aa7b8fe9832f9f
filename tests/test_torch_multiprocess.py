"""The port's multi-process fit over torch.distributed with gloo on the CPU.

The contract (tests/test_multiprocess.py's, on the port): a 2-process fit,
each process reading its own rows of a shared store, ≡ the 1-process fit
over the same 2 shard slots, bit for bit: the embedding and ``knn_idx``,
``knn_w``, ``counts``, ``centroids``, ``perm``. A run crashed at epoch 2
(exit 17) and resumed ≡ the uninterrupted run. A missing coordinator
exits 3 at once; an unreachable one exits within its timeout.

The slow tests run ``python -m repro_torch.launch.distributed --device
cpu`` in subprocesses (``--spawn 2``: a local coordinator on a free port),
each with its own timeout and one intra-op thread; the fast ones cover
the launcher's pieces in process.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import distributed as launch  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:  # the coordinator needs a loopback TCP port
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as _s:
        _s.bind(("127.0.0.1", 0))
except OSError as e:  # pragma: no cover - environment-dependent
    pytest.skip(f"no loopback TCP available ({e})", allow_module_level=True)


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def _tail(r) -> str:
    return r.stdout[-2000:] + r.stderr[-3000:]


# ---------------------------------------------------------------------------
# fast: the launcher's pieces, in process
# ---------------------------------------------------------------------------


def test_parse_args_has_the_reference_flags():
    a = launch.parse_args(["--spawn", "2", "--host-devices", "4", "--init-timeout", "5", "--store", "s",
                           "--checkpoint-dir", "ck", "--checkpoint-every", "1", "--resume", "--fail-at-epoch", "2",
                           "--out", "e.npy", "--dump-index", "i.npz", "--stats", "st.json", "--chunk-rows", "64"])
    assert (a.spawn, a.host_devices, a.init_timeout, a.fail_at_epoch, a.chunk_rows) == (2, 4, 5, 2, 64)
    assert a.resume and a.num_processes == 1 and a.process_id == 0 and a.device is None


def test_backend_follows_the_device():
    assert launch.backend_for("cpu") == "gloo"
    assert launch.backend_for("cuda:0") == "nccl"
    assert 0 < launch.pick_free_port() < 65536


def test_init_needs_a_coordinator_for_several_processes():
    with pytest.raises(ValueError, match="coordinator"):
        launch.initialize_distributed("", 2, 1, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        launch.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")


def test_spawn_strips_its_flag_and_sets_one_thread(monkeypatch):
    calls = []

    class Done:
        def __init__(self, cmd, env):
            calls.append((cmd, env))

        def poll(self):
            return 0

        def wait(self):
            return 17 if "1" == self.cmd_id else 0

    def popen(cmd, env):
        p = Done(cmd, env)
        p.cmd_id = cmd[cmd.index("--process-id") + 1]
        return p

    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    monkeypatch.setattr(launch.subprocess, "Popen", popen)
    argv = ["--device", "cpu", "--spawn", "2", "--epochs", "1"]
    assert launch.main(argv) == 17  # the first failing worker's status
    assert len(calls) == 2
    for i, (cmd, env) in enumerate(calls):
        assert "--spawn" not in cmd and cmd[cmd.index("--process-id") + 1] == str(i)
        assert cmd[cmd.index("--num-processes") + 1] == "2" and "--coordinator" in cmd
        assert env["OMP_NUM_THREADS"] == "1"


def test_every_process_waits_on_the_index_cache(tmp_path, monkeypatch):
    """A peer that finds process 0's index cache already written still
    joins the barrier after it, and writes nothing: deciding by the file,
    it could skip the barrier and leave process 0 waiting there."""
    from repro_torch.configs import NomadConfig
    from repro_torch.core import nomad, strategy
    from repro_torch.core.nomad import NomadProjection
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.launch import mesh

    cfg = NomadConfig(n_points=600, dim=8, n_clusters=4, n_neighbors=5, n_noise=8, n_exact_negatives=4,
                      batch_size=128, n_epochs=1, checkpoint_dir=str(tmp_path))
    x, _ = gaussian_mixture(600, 8, n_components=4, seed=0)
    first = NomadProjection(cfg, device="cpu").fit(x)  # process 0's run: index.npz written
    cache = tmp_path / "index.npz"
    stamp = cache.stat().st_mtime_ns
    calls = []
    monkeypatch.setattr(nomad, "process_count", lambda: 2)
    monkeypatch.setattr(nomad, "process_index", lambda: 1)
    monkeypatch.setattr(strategy, "sync_processes", lambda tag="sync": calls.append(tag))
    NomadProjection(cfg, strategy="sharded", mesh=mesh.flat_mesh("data", ["cpu"]), device="cpu").fit(
        x, index=first.index, resume=False)
    assert calls[0] == "index-cache" and calls[1:] == ["ckpt-0"]
    assert cache.stat().st_mtime_ns == stamp


# ---------------------------------------------------------------------------
# slow: real processes over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from repro_torch.data.store import write_sharded
    from repro_torch.data.synthetic import gaussian_mixture

    x, _ = gaussian_mixture(4000, 16, n_components=8, seed=3)
    d = str(tmp_path_factory.mktemp("mp") / "store")
    write_sharded(x, d, rows_per_shard=1000)
    return d


@pytest.mark.slow
def test_two_process_fit_bit_equal_to_single(corpus, tmp_path):
    ref_out, ref_idx = str(tmp_path / "ref.npy"), str(tmp_path / "ref.npz")
    mp_out, mp_idx = str(tmp_path / "mp.npy"), str(tmp_path / "mp.npz")
    r1 = _run(["--num-processes", "1", "--host-devices", "2", "--store", corpus, "--epochs", "3",
               "--out", ref_out, "--dump-index", ref_idx])
    assert r1.returncode == 0, _tail(r1)
    assert "processes=1 backend=gloo" in r1.stdout and "shards=2" in r1.stdout
    r2 = _run(["--spawn", "2", "--store", corpus, "--epochs", "3", "--out", mp_out, "--dump-index", mp_idx])
    assert r2.returncode == 0, _tail(r2)
    assert "processes=2 backend=gloo" in r2.stdout and "index: distributed" in r2.stdout
    np.testing.assert_array_equal(np.load(ref_out), np.load(mp_out))
    ref, got = np.load(ref_idx), np.load(mp_idx)
    for k in ("knn_idx", "knn_w", "counts", "centroids", "perm"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


@pytest.mark.slow
def test_two_process_crash_then_resume_bit_equal(corpus, tmp_path):
    ck = str(tmp_path / "ck")
    resumed, straight = str(tmp_path / "resumed.npy"), str(tmp_path / "straight.npy")
    common = ["--spawn", "2", "--store", corpus, "--epochs", "4"]
    crash = _run([*common, "--checkpoint-dir", ck, "--checkpoint-every", "1", "--fail-at-epoch", "2"])
    assert crash.returncode == 17, _tail(crash)
    assert "CRASH INJECTION at epoch 2" in crash.stdout
    resume = _run([*common, "--checkpoint-dir", ck, "--resume", "--out", resumed])
    assert resume.returncode == 0, _tail(resume)
    assert "resume: epoch 2" in resume.stdout  # every save committed before the barrier
    assert "index: cache" in resume.stdout  # process 0's cached index, read by both
    clean = _run([*common, "--out", straight])
    assert clean.returncode == 0, _tail(clean)
    np.testing.assert_array_equal(np.load(resumed), np.load(straight))


@pytest.mark.slow
def test_missing_coordinator_fails_fast_and_loud():
    r = _run(["--num-processes", "2", "--process-id", "1", "--epochs", "1"], timeout=120)
    assert r.returncode == 3, _tail(r)
    assert "distributed init failed" in r.stderr


@pytest.mark.slow
def test_unreachable_coordinator_does_not_hang():
    port = launch.pick_free_port()  # nothing listens here
    r = _run(["--num-processes", "2", "--process-id", "1", "--coordinator", f"127.0.0.1:{port}",
              "--init-timeout", "3", "--epochs", "1"], timeout=120)
    assert r.returncode == 3, _tail(r)
    assert "distributed init failed" in r.stderr
