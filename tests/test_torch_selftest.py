"""The port's two selftests on the CPU, each as the subprocess a user runs:

* ``python -m repro_torch.launch.selftest --device cpu``: the reference's
  four parts on 8 shard slots (quality parity of the (2, 4) sharded fit,
  determinism, the ``fit_distributed`` shim, the (2, 2, 2) hierarchical
  fit, ``kmeans_fit_sharded`` ≡ single-slot EM), ending ``SELFTEST PASS``;
* ``python -m repro_torch.launch.selftest_pipeline --device cpu``: the MLP
  and reduced-Qwen3 GPipe stacks ≡ sequential and T = n_micro + stages −
  1, ending ``PIPELINE SELFTEST PASS``.

Also the shim's default ``shard_axes`` is the reference's ("data",
"model"), which a (2, 4) mesh needs (the port's was ("data",), which
refused that mesh).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module, "--device", "cpu"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_selftest_passes_on_cpu_slots():
    out = _run("repro_torch.launch.selftest")
    assert out.rstrip().endswith("SELFTEST PASS")
    for line in ("determinism: OK", "fit_distributed shim: OK (DeprecationWarning emitted)"):
        assert line in out
    np_ref, np_dist = map(float, re.search(r"NP@10 ref=([\d.]+) dist=([\d.]+)", out).groups())
    assert np_dist > 0.5 * np_ref - 0.01
    err = float(re.search(r"distributed kmeans max err: (\S+)", out).group(1))
    assert err < 1e-2
    assert "hierarchical NP@10=" in out


def test_pipeline_selftest_passes_bit_equal_on_cpu_slots():
    out = _run("repro_torch.launch.selftest_pipeline")
    assert out.rstrip().endswith("PIPELINE SELFTEST PASS")
    assert "schedule: T = 9 = n_micro 6 + stages 4 - 1" in out
    errs = [float(e) for e in re.findall(r"gpipe max err: (\S+)", out)]
    assert errs == [0.0, 0.0]  # one device: the stages run the sequential arithmetic


def test_fit_distributed_defaults_to_the_references_shard_axes():
    """A (2, 2) data × model mesh through the deprecated shim with its
    default shard_axes: 4 shards, as the reference's shim gives."""
    from repro_torch.configs import NomadConfig
    from repro_torch.core.distributed import fit_distributed
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.launch.mesh import make_mesh

    cfg = NomadConfig(n_points=800, dim=8, n_clusters=8, n_neighbors=5, n_noise=8, n_exact_negatives=4,
                      batch_size=64, n_epochs=2)
    x, _ = gaussian_mixture(cfg.n_points, cfg.dim, n_components=4, seed=0)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with pytest.warns(DeprecationWarning, match="fit_distributed"):
        emb, index, losses = fit_distributed(cfg, x, mesh, device="cpu")
    assert emb.shape == (cfg.n_points, 2) and np.isfinite(emb).all() and len(losses) == cfg.n_epochs
