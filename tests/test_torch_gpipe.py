"""The port's GPipe schedule (``repro_torch.launch.pipeline``):

* the reference selftest's MLP stack (8 layers, 4 stages × 2, 6
  microbatches) ≡ sequential application bit for bit, and within 1e-5 of
  the JAX package's ``gpipe`` on the same weights (one subprocess with 4
  forced host devices);
* reduced Qwen3 transformer layers through the same harness ≡ sequential
  bit for bit (the reference's bound is 2e-4);
* the schedule runs T = n_micro + n_stages − 1 steps; stage groups are
  contiguous; a stage axis beside another mesh axis replicates.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.pipeline import gpipe, stack_stage_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, N_MICRO, BM, STAGES = 8, 64, 6, 16, 4

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.launch.pipeline import gpipe, stack_stage_params

data = np.load(sys.argv[1])
params = {"w": jnp.asarray(data["w"])}

def stage_fn(sp, x):
    return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, sp["w"])[0]

run = gpipe(make_mesh((4,), ("stage",)), "stage", stage_fn, data["x"].shape[0])
np.save(sys.argv[2], np.asarray(run(stack_stage_params(params, 4), jnp.asarray(data["x"]))))
print("DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp():
    rng = np.random.default_rng(0)
    w = (rng.normal(0, 1, (L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(0, 1, (N_MICRO, BM, D)).astype(np.float32)
    return w, x


def _mlp_stage(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpipe")
    w, x = _mlp()
    np.savez(d / "in.npz", w=w, x=x)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"), str(d / "out.npy")],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return np.load(d / "out.npy")


def _stage_mesh():
    return make_mesh((STAGES,), ("stage",), ["cpu"] * STAGES)


def test_mlp_gpipe_equals_sequential_and_the_reference(reference):
    w, x = _mlp()
    ws = list(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    run = gpipe(_stage_mesh(), "stage", _mlp_stage, N_MICRO)
    got = run(stack_stage_params(ws, STAGES), xt)
    want = torch.stack([_mlp_stage(ws, xt[i]) for i in range(N_MICRO)])
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), reference, rtol=1e-5, atol=1e-5)  # the reference's bound
    assert run.steps == N_MICRO + STAGES - 1


def test_transformer_stages_equal_sequential():
    cfg = reduced(ARCHS["qwen3-14b"], n_layers=8)
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(2))
    x = torch.randn((N_MICRO, 2, 32, cfg.d_model), generator=torch.Generator().manual_seed(3))
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)

    def tf_stage(layers, h):
        aux = torch.zeros(())
        for layer in layers:
            h, aux, _ = layer(h, aux, pos, cfg, True)
        return h

    with torch.no_grad():
        got = gpipe(_stage_mesh(), "stage", tf_stage, N_MICRO)(stack_stage_params(list(model.layers), STAGES), x)
        want = torch.stack([tf_stage(list(model.layers), x[i]) for i in range(N_MICRO)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_micro,stages", [(1, 4), (3, 2), (6, 4), (2, 1)])
def test_schedule_length_and_order(n_micro, stages):
    """Each stage adds its index: the output is x + Σ stages' work in order
    (T = n_micro + stages − 1 steps), through a (2, stages) mesh whose
    other axis replicates."""
    mesh = make_mesh((2, stages), ("data", "stage"), ["cpu"] * (2 * stages))
    seen = []

    def stage_fn(sp, x):
        seen.append(sp[0])
        return x * 10 + sp[0]

    run = gpipe(mesh, "stage", stage_fn, n_micro)
    x = torch.arange(n_micro, dtype=torch.float64)[:, None]
    got = run(stack_stage_params(list(range(1, stages + 1)), stages), x)
    want = x.clone()
    for s in range(1, stages + 1):
        want = want * 10 + s
    assert torch.equal(got, want) and run.steps == n_micro + stages - 1
    assert len(seen) == 2 * n_micro * stages  # bubbles run nothing; two replicas along data


def test_stack_stage_params_cuts_contiguous_groups():
    assert stack_stage_params(list(range(8)), 4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="do not split"):
        stack_stage_params(list(range(6)), 4)
