"""The port's compressed all-reduce (``repro_torch.optim.compression``)
against the JAX package's:

* ``_quant``/``_dequant`` bit-equal to the reference's (int8 blocks of
  256, scale = max(|block| / 127, 1e-12), round half to even), padded and
  not, with ties at .5 and all-zero blocks;
* ``compressed_psum`` on 1, 2 and 4 slots, each slot its own gradient and
  residual, against the reference's under ``shard_map`` (one subprocess
  with 4 forced host devices): the residuals bit for bit, the mean within
  1e-6 (XLA's all-reduce adds in its own order; the port in mesh order);
* ``tests/test_optim.py``'s telescoping test on the port's quantiser, and
  the slots of one mesh agree bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.optim import compression as ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"w": (40, 33), "b": (7,), "e": (3, 256)}
STEPS = 3

_REFERENCE = r"""
import functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.optim.compression import compressed_psum

shapes, steps, data = json.loads(sys.argv[1]), int(sys.argv[2]), np.load(sys.argv[3])
out = {}
for n in (1, 2, 4):
    mesh = make_mesh((n,), ("d",))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("d"), P("d")), out_specs=(P("d"), P("d")), check_rep=False)
    def run(g, r):
        red, new_r = compressed_psum(jax.tree.map(lambda a: a[0], g), "d", jax.tree.map(lambda a: a[0], r))
        return jax.tree.map(lambda a: a[None], red), jax.tree.map(lambda a: a[None], new_r)

    r = {k: jnp.zeros((n,) + tuple(s), jnp.float32) for k, s in shapes.items()}
    for t in range(steps):
        g = {k: jnp.asarray(data[f"{k}/{t}"][:n]) for k in shapes}
        red, r = run(g, r)
        for k in shapes:
            out[f"{n}/{t}/red/{k}"], out[f"{n}/{t}/res/{k}"] = np.asarray(red[k]), np.asarray(r[k])
np.savez(sys.argv[4], **out)
print("DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grads() -> dict:
    rng = np.random.default_rng(3)
    return {f"{k}/{t}": (rng.normal(0, 1, (4,) + s) * rng.uniform(0.1, 10)).astype(np.float32)
            for t in range(STEPS) for k, s in SHAPES.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    np.savez(d / "in.npz", **_grads())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(SHAPES), str(STEPS), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("shape", [(256,), (1000,), (3, 5, 17), (2, 256)])
def test_quant_and_dequant_bit_equal_to_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0, 1, shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    flat[: min(256, flat.size)] = 0.0  # an all-zero block: the 1e-12 floor
    if flat.size > 300:
        flat[256:300] = np.float32(127.0) * (np.arange(44) + 0.5) / 44  # scale 1 a block, .5 ties
    q, scale, pad = compression._quant(torch.from_numpy(x))
    rq, rscale, rpad = ref._quant(jnp.asarray(x))
    assert pad == rpad and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    back = compression._dequant(q, scale, pad, x.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref._dequant(rq, rscale, rpad, x.shape)))


def _port_run(n: int):
    g = _grads()
    mesh = make_mesh((n,), ("d",), ["cpu"] * n)
    res = [{k: torch.zeros(s) for k, s in SHAPES.items()} for _ in range(n)]
    outs = []
    for t in range(STEPS):
        grads = [{k: torch.from_numpy(g[f"{k}/{t}"][i]) for k in SHAPES} for i in range(n)]
        red, res = compression.compressed_psum(grads, mesh, "d", res)
        outs.append((red, res))
    return outs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_equals_the_reference(n, reference):
    for t, (red, res) in enumerate(_port_run(n)):
        for k in SHAPES:
            want_red, want_res = reference[f"{n}/{t}/red/{k}"], reference[f"{n}/{t}/res/{k}"]
            for i in range(n):
                np.testing.assert_array_equal(res[i][k].numpy(), want_res[i])
                np.testing.assert_allclose(red[i][k].numpy(), want_red[i], rtol=1e-6, atol=1e-6)
                assert torch.equal(red[i][k], red[0][k])  # every slot holds the same mean
            if n <= 2:  # two terms add in one order
                np.testing.assert_array_equal(red[0][k].numpy(), want_red[0])


def test_compression_error_feedback_telescopes():
    """Over T steps, Σ sent ≈ Σ grads (the bias is carried, not lost):
    tests/test_optim.py's test on the port's quantiser."""
    rng = np.random.default_rng(0)
    total_g = np.zeros(1000, np.float32)
    total_sent = np.zeros(1000, np.float32)
    r = np.zeros(1000, np.float32)
    for _ in range(30):
        g = rng.normal(0, 1, 1000).astype(np.float32)
        acc = g + r
        q, scale, pad = compression._quant(torch.from_numpy(acc))
        sent = compression._dequant(q, scale, pad, (1000,)).numpy()
        r = acc - sent
        total_g += g
        total_sent += sent
    np.testing.assert_allclose(total_sent + r, total_g, rtol=1e-5, atol=1e-4)
    assert np.abs(r).max() < 0.1


def test_compressed_psum_single_slot_tree_shapes():
    """tests/test_optim.py's single-axis case: one slot's mean is its own
    dequantised gradient (within a quantisation step); trees of dicts,
    lists and tuples come back in their shapes."""
    mesh = make_mesh((1,), ("d",), ["cpu"])
    g = {"w": torch.linspace(-2, 2, 512), "more": [torch.ones(3), (torch.zeros(2, 2),)]}
    r = {"w": torch.zeros(512), "more": [torch.zeros(3), (torch.zeros(2, 2),)]}
    (red,), (new_r,) = compression.compressed_psum([g], mesh, "d", [r])
    np.testing.assert_allclose(red["w"].numpy(), g["w"].numpy(), atol=0.02)
    assert isinstance(red["more"], list) and isinstance(red["more"][1], tuple)
    assert torch.equal(red["more"][0], torch.ones(3)) and torch.equal(new_r["more"][1][0], torch.zeros(2, 2))
    with pytest.raises(ValueError, match="local slots"):
        compression.compressed_psum([g, g], mesh, "d", [r])
