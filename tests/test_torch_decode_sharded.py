"""The port's length-sharded flash-decode (``attention.attend_decode_sharded``
over a mesh of shard slots) against the JAX package's under ``shard_map``,
computed in one subprocess with 8 forced host devices:

* the batch over ``data`` and the cache length over ``model`` on (2, 2) and
  (2, 4), with and without a sliding window, and the batch whole (batch
  axes None, a batch-1 long-context decode) with the length over every
  axis of (1, 4), within (1e-5, 1e-6);
* ``decode_step`` with the context set ≡ without it within 1e-5 (each
  step's ‖Δlogits‖/‖logits‖) for reduced Phi-4-mini and for Mixtral across
  its SWA ring's wrap; each slot's block and the dispatch rules.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = (1e-5, 1e-6)
REL = 1e-5
B, SC, H, KV, HD = 4, 32, 4, 2, 16
# (id, mesh, batch axes, length axes, window)
CASES = [
    ("b_data_s_model", (2, 2), "data", ["model"], 0),
    ("b_data_s_model_window", (2, 2), "data", ["model"], 5),
    ("b_data_s_model_24", (2, 4), "data", ["model"], 0),
    ("b_none_s_all", (1, 4), None, ["data", "model"], 0),
    ("b_none_s_all_window", (1, 4), None, ["data", "model"], 7),
]

_REFERENCE = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.models import attention

cases, data = json.loads(sys.argv[1]), np.load(sys.argv[2])
args = [jnp.asarray(data[k]) for k in ("q", "k", "v", "q_pos", "k_pos", "valid")]
out = {}
for cid, mesh, baxes, saxes, window in cases:
    attention.set_decode_context(make_mesh(tuple(mesh), ("data", "model")), baxes, saxes)
    out[cid] = np.asarray(attention.dispatch_attend_decode(*args, window=window))
    attention.set_decode_context(None, None, ())
np.savez(sys.argv[3], **out)
print("DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    valid = rng.random((B, SC)) < 0.85
    valid[:, 0] = True
    return {"q": rng.normal(0, 1, (B, 1, H, HD)).astype(np.float32),
            "k": rng.normal(0, 1, (B, SC, KV, HD)).astype(np.float32),
            "v": rng.normal(0, 1, (B, SC, KV, HD)).astype(np.float32),
            "q_pos": np.full((B, 1), SC + 3, np.int32),
            "k_pos": np.tile(np.arange(SC, dtype=np.int32) + 4, (B, 1)),
            "valid": valid}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_sharded")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CASES), str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _port_args():
    return [torch.from_numpy(v) for v in _inputs().values()]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_decode_equals_the_reference(case, reference):
    cid, mesh_shape, baxes, saxes, window = case
    mesh = make_mesh(mesh_shape, ("data", "model"), ["cpu"] * int(np.prod(mesh_shape)))
    attention.set_decode_context(mesh, baxes, saxes)
    try:
        got = attention.dispatch_attend_decode(*_port_args(), window=window)
    finally:
        attention.set_decode_context(None, None, ())
    np.testing.assert_allclose(got.numpy(), reference[cid], rtol=TOL[0], atol=TOL[1])
    # and the unsharded decode of the same inputs, within the same bound
    plain = attention.attend_decode(*_port_args(), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL[0], atol=TOL[1])


def _decode_runs(arch: str, prompt: int, steps: int, mesh, baxes, saxes):
    cfg = reduced(ARCHS[arch])
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    Bd = 4 if baxes else 1
    toks = torch.randint(0, cfg.vocab_size, (Bd, prompt + steps), generator=torch.Generator().manual_seed(1))
    _, _, stacked = lm.forward(model, cfg, tokens=toks[:, :prompt], with_cache=True)
    cache = lm.load_cache_from_prefill(cfg, lm.init_cache(cfg, Bd, 64, prompt, device="cpu"), stacked, prompt)
    runs = []
    for ctx in (None, mesh):
        c = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}
        attention.set_decode_context(ctx, baxes, saxes)
        try:
            logits = [lm.decode_step(model, cfg, c, toks[:, t : t + 1])[0][:, 0] for t in range(prompt, prompt + steps)]
        finally:
            attention.set_decode_context(None, None, ())
        runs.append(torch.stack(logits, 1))
    return cfg, cache, runs


@pytest.mark.parametrize("arch,prompt,steps,mesh_shape,baxes,saxes", [
    ("phi4-mini-3.8b", 20, 4, (2, 2), "data", ("model",)),
    ("phi4-mini-3.8b", 20, 4, (1, 4), None, ("data", "model")),
    ("mixtral-8x7b", 30, 4, (2, 2), "data", ("model",)),  # window 16: prefill 30 wraps, decode writes slot 0
    ("mixtral-8x7b", 30, 4, (1, 4), None, ("data", "model")),
])
def test_decode_step_with_the_context_equals_without(arch, prompt, steps, mesh_shape, baxes, saxes):
    mesh = make_mesh(mesh_shape, ("data", "model"), ["cpu"] * 4)
    cfg, cache, (plain, sharded) = _decode_runs(arch, prompt, steps, mesh, baxes, saxes)
    if cfg.sliding_window:
        Sc = cache["k"].shape[2]
        assert prompt > Sc and any(t % Sc == 0 for t in range(prompt, prompt + steps))
    rel = (sharded - plain).norm(dim=-1) / plain.norm(dim=-1)
    assert float(rel.max()) <= REL, float(rel.max())
    assert torch.equal(sharded.argmax(-1), plain.argmax(-1))


def test_context_dispatch_and_blocks():
    args = _port_args()
    assert attention._DECODE_CTX is None
    plain = attention.dispatch_attend_decode(*args)
    assert torch.equal(plain, attention.attend_decode(*args))
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    attention.set_decode_context(one, "data", ("model",))
    try:
        got = attention.dispatch_attend_decode(*args)  # one slot: the whole cache, rescaled by exp(0) = 1
    finally:
        attention.set_decode_context(None, None, ())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-7)
    mesh = make_mesh((1, 3), ("data", "model"), ["cpu"] * 3)
    attention.set_decode_context(mesh, None, ("model",))
    try:
        with pytest.raises(ValueError, match="does not split"):  # Sc 32 over 3 slots
            attention.dispatch_attend_decode(*args)
    finally:
        attention.set_decode_context(None, None, ())
