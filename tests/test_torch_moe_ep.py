"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_ep`` over a
mesh of shard slots) against the JAX package's ``moe_ep`` under
``shard_map``, computed in one subprocess with 8 forced host devices:

* true EP (E % model == 0) on (1, 2), (1, 4) and (2, 2); the F split
  (model % E == 0) on (1, 4) and (2, 4); the weights-stationary layout
  (E over model, F over data, tokens replicated) on (2, 2) — for reduced
  Mixtral (top-2) and Scout (top-1, a shared expert) at a capacity that
  drops tokens, within (1e-5, 1e-5);
* at data 1 with top-k ≤ 2, true EP ≡ the port's ``moe_sort`` bit for bit
  (a token adds at most two nonzero terms), through ``moe_block`` and
  through ``lm.forward`` with the mesh set.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.layers import SwiGLU  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = (1e-5, 1e-5)
# (id, arch, config overrides, mesh, stationary)
CASES = [
    ("mixtral_ep12", "mixtral-8x7b", {"capacity_factor": 1.0}, (1, 2), False),
    ("mixtral_ep14", "mixtral-8x7b", {"capacity_factor": 1.0}, (1, 4), False),
    ("mixtral_ep22", "mixtral-8x7b", {"capacity_factor": 1.0}, (2, 2), False),
    ("scout_ep12", "llama4-scout-17b-a16e", {"capacity_factor": 1.0}, (1, 2), False),
    ("scout_ep14", "llama4-scout-17b-a16e", {"capacity_factor": 1.0}, (1, 4), False),
    ("scout_ep22", "llama4-scout-17b-a16e", {"capacity_factor": 1.0}, (2, 2), False),
    ("mixtral_f14", "mixtral-8x7b", {"n_experts": 2, "capacity_factor": 1.0}, (1, 4), False),
    ("mixtral_f24", "mixtral-8x7b", {"n_experts": 2, "capacity_factor": 1.0}, (2, 4), False),
    ("mixtral_st22", "mixtral-8x7b", {"capacity_factor": 1.0}, (2, 2), True),
    ("scout_st22", "llama4-scout-17b-a16e", {"capacity_factor": 1.0}, (2, 2), True),
]

_REFERENCE = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.configs import ARCHS, reduced
from repro.launch.mesh import make_mesh
from repro.models import moe

cases, data = json.loads(sys.argv[1]), np.load(sys.argv[2])
out = {}
for cid, arch, over, mesh, stationary in cases:
    cfg = reduced(ARCHS[arch], **over)
    g = lambda k: jnp.asarray(data[cid + "/" + k])
    shared = {k: g("shared_" + k) for k in ("w_gate", "w_up", "w_down")} if cid + "/shared_w_gate" in data else None
    p = moe.MoEParams(g("router"), g("w_gate"), g("w_up"), g("w_down"), shared)
    moe.set_ep_mesh(make_mesh(tuple(mesh), ("data", "model")), ("data",), stationary=stationary)
    y, aux = moe.moe_block(p, g("x"), cfg)
    moe.set_ep_mesh(None, ())
    out[cid + "/y"], out[cid + "/aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[3], **out)
print("DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch, over):
    return reduced(ARCHS[arch], **over)


def _weights(cid, arch, over) -> dict:
    cfg = _cfg(arch, over)
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.normal(0, D ** -0.5, (D, E)), "w_gate": rng.normal(0, D ** -0.5, (E, D, F)),
         "w_up": rng.normal(0, D ** -0.5, (E, D, F)), "w_down": rng.normal(0, F ** -0.5, (E, F, D)),
         "x": rng.normal(0, 1, (4, 8, D))}
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        w.update(shared_w_gate=rng.normal(0, D ** -0.5, (D, Fs)), shared_w_up=rng.normal(0, D ** -0.5, (D, Fs)),
                 shared_w_down=rng.normal(0, Fs ** -0.5, (Fs, D)))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _port_params(w) -> moe.MoEParams:
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    shared = SwiGLU(t["shared_w_gate"], t["shared_w_up"], t["shared_w_down"]) if "shared_w_gate" in t else None
    return moe.MoEParams(t["router"], t["w_gate"], t["w_up"], t["w_down"], shared)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's (y, aux) from the JAX package's moe_ep: one subprocess
    with 8 forced host devices (the flag must precede jax's start)."""
    d = tmp_path_factory.mktemp("moe_ep")
    data = {f"{cid}/{k}": v for cid, arch, over, _m, _s in CASES for k, v in _weights(cid, arch, over).items()}
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CASES), str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _port(cid, arch, over, mesh_shape, stationary):
    cfg = _cfg(arch, over)
    w = _weights(cid, arch, over)
    mesh = make_mesh(mesh_shape, ("data", "model"), ["cpu"] * int(np.prod(mesh_shape)))
    moe.set_ep_mesh(mesh, ("data",), stationary=stationary)
    try:
        y, aux = moe.moe_block(_port_params(w), torch.from_numpy(w["x"]), cfg)
    finally:
        moe.set_ep_mesh(None, ())
    return cfg, w, y, aux


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ep_equals_the_reference(case, reference):
    cid = case[0]
    cfg, _w, y, aux = _port(*case)
    np.testing.assert_allclose(y.numpy(), reference[cid + "/y"], rtol=TOL[0], atol=TOL[1])
    np.testing.assert_allclose(float(aux), float(reference[cid + "/aux"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", [c for c in CASES if c[3][0] == 1 and not c[4] and c[0].split("_")[1][0] == "e"],
                         ids=lambda c: c[0])
def test_true_ep_at_data_1_equals_sort_bit_for_bit(case):
    cid, arch, over, _mesh, _st = case
    cfg, w, y, aux = _port(*case)
    assert cfg.top_k <= 2 and cfg.n_experts % case[3][1] == 0
    y_sort, aux_sort = moe.moe_sort(_port_params(w), torch.from_numpy(w["x"]), cfg)
    assert torch.equal(y, y_sort) and torch.equal(aux, aux_sort)


def test_capacity_drops_tokens_in_these_cases():
    """The cases run at capacity factor 1: some choices lose their slot,
    so the per-block capacity of a (2, ·) mesh is exercised."""
    cid, arch, over, _m, _s = CASES[0]
    cfg = _cfg(arch, over)
    w = _weights(cid, arch, over)
    x = torch.from_numpy(w["x"]).reshape(-1, cfg.d_model)
    _, _, idx = moe._route(x, _port_params(w), cfg.top_k)
    C = moe.expert_capacity(x.shape[0], cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    _, keep = moe.capacity_positions(idx, cfg.n_experts, C)
    assert not bool(keep.all())


def test_lm_forward_with_the_mesh_set_equals_sort():
    """``lm.forward`` reaches moe_ep through moe_block unchanged: with the
    mesh set the logits and aux are the sort dispatch's, bit for bit."""
    cfg = reduced(ARCHS["mixtral-8x7b"])
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    want, aux_want, _ = lm.forward(model, cfg, tokens=toks)
    moe.set_ep_mesh(make_mesh((1, 4), ("data", "model"), ["cpu"] * 4), ("data",))
    try:
        got, aux_got, _ = lm.forward(model, cfg, tokens=toks)
    finally:
        moe.set_ep_mesh(None, ())
    assert torch.equal(got, want) and torch.equal(aux_got, aux_want)


def test_dispatch_rules():
    cfg = dataclasses.replace(reduced(ARCHS["mixtral-8x7b"]), n_experts=3)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 4, cfg.d_model)
    moe.set_ep_mesh(make_mesh((1, 2), ("data", "model"), ["cpu"] * 2), ("data",))
    try:
        with pytest.raises(ValueError, match="neither divides"):
            moe.moe_block(p, x, cfg)
        with pytest.raises(ValueError, match="stationary|neither"):
            moe.set_ep_mesh(make_mesh((1, 2), ("data", "model"), ["cpu"] * 2), (), stationary=True)
            moe.moe_block(p, x, cfg)
    finally:
        moe.set_ep_mesh(None, ())
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.moe_block(p, x, cfg, dispatch="ep")
    y, _ = moe.moe_block(p, x, cfg, dispatch="einsum")
    assert y.shape == x.shape
