"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), on shape-only meshes:

* for all ten ``ARCHS`` on the (16, 16) and (2, 16, 16) production
  shapes, serving on and off: every parameter's spec equals the
  reference's stacked spec without its leading (layer) dims, the port's
  one module a layer standing for the reference's scan-stacked leaves;
* the optimizer state's specs with float32, bfloat16 and int8 moments
  (an int8 payload follows its parameter, its scale drops the last
  entry; where the port keeps a small per-layer leaf's moments float32
  and the stacked reference quantises them, the payload's spec);
* batch and cache specs for every supported shape, and ``step_shardings``
  of every cell;
* ``tests/test_sharding.py``'s divisibility checks on the port's trees;
* ``local_block`` reassembles each global tensor, and ``make_production_mesh``
  has the reference's shapes and axes.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.launch.sharding as ref_sharding  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES  # noqa: E402
from repro.models import lm as ref_lm, steps as ref_steps  # noqa: E402
from repro.optim import AdamW as RefAdamW, constant as ref_constant  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.optim import AdamW, QTensor, constant  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeMesh:
    shape = {"data": 16, "model": 16}


class FakeMeshPod:
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"flat": FakeMesh, "pod": FakeMeshPod}
MOMENTS = ("float32", "bfloat16", "int8")


def _tokens(keystr: str) -> list:
    """``['layers']['attn'].wq`` → ["layers", "attn", "wq"]."""
    return [a or b or c for a, b, c in re.findall(r"\['([^']+)'\]|\.(\w+)|\[(\d+)\]", keystr)]


def _canon(name: str) -> tuple:
    """A port parameter name → (its names without layer indices, how many
    indices: the reference's stacked dims)."""
    parts = name.split(".")
    names = tuple(p for p in parts if not p.isdigit())
    return names, len(parts) - len(names)


def _full(spec, ndim: int) -> tuple:
    entries = tuple(spec)
    assert len(entries) <= ndim, (spec, ndim)
    return entries + (None,) * (ndim - len(entries))


def _unstack(spec, ndim: int, lead: int) -> tuple:
    """The reference's stacked spec without its ``lead`` layer dims (which
    the rules leave unsplit)."""
    entries = _full(spec, ndim)
    assert all(e is None for e in entries[:lead]), (spec, lead)
    return entries[lead:]


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return ref_lm.abstract_params(REF_ARCHS[name])


@functools.lru_cache(maxsize=None)
def _ref_opt_state(name, moment):
    return jax.eval_shape(RefAdamW(schedule=ref_constant(1e-4), moment_dtype=moment).init, _ref_params(name))


def _ref_leaves(tree, specs) -> dict:
    """{token tuple: (spec, ndim)} of a reference tree and its spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return {tuple(_tokens(jax.tree_util.keystr(p))): (s, len(leaf.shape)) for (p, leaf), s in zip(leaves, spec_leaves)}


def _check_params(name, mesh, serving, port_specs=None, ref_specs=None):
    cfg = ARCHS[name]
    params = lm.abstract_params(cfg)
    got = port_specs if port_specs is not None else sharding.param_pspec_tree(cfg, mesh, params, serving=serving)
    ref_tree = _ref_params(name)
    want = _ref_leaves(ref_tree, ref_specs if ref_specs is not None else
                       ref_sharding.param_pspec_tree(REF_ARCHS[name], mesh, ref_tree, serving=serving))
    names = [n for n, _ in params.named_parameters()]
    assert set(got) == set(names)
    seen = set()
    for n, t in params.named_parameters():
        key, lead = _canon(n)
        spec, ndim = want[key]
        assert ndim == t.dim() + lead, (n, ndim, t.dim(), lead)
        assert tuple(got[n]) == _unstack(spec, ndim, lead), (name, n, got[n], spec)
        assert len(got[n]) == t.dim()
        seen.add(key)
    assert seen == set(want), set(want) - seen  # every reference leaf has a port leaf


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_the_reference(name, mesh, serving):
    _check_params(name, MESHES[mesh], serving)


def _check_opt(name, moment, port_state, params, port_specs=None, ref_specs=None, ref_state=None):
    cfg = ARCHS[name]
    got = port_specs if port_specs is not None else sharding.opt_state_pspec_tree(cfg, FakeMesh, port_state, params)
    if ref_state is None:
        ref_state = _ref_opt_state(name, moment)
    want = _ref_leaves(ref_state, ref_specs if ref_specs is not None else
                       ref_sharding.opt_state_pspec_tree(REF_ARCHS[name], FakeMesh, ref_state))
    assert tuple(got["count"]) == tuple(want[("count",)][0]) == ()
    names = [n for n, _ in params.named_parameters()]
    assert len(got["mu"]) == len(names) == len(port_state["mu"])
    for n, specs, mv in zip(names, got["mu"], port_state["mu"]):
        key, lead = _canon(n)
        for k in ("m", "v"):
            if isinstance(mv[k], QTensor):
                for field, t in (("q", mv[k].q), ("scale", mv[k].scale)):
                    spec, ndim = want[("mu",) + key + (k, field)]
                    assert tuple(getattr(specs[k], field)) == _unstack(spec, ndim, lead), (n, k, field)
                    assert len(getattr(specs[k], field)) == t.dim()
            else:
                ref = want.get(("mu",) + key + (k,)) or want[("mu",) + key + (k, "q")]  # stacked: quantised
                assert tuple(specs[k]) == _unstack(*ref, lead), (n, k, specs[k], ref)
                assert len(specs[k]) == mv[k].dim()


@pytest.mark.parametrize("moment", MOMENTS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_opt_state_specs_equal_the_reference(name, moment):
    params = lm.abstract_params(ARCHS[name])
    state = AdamW(schedule=constant(1e-4), moment_dtype=moment).init(list(params.parameters()))
    _check_opt(name, moment, state, params)


def _check_divisibility(tensors: dict, specs: dict, mesh_shape, where):
    for key, t in tensors.items():
        spec = specs[key]
        assert len(spec) <= t.dim(), (where, key, spec, tuple(t.shape))
        for dim, ax in zip(t.shape, spec):
            assert dim % sharding.axis_size(type("M", (), {"shape": mesh_shape}), ax) == 0, (where, key, spec)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_opt_specs_divide_mesh(name):
    """tests/test_sharding.py's check on the port's trees."""
    cfg = ARCHS[name]
    params = lm.abstract_params(cfg)
    named = dict(params.named_parameters())
    _check_divisibility(named, sharding.param_pspec_tree(cfg, FakeMesh, params), FakeMesh.shape, f"{name}/params")
    state = AdamW(schedule=constant(1e-4), moment_dtype=cfg.opt_moment_dtype).init(list(named.values()))
    ospecs = sharding.opt_state_pspec_tree(cfg, FakeMesh, state, params)
    for n, specs, mv in zip(named, ospecs["mu"], state["mu"]):
        for k in ("m", "v"):
            if isinstance(mv[k], QTensor):
                _check_divisibility({"q": mv[k].q, "scale": mv[k].scale}, specs[k]._asdict(), FakeMesh.shape, n)
            else:
                _check_divisibility({k: mv[k]}, specs, FakeMesh.shape, n)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_and_cache_specs_equal_the_reference_and_divide(name, mesh):
    cfg, m = ARCHS[name], MESHES[mesh]
    assert cfg.supported_shapes() == REF_ARCHS[name].supported_shapes()
    for sname in cfg.supported_shapes():
        shape = SHAPES[sname]
        got = sharding.batch_pspecs(cfg, shape, m)
        want = ref_sharding.batch_pspecs(REF_ARCHS[name], REF_SHAPES[sname], m)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, sname
        batch = steps.batch_specs(cfg, shape, with_labels=shape.kind == "train", microbatched=True)
        _check_divisibility(batch, got, m.shape, f"{name}/{sname}/batch")
        if shape.kind == "decode":
            cache = steps.cache_specs(cfg, shape)
            got = sharding.cache_pspecs(cfg, shape, m, cache)
            want = ref_sharding.cache_pspecs(REF_ARCHS[name], REF_SHAPES[sname], m,
                                             ref_steps.cache_specs(REF_ARCHS[name], REF_SHAPES[sname]))
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, sname
            _check_divisibility({k: v for k, v in cache.items() if k != "idx"}, got, m.shape,
                                f"{name}/{sname}/cache")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_step_shardings_equal_the_reference(name, monkeypatch):
    """Every supported cell's (in, out) specs on the flat production shape;
    the reference's NamedSharding is read back as its spec (a shape-only
    mesh has no devices)."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    for sname in cfg.supported_shapes():
        shape, rshape = SHAPES[sname], REF_SHAPES[sname]
        opt = AdamW(schedule=constant(1e-4), moment_dtype=cfg.opt_moment_dtype)
        ropt = RefAdamW(schedule=ref_constant(1e-4), moment_dtype=rcfg.opt_moment_dtype)
        specs = steps.input_specs(cfg, shape, opt)
        rspecs = ref_steps.input_specs(rcfg, rshape, ropt)
        (g_in, g_out), (w_in, w_out) = (sharding.step_shardings(cfg, shape, FakeMesh, specs),
                                        ref_sharding.step_shardings(rcfg, rshape, FakeMesh, rspecs))
        _check_params(name, FakeMesh, None, port_specs=g_in[0], ref_specs=w_in[0])
        if shape.kind == "train":
            _check_opt(name, rcfg.opt_moment_dtype, specs[1], specs[0], port_specs=g_in[1], ref_specs=w_in[1],
                       ref_state=rspecs[1])
            assert {k: tuple(v) for k, v in g_in[2].items()} == {k: tuple(v) for k, v in w_in[2].items()}
            assert g_out[0] is g_in[0] and tuple(g_out[2]) == tuple(w_out[2]) == ()
        elif shape.kind == "prefill":
            assert {k: tuple(v) for k, v in g_in[1].items()} == {k: tuple(v) for k, v in w_in[1].items()}
            assert tuple(g_out[0]) == tuple(w_out[0]) and g_out[1] is None and w_out[1] is None
        else:
            assert {k: tuple(v) for k, v in g_in[1].items()} == {k: tuple(v) for k, v in w_in[1].items()}
            assert tuple(g_in[2]) == tuple(w_in[2]) == ()
            assert tuple(g_out[0]) == tuple(w_out[0]), sname
            assert {k: tuple(v) for k, v in g_out[1].items()} == {k: tuple(v) for k, v in w_out[1].items()}


def test_local_block_reassembles_the_global_tensor():
    mesh = type("M", (), {"shape": {"pod": 2, "data": 2, "model": 4}})
    t = torch.arange(4 * 8 * 6 * 3, dtype=torch.float32).reshape(4, 8, 6, 3)
    for spec in [sharding.P(("pod", "data"), "model", None, None), sharding.P(None, ("data", "model"), "pod"),
                 sharding.P("model", None, ("pod",)), sharding.P()]:
        n = 16
        blocks = [sharding.local_block(t, spec, mesh, i) for i in range(n)]
        assert torch.equal(sharding.assemble(blocks, spec, mesh, t.shape), t)
        # the first-outermost fold: slot (pod 1, data 0, model 2) holds block 2 of ("pod", "data") on dim 0
        if spec and spec[0] == ("pod", "data"):
            assert torch.equal(blocks[1 * 8 + 0 * 4 + 2], t[2:3, 4:6])
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_block(torch.zeros(5, 2), sharding.P("model", None), mesh, 0)


def test_without_drops_an_axis_from_every_entry():
    assert sharding.without(sharding.P("model", "data", None), "data") == ("model", None, None)
    assert sharding.without(sharding.P(("pod", "data"), "model"), "data") == ("pod", "model")
    assert sharding.without(sharding.P(("data",), None), "data") == (None, None)
    assert sharding.without(sharding.P("model", None), None) == ("model", None)


def test_make_production_mesh_shapes_and_axes():
    from repro.launch import mesh as ref_mesh  # noqa: F401 (the reference defines the same two meshes)

    flat = make_production_mesh(devs=["cpu"] * 256)
    pods = make_production_mesh(multi_pod=True, devs=["cpu"] * 512)
    assert flat.shape == {"data": 16, "model": 16} and flat.axis_names == ("data", "model")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16} and pods.axis_names == ("pod", "data", "model")
    assert pods.size == 512 and flat.size == 256
    with pytest.raises(ValueError, match="needs 256 slots"):
        make_production_mesh(devs=["cpu"] * 8)
    # the specs read only mesh.shape: a real mesh gives the shape-only mesh's
    cfg = ARCHS["mixtral-8x7b"]
    params = lm.abstract_params(cfg)
    assert sharding.param_pspec_tree(cfg, flat, params) == sharding.param_pspec_tree(cfg, FakeMesh, params)


def test_expert_parallel_and_resident_rules_match():
    for name in sorted(ARCHS):
        for m in MESHES.values():
            assert sharding._expert_parallel(ARCHS[name], m) == ref_sharding._expert_parallel(REF_ARCHS[name], m)
            assert sharding.serving_weights_resident(ARCHS[name], m) == ref_sharding.serving_weights_resident(
                REF_ARCHS[name], m)
    assert np.all([sharding.P() == (), sharding.P(None) == (None,)])
