"""The port's kernels (plain PyTorch versions, the CPU path) against the JAX
package's oracles, at every check shape of the JAX specs.

Inputs are drawn with numpy from a seed, like the JAX spec's own
``make_inputs``, rounded to each dtype of the spec's grid (bf16 reaches the
port as its exact fp32 value, as the JAX ops cast it), and reach both
frameworks as the same values. Each kernel is also held against its
Pallas kernel in interpret mode at one small shape, and each
``autograd.Function`` (nomad_step, cauchy_mean, frozen_attract) against
``jax.grad`` of the JAX oracle.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.cauchy_mean.ref import cauchy_weighted_sum_ref  # noqa: E402
from repro.kernels.frozen_attract.ref import frozen_attract_ref  # noqa: E402
from repro.kernels.nomad_step.ref import nomad_step_ref  # noqa: E402
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels.cauchy_mean import ops as cauchy_ops  # noqa: E402
from repro_torch.kernels.frozen_attract import ops as attract_ops  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops  # noqa: E402
from repro_torch.kernels.nomad_step import ops as nomad_ops  # noqa: E402
from repro_torch.kernels.pairwise import ops as pairwise_ops  # noqa: E402


def _make(name, sig, seed):
    """numpy inputs for a JAX spec signature, drawn like the spec's own
    ``make_inputs`` (normals, uniform weights, cell ids in [0, K))."""
    rng = np.random.default_rng(seed)
    if name == "nomad_step":
        (ts, _), (ps, _), (ws, _), (ns, _), (nws, _), (ms, _), (cs, _), (os_, _) = sig
        return [rng.normal(0, 3, ts), rng.normal(0, 3, ps), rng.uniform(size=ws),
                rng.normal(0, 3, ns), rng.uniform(size=nws), rng.normal(0, 3, ms),
                rng.uniform(size=cs), rng.integers(0, ms[0], os_).astype(np.int32)]
    if name == "cauchy_mean":
        (ts, _), (ms, _), (ws, _), (os_, _) = sig
        return [rng.normal(0, 3, ts), rng.normal(0, 3, ms), rng.uniform(size=ws),
                rng.integers(0, ms[0], os_).astype(np.int32)]
    if name == "frozen_attract":
        (ts, _), (ns, _), (ws, _), (ms, _) = sig
        return [rng.normal(0, 3, ts), rng.normal(0, 3, ns), rng.uniform(size=ws),
                rng.uniform(size=ms) * 5.0]
    return [rng.normal(size=shape) for shape, _ in sig]


def _inputs(name, shape_idx, dtype):
    """(JAX args, the same values as CPU torch tensors). Floats are drawn in
    float64, rounded to ``dtype`` (the spec's dtype grid), and reach torch as
    the exact fp32 values of that rounding, as the JAX ops cast them."""
    spec = jax_registry.get(name)
    host = _make(name, spec.check_shapes[shape_idx], shape_idx)
    wire = [a.astype(getattr(jnp, dtype)) if a.dtype == np.float64 else a for a in host]
    return (
        [jnp.asarray(a) for a in wire],
        [torch.from_numpy(np.array(a, np.float32 if a.dtype != np.int32 else np.int32)) for a in wire],
    )


_REF = {n: jax.jit(jax_registry.get(n).ref)
        for n in ("pairwise", "kmeans_assign", "nomad_step", "cauchy_mean", "frozen_attract")}
_REF_GRAD = jax.jit(jax.grad(lambda *a: jnp.mean(nomad_step_ref(*a)), argnums=(0, 1, 3)))
# the serving kernels' differentiable inputs: θ for cauchy_mean, θ and m
# for frozen_attract
_SERVE_GRAD = {
    "cauchy_mean": (jax.jit(jax.grad(lambda *a: jnp.mean(cauchy_weighted_sum_ref(*a)))), (0,)),
    "frozen_attract": (jax.jit(jax.grad(lambda *a: jnp.mean(frozen_attract_ref(*a)), argnums=(0, 3))), (0, 3)),
}
_SERVE_OP = {"cauchy_mean": cauchy_ops, "frozen_attract": attract_ops}


def _grid(name):
    spec = jax_registry.get(name)
    return [
        pytest.param(i, dt, id=f"shape{i}-{dt}")
        for i in range(len(spec.check_shapes))
        for dt in spec.dtype_grid
    ]


@pytest.mark.parametrize("shape_idx,dtype", _grid("pairwise"))
def test_pairwise_plain_matches_jax_oracle(shape_idx, dtype):
    args, (x, y) = _inputs("pairwise", shape_idx, dtype)
    want = np.asarray(_REF["pairwise"](*args))
    got = pairwise_ops.pairwise_dist2(x, y).numpy()
    np.testing.assert_allclose(got, want, *pairwise_ops.SPEC_TOL)


@pytest.mark.parametrize("shape_idx,dtype", _grid("kmeans_assign"))
def test_kmeans_assign_plain_matches_jax_oracle(shape_idx, dtype):
    args, (x, c) = _inputs("kmeans_assign", shape_idx, dtype)
    want = _REF["kmeans_assign"](*args)
    got = kmeans_ops.assign_nearest(x, c)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    kmeans_ops.oracle_check(x, c, got, want)


@pytest.mark.parametrize("shape_idx,dtype", _grid("nomad_step"))
def test_nomad_step_plain_matches_jax_oracle(shape_idx, dtype):
    args, targs = _inputs("nomad_step", shape_idx, dtype)
    want = np.asarray(_REF["nomad_step"](*args))
    got = nomad_ops.nomad_step_fused(*targs).numpy()
    np.testing.assert_allclose(got, want, *nomad_ops.TOL)


@pytest.mark.parametrize(
    "shape_idx", range(len(jax_registry.get("nomad_step").check_shapes))
)
def test_nomad_step_grads_match_jax_grad(shape_idx):
    """The port's autograd.Function (plain forward and backward on CPU)
    against jax.grad of the JAX oracle's batch mean, for θ_i, θ_pos, θ_neg."""
    args, targs = _inputs("nomad_step", shape_idx, "float32")
    want = _REF_GRAD(*args)
    diff = [targs[i].clone().requires_grad_() for i in (0, 1, 3)]
    full = list(targs)
    full[0], full[1], full[3] = diff
    nomad_ops.nomad_step_fused(*full).mean().backward()
    for t, w, label in zip(diff, want, ("g_i", "g_pos", "g_neg")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), *nomad_ops.TOL, err_msg=label)


def test_nomad_step_no_grad_to_frozen_inputs():
    """pw, nw, μ and cw get no gradient, as the JAX VJP returns None."""
    _args, targs = _inputs("nomad_step", 1, "float32")
    frozen = [targs[i].clone().requires_grad_() for i in (2, 4, 5, 6)]
    full = list(targs)
    for i, t in zip((2, 4, 5, 6), frozen):
        full[i] = t
    th = targs[0].clone().requires_grad_()
    full[0] = th
    nomad_ops.nomad_step_fused(*full).sum().backward()
    assert th.grad is not None
    assert all(t.grad is None for t in frozen)


def _serve_apply(name, targs):
    op = cauchy_ops.cauchy_weighted_sum if name == "cauchy_mean" else attract_ops.frozen_attract
    return op(*targs)


@pytest.mark.parametrize(
    "name,shape_idx,dtype",
    [pytest.param(n, i, dt, id=f"{n}-shape{i}-{dt}")
     for n in ("cauchy_mean", "frozen_attract")
     for i, dt in ((p.values[0], p.values[1]) for p in _grid(n))],
)
def test_serve_kernel_plain_matches_jax_oracle(name, shape_idx, dtype):
    """K4 (``cauchy_weighted_sum``) and K5 (``frozen_attract``) forward,
    at every check shape and dtype of the JAX spec."""
    args, targs = _inputs(name, shape_idx, dtype)
    want = np.asarray(_REF[name](*args))
    got = _serve_apply(name, targs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, *_SERVE_OP[name].TOL)


@pytest.mark.parametrize(
    "name,shape_idx,dtype",
    [pytest.param(n, i, dt, id=f"{n}-shape{i}-{dt}")
     for n in ("cauchy_mean", "frozen_attract")
     for i, dt in ((p.values[0], p.values[1]) for p in _grid(n))],
)
def test_serve_kernel_grads_match_jax_grad(name, shape_idx, dtype):
    """The K4/K5 autograd.Functions (plain backward on the CPU) against
    jax.grad of the JAX oracle's batch mean, for every differentiable input.
    Both sides differentiate in fp32 at the dtype-rounded values (the port
    casts to fp32 as the JAX ops do; jax.grad at a bf16 input would round
    the cotangent itself to bf16)."""
    args, targs = _inputs(name, shape_idx, dtype)
    grad_fn, argnums = _SERVE_GRAD[name]
    want = grad_fn(*[a.astype(jnp.float32) if a.dtype != jnp.int32 else a for a in args])
    want = want if isinstance(want, tuple) else (want,)
    full = list(targs)
    diff = [full[i].clone().requires_grad_() for i in argnums]
    for i, t in zip(argnums, diff):
        full[i] = t
    _serve_apply(name, full).mean().backward()
    for t, w, i in zip(diff, want, argnums):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), *_SERVE_OP[name].TOL, err_msg=f"arg {i}")


@pytest.mark.parametrize("name", ["cauchy_mean", "frozen_attract"])
def test_serve_kernel_no_grad_to_frozen_inputs(name):
    """The means, weights, cell ids and neighbours get no gradient, as the
    JAX VJPs return None: serving cannot move the map."""
    _args, targs = _inputs(name, 1, "float32")
    full = [t.clone().requires_grad_() if t.is_floating_point() else t for t in targs]
    _serve_apply(name, full).sum().backward()
    assert full[0].grad is not None
    assert full[1].grad is None and full[2].grad is None  # μ, w or nbrs, w


@pytest.mark.parametrize("name", ["cauchy_mean", "frozen_attract"])
def test_serve_kernel_grads_match_pallas_interpret(name):
    """The backward of the JAX package's Pallas kernel (interpret mode,
    through its custom VJP) against the port's plain backward, at one
    small ragged shape."""
    spec = jax_registry.get(name)
    args, targs = _inputs(name, 1, "float32")
    _grad_fn, argnums = _SERVE_GRAD[name]
    tiles = spec.tiles_for_backend("cpu")
    want = jax.grad(lambda *a: jnp.mean(spec.pallas(*a, tiles=tiles, interpret=True)), argnums=argnums)(*args)
    full = list(targs)
    diff = [full[i].clone().requires_grad_() for i in argnums]
    for i, t in zip(argnums, diff):
        full[i] = t
    _serve_apply(name, full).mean().backward()
    for t, w in zip(diff, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), *spec.tol)


@pytest.mark.parametrize(
    "name,shape_idx",
    [("pairwise", 1), ("kmeans_assign", 1), ("nomad_step", 1), ("cauchy_mean", 1), ("frozen_attract", 1)],
)
def test_plain_matches_pallas_interpret(name, shape_idx):
    """The JAX package's Pallas kernel, run in interpret mode, against the
    port's plain version at one small ragged shape."""
    spec = jax_registry.get(name)
    args, targs = _inputs(name, shape_idx, "float32")
    got_pallas = spec.pallas(*args, tiles=spec.tiles_for_backend("cpu"), interpret=True)
    if name == "kmeans_assign":
        kmeans_ops.oracle_check(targs[0], targs[1], kmeans_ops.assign_nearest(*targs), got_pallas)
        return
    port = registry.dispatch(name if name in ("pairwise", "kmeans_assign") else f"{name}_fwd", *targs)
    port = port[0] if name == "nomad_step" else port
    np.testing.assert_allclose(port.numpy(), np.asarray(got_pallas), *spec.tol)


def test_registry_dispatches_by_device_only():
    """CPU tensors take the plain version; a wrapper given CPU tensors
    raises instead of launching; every kernel names its TPU original."""
    x = torch.randn(5, 3)
    assert torch.equal(registry.dispatch("pairwise", x, x), pairwise_ops.pairwise_dist2_plain(x, x))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pairwise_ops.pairwise_dist2_cuda(x, x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kmeans_ops.assign_nearest_cuda(x, x)
    before = registry.launch_counts()
    registry.dispatch("kmeans_assign", x, x)
    assert registry.launch_counts() == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cauchy_ops.cauchy_mean_fwd_cuda(x[:, :2], x[:, :2], x[:, 0], torch.zeros(5, dtype=torch.int32))
    assert set(registry.names()) == {
        "pairwise", "kmeans_assign", "nomad_step_fwd", "nomad_step_bwd",
        "cauchy_mean_fwd", "cauchy_mean_bwd", "frozen_attract_fwd", "frozen_attract_bwd",
    }
    for n in registry.names():
        k = registry.get(n)
        assert k.replaces.startswith("src/repro/kernels/") and k.source.startswith("src/repro_torch/csrc/")


def test_pairwise_batched_equals_per_cell():
    """The leading batch dimension (in place of the JAX vmap) equals one
    call per cell."""
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(0))
    got = pairwise_ops.pairwise_dist2(x, x)
    for b in range(3):
        torch.testing.assert_close(got[b], pairwise_ops.pairwise_dist2(x[b], x[b]), rtol=pairwise_ops.SPEC_TOL[0], atol=pairwise_ops.SPEC_TOL[1])


@pytest.mark.parametrize("source", _build.SOURCES)
def test_c_entries_take_what_the_loader_declares(source):
    """Each ``extern "C"`` entry of ``csrc/<source>.cu`` takes the pointers
    and ints, in the order, that ``_build.SIGNATURES`` hands ctypes: a
    wrong count would pass garbage to the card unnoticed here."""
    import ctypes
    import re

    text = (_build.CSRC / f"{source}.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
    assert set(entries) == set(_build.SIGNATURES[source])
    for fn, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
        assert kinds == _build.SIGNATURES[source][fn], fn
