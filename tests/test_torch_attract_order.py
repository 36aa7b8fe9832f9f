"""K5's lanes a query (``kernels/frozen_attract/ops.py:plan``) and the order
in which ``csrc/frozen_attract.cu`` sums, emulated in float32 torch,
against the JAX package's oracle.

The card's kernel cannot run here, so the emulation repeats its order:
‖θ − nb‖² as one ``fmaf`` a coordinate from 0; ``plan(k)`` lanes a query,
lane j taking the neighbours s ≡ j (mod lanes) in ascending order, one
``fmaf`` chain a lane (a fused multiply-add is emulated as one float64
product and sum rounded to float32; a lane past k adds nothing); the
group's xor butterfly (lanes/2, …, 1). The forward sums
w·(log(q + m) + log1p(d²)); the backward takes r = 1/(q + m) once and sums
w·fmaf(−q², r, q)·(θ − nb) and w·r, then scales by 2·ḡ and ḡ. The card's
reciprocal (``rcp.approx``, within 1 ulp), ``logf`` and ``log1pf`` cannot
be modelled bit for bit, so the emulation divides and takes torch's logs,
and the card is held to the spec's tolerance, not to these bits
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.frozen_attract.ref import frozen_attract_ref, frozen_attract_vjp_ref  # noqa: E402
from repro_torch.kernels.frozen_attract import ops  # noqa: E402

SPEC_SHAPES = [(512, 15, 2), (64, 8, 2), (100, 5, 3), (777, 15, 2)]  # the JAX spec's (B, k, d)
SHAPES = SPEC_SHAPES + [(1024, 15, 2), (32, 1, 2), (64, 40, 4)]  # + serving's, k = 1, k > 32
_REF_GRAD = jax.jit(jax.grad(lambda th, nb, w, m, gbar: jnp.sum(gbar * frozen_attract_ref(th, nb, w, m)),
                             argnums=(0, 3)))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate(th, nb, w, m, gbar=None):
    """loss (B,), or with ``gbar`` (gθ (B, d), gm (B,)), summed in the
    kernel's order."""
    B, k, d = nb.shape
    lanes = ops.plan(k)
    lane = torch.arange(lanes)
    acc = torch.zeros(B, lanes, 1 if gbar is None else d + 1)
    for first in range(0, k, lanes):  # one pass of every lane's chain
        s = first + lane
        live = (s < k)[None, :, None]
        s = s.clamp(max=k - 1)
        diff = th[:, None, :] - nb[:, s]  # (B, lanes, d)
        d2 = torch.zeros(B, lanes)
        for dd in range(d):
            d2 = _fma(diff[..., dd], diff[..., dd], d2)
        q = 1.0 / (1.0 + d2)
        ws = w[:, s]
        if gbar is None:
            new = _fma(ws, torch.log(q + m[:, None]) + torch.log1p(d2), acc[..., 0])[..., None]
        else:
            r = 1.0 / (q + m[:, None])
            f = ws * _fma(-(q * q), r, q)
            new = torch.stack([_fma(f, diff[..., dd], acc[..., dd]) for dd in range(d)]
                              + [_fma(ws, r, acc[..., d])], -1)
        acc = torch.where(live, new, acc)
    o = lanes // 2
    while o:  # the group's xor butterfly
        acc = acc + acc[:, lane ^ o]
        o //= 2
    total = acc[:, 0]
    if gbar is None:
        return total[:, 0]
    return (2.0 * gbar)[:, None] * total[:, :d], gbar * total[:, d]


def _inputs(B, k, d, seed):
    """The JAX spec's distribution (``ops.py:_make_inputs``), drawn in numpy,
    with ḡ uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (B, d)).astype(np.float32), rng.normal(0, 3, (B, k, d)).astype(np.float32),
            rng.uniform(size=(B, k)).astype(np.float32), (5 * rng.uniform(size=B)).astype(np.float32),
            rng.uniform(size=B).astype(np.float32))


def test_spec_shapes_are_the_jax_specs():
    sigs = jax_registry.get("frozen_attract").check_shapes
    assert [(s[1][0][0], s[1][0][1], s[1][0][2]) for s in sigs] == SPEC_SHAPES


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (5, 8), (8, 8), (15, 16), (16, 16), (17, 32), (32, 32),
                                    (33, 32), (40, 32)])
def test_plan_examples(k, want):
    """The least power of two ≥ k, at most a warp: 16 lanes at serving's
    k = 15, so 1024 queries fill 64 blocks of 256 threads."""
    assert ops.plan(k) == want


def test_plan_depends_on_k_alone():
    """The plan takes no B and no card: it fixes the order of every
    query's sums, which must not change with the batch."""
    assert list(inspect.signature(ops.plan).parameters) == ["k"]
    assert all(ops.plan(15) == 16 for _ in range(3))
    with pytest.raises(ValueError):
        ops.plan(0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_jax_oracle(shape):
    """Forward against ``frozen_attract_ref``, backward against
    ``frozen_attract_vjp_ref`` and ``jax.grad`` of Σ ḡ·loss, all within
    the spec's (1e-5, 1e-6)."""
    th, nb, w, m, gbar = _inputs(*shape, seed=sum(shape))
    t = [torch.from_numpy(a) for a in (th, nb, w, m, gbar)]
    got_gt, got_gm = emulate(*t)
    np.testing.assert_allclose(emulate(*t[:4]).numpy(), np.asarray(frozen_attract_ref(th, nb, w, m)), *ops.TOL)
    for want_gt, want_gm in (frozen_attract_vjp_ref(th, nb, w, m, gbar), _REF_GRAD(th, nb, w, m, gbar)):
        np.testing.assert_allclose(got_gt.numpy(), np.asarray(want_gt), *ops.TOL)
        np.testing.assert_allclose(got_gm.numpy(), np.asarray(want_gm), *ops.TOL)


def test_emulated_rows_are_batch_invariant():
    """The first 512 queries of a 1024-query call and a 512-query call give
    the same bits, forward and backward: the lanes follow k, not B."""
    th, nb, w, m, gbar = (torch.from_numpy(a) for a in _inputs(1024, 15, 2, seed=11))
    half = (th[:512], nb[:512], w[:512], m[:512])
    assert torch.equal(emulate(th, nb, w, m)[:512], emulate(*half))
    for full, part in zip(emulate(th, nb, w, m, gbar), emulate(*half, gbar[:512])):
        assert torch.equal(full[:512], part)


def test_emulated_order_is_not_the_plain_order():
    """The lanes reorder the sum: the emulation differs from the plain
    version's in the last bits, so the tests above see the kernel's order
    and not the plain one's."""
    th, nb, w, m, gbar = (torch.from_numpy(a) for a in _inputs(1024, 15, 2, seed=12))
    got, plain = emulate(th, nb, w, m), ops.frozen_attract_fwd_plain(th, nb, w, m)
    assert not torch.equal(got, plain)
    torch.testing.assert_close(got, plain, rtol=ops.TOL[0], atol=ops.TOL[1])
    got_gt, _ = emulate(th, nb, w, m, gbar)
    plain_gt, _ = ops.frozen_attract_bwd_plain(th, nb, w, m, gbar)
    assert not torch.equal(got_gt, plain_gt)
    torch.testing.assert_close(got_gt, plain_gt, rtol=ops.TOL[0], atol=ops.TOL[1])
