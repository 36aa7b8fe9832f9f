"""K4's split of the K means (``kernels/cauchy_mean/ops.py:plan``) and the
order in which ``csrc/cauchy_mean.cu`` sums, emulated in float32 torch,
against the JAX package's oracle.

The card's kernel cannot run here, so the emulation repeats its order:
1 + ‖θ − μ‖² as one ``fmaf`` a coordinate from 1; each of the 32 lanes of
a warp takes the means r ≡ lane (mod 32) of its chunk in ascending order,
one ``fmaf`` chain per head (a fused multiply-add is emulated as one
float64 product and sum rounded to float32); the warp adds its lanes by
the xor butterfly (16, 8, 4, 2, 1); the chunks' partials are added in
ascending order, and the backward scales by −2·ḡ last. The own cell's
term is skipped (emulated as an exact +0). The card's reciprocal (``rcp.approx``,
within 1 ulp) cannot be modelled bit for bit, so the emulation divides,
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
from repro.kernels.cauchy_mean.ref import cauchy_weighted_sum_ref  # noqa: E402
from repro_torch.kernels.cauchy_mean import ops  # noqa: E402

SPEC_SHAPES = [(512, 1024, 2), (100, 64, 2), (64, 100, 3), (777, 333, 2)]  # the JAX spec's (B, K, d)
SERVE_SHAPE = (1024, 4096, 2)  # serve_microbatch heads against PubMed's K means
# serving on a map grown by partial_fit: K' past 4096 gives chunks of 544
# means, each a full 512-mean tile and a 32-mean tail, the last one 325
GROWN_SHAPE = (1024, 4133, 2)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate(th, mu, w, own, gbar=None):
    """s (B,), or with ``gbar`` gθ (B, d), summed in the kernel's order."""
    B, d = th.shape
    K = mu.shape[0]
    chunks, chunk_len = ops.plan(K)
    pad = chunks * chunk_len - K  # past K: weight 0, an exact +0 like a skipped term
    mu_p = torch.cat([mu, torch.zeros(pad, d)])
    w_p = torch.cat([w, torch.zeros(pad)])
    lanes = torch.arange(32)
    starts = torch.arange(chunks)[:, None] * chunk_len
    acc = torch.zeros(B, chunks, 32, d if gbar is not None else 1)
    for j in range(chunk_len // 32):  # a lane's chain, in ascending r
        r = starts + 32 * j + lanes  # (chunks, 32)
        diff = th[:, None, None, :] - mu_p[r][None]  # (B, chunks, 32, d)
        s = torch.ones(diff.shape[:-1])  # 1 + |θ − μ|², one fmaf a coordinate
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        q = 1.0 / s
        wq = torch.where(r[None] == own[:, None, None], torch.zeros(()), w_p[r][None])
        if gbar is None:
            acc[..., 0] = _fma(wq, q, acc[..., 0])
        else:
            f = wq * q * q
            for dd in range(d):
                acc[..., dd] = _fma(f, diff[..., dd], acc[..., dd])
    for o in (16, 8, 4, 2, 1):  # the warp's xor butterfly
        acc = acc + acc[:, :, lanes ^ o]
    total = acc[:, 0, 0]
    for c in range(1, chunks):  # cluster rank 0 adds the chunks in rank order
        total = total + acc[:, c, 0]
    if gbar is None:
        return total[:, 0]
    return (-2.0 * gbar)[:, None] * total


def _inputs(B, K, d, seed):
    """The JAX spec's distribution (``ops.py:_make_inputs``), drawn in numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (B, d)).astype(np.float32), rng.normal(0, 3, (K, d)).astype(np.float32),
            rng.uniform(size=K).astype(np.float32), rng.integers(0, K, B).astype(np.int32),
            rng.uniform(size=B).astype(np.float32))


def test_spec_shapes_are_the_jax_specs():
    sigs = jax_registry.get("cauchy_mean").check_shapes
    assert [(s[0][0][0], s[1][0][0], s[0][0][1]) for s in sigs] == SPEC_SHAPES


@pytest.mark.parametrize("K", [1, 64, 100, 333, 512, 513, 1000, 1024, 4096, 4097, 65536])
def test_plan_covers_K_contiguously(K):
    chunks, chunk_len = ops.plan(K)
    assert 1 <= chunks <= ops.MAX_CLUSTER and chunk_len % 32 == 0
    bounds = [(c * chunk_len, min(K, (c + 1) * chunk_len)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)  # no empty chunk
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # contiguous


@pytest.mark.parametrize("K,want", [(4096, (8, 512)), (1024, (2, 512)), (333, (1, 352)), (100, (1, 128)),
                                    (64, (1, 64)), (65536, (8, 8192)), (4133, (8, 544))])
def test_plan_examples(K, want):
    """512 means a chunk up to the cluster's 8, longer chunks beyond;
    ragged K gives fewer chunks, the last one short."""
    assert ops.plan(K) == want


def test_plan_depends_on_K_alone():
    """The plan takes no B and no card: it fixes the order of every head's
    sum, which must not change with the batch."""
    assert list(inspect.signature(ops.plan).parameters) == ["K"]
    assert all(ops.plan(4096) == (8, 512) for _ in range(3))


@pytest.mark.parametrize("shape", SPEC_SHAPES + [SERVE_SHAPE, GROWN_SHAPE], ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_jax_oracle(shape):
    """Forward against ``cauchy_weighted_sum_ref`` and backward against
    ``jax.grad`` of ḡ·s, both within the spec's (1e-5, 1e-6); at K past
    4096 atol is scaled by the output's largest magnitude, as
    ``chip_smoke.py`` holds the card at K 4096 and beyond."""
    B, K, d = shape
    th, mu, w, own, gbar = _inputs(B, K, d, seed=sum(shape))
    want_s = np.asarray(cauchy_weighted_sum_ref(th, mu, w, own))
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(jnp.asarray(gbar) * cauchy_weighted_sum_ref(t, mu, w, own)))(
        jnp.asarray(th)))
    t = [torch.from_numpy(a) for a in (th, mu, w, own, gbar)]
    for got, want in ((emulate(*t[:4]), want_s), (emulate(*t), want_g)):
        atol = ops.TOL[1] * (float(np.abs(want).max()) if K > 4096 else 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=ops.TOL[0], atol=atol)


def test_emulated_head_is_batch_invariant():
    """The first 512 heads of a 1024-head call and a 512-head call give the
    same bits, forward and backward: the split follows K, not B."""
    th, mu, w, own, gbar = (torch.from_numpy(a) for a in _inputs(*SERVE_SHAPE, seed=11))
    assert torch.equal(emulate(th, mu, w, own)[:512], emulate(th[:512], mu, w, own[:512]))
    assert torch.equal(emulate(th, mu, w, own, gbar)[:512], emulate(th[:512], mu, w, own[:512], gbar[:512]))


def test_emulated_order_is_not_the_plain_order():
    """The split reorders the sum: the emulation differs from the plain
    version's single pass in the last bits, so the tests above see the
    kernel's order and not the plain one's."""
    th, mu, w, own, _ = (torch.from_numpy(a) for a in _inputs(*SERVE_SHAPE, seed=12))
    got, plain = emulate(th, mu, w, own), ops.cauchy_mean_fwd_plain(th, mu, w, own)
    assert not torch.equal(got, plain)
    torch.testing.assert_close(got, plain, rtol=ops.TOL[0], atol=ops.TOL[1])
