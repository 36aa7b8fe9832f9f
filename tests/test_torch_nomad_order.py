"""K1's split of the K means (``kernels/nomad_step/ops.py:plan``), the order
in which ``csrc/nomad_step.cu`` sums, emulated in float32 torch, against the
JAX package's oracle; and the residual ``far`` that lets the backward skip
the means.

The card's kernel cannot run here, so the emulation repeats its order. The
walk over the means (``csrc/cauchy_walk.cuh``): 1 + ‖θ − μ‖² as one
``fmaf`` a coordinate from 1; each of the 32 lanes takes the means
r ≡ lane (mod 32) of its chunk in ascending order, one ``fmaf`` chain a
head for m and one a coordinate for far (a fused multiply-add is emulated
as one float64 product and sum rounded to float32); the warp's xor
butterfly (16, 8, 4, 2, 1); the chunks added in ascending order. The own
cell's term is skipped (emulated as an exact +0). Then a head's S
negatives and k positives: ``ops.LANES`` lanes a head, each a chain over
j ≡ lane (mod LANES), the group's xor butterfly; m is the walk's sum plus
the negatives'. The backward walks only the k + S terms and takes far from
the forward. The card's reciprocal (``rcp.approx``, within 1 ulp) and its
``logf`` cannot be modelled bit for bit, so the emulation divides and takes
torch's logs, and the card is held to the tolerance, not to these bits
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
from repro.kernels.nomad_step.ref import nomad_step_ref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.nomad_step import ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's work here runs at small shapes: one intra-op thread runs
    it faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC_SHAPES = [(512, 15, 16, 64, 2), (100, 5, 4, 33, 2), (64, 3, 8, 100, 3), (777, 15, 16, 130, 2)]
MAIN_SHAPE = (8192, 15, 16, 4096, 2)  # a step of the PubMed fit: batch_size heads against K means
# a refinement step on a map grown by partial_fit: K' past 4096 gives the
# 3-chunk plan (chunks of 1408, the last 1317 means)
GROWN_SHAPE = (1024, 15, 16, 4133, 2)
HEAD_ARGS = (0, 1, 2, 3, 4, 7, 8)  # the inputs of _inputs with one row a head
_REF_GRAD = jax.jit(jax.grad(lambda *a: jnp.sum(a[-1] * nomad_step_ref(*a[:-1])), argnums=(0, 1, 3)))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v, lanes_dim, width):
    """Lane 0's value after the xor butterfly over ``width`` lanes."""
    lanes = torch.arange(width)
    o = width // 2
    while o:
        v = v + v.index_select(lanes_dim, lanes ^ o)
        o //= 2
    return v.select(lanes_dim, 0)


def _walk(th, mu, cw, own):
    """(m over the means (B,), far (B, d)) in the walk's order."""
    B, d = th.shape
    K = mu.shape[0]
    chunks, chunk_len = ops.plan(K)
    pad = chunks * chunk_len - K  # past K: weight 0, an exact +0 like a skipped term
    mu_p = torch.cat([mu, torch.zeros(pad, d)])
    w_p = torch.cat([cw, torch.zeros(pad)])
    lanes = torch.arange(32)
    starts = torch.arange(chunks)[:, None] * chunk_len
    m = torch.zeros(B, chunks, 32)
    far = torch.zeros(B, chunks, 32, d)
    for j in range(chunk_len // 32):  # a lane's chain, in ascending r
        r = starts + 32 * j + lanes  # (chunks, 32)
        diff = th[:, None, None, :] - mu_p[r][None]  # (B, chunks, 32, d)
        s = torch.ones(diff.shape[:-1])  # 1 + |θ − μ|², one fmaf a coordinate
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        q = 1.0 / s
        wq = torch.where(r[None] == own[:, None, None], torch.zeros(()), w_p[r][None])
        m = _fma(wq, q, m)
        f = wq * q * q
        for dd in range(d):
            far[..., dd] = _fma(f, diff[..., dd], far[..., dd])
    m, far = _butterfly(m, 2, 32), _butterfly(far, 2, 32)  # (B, chunks), (B, chunks, d)
    tm, tf = m[:, 0], far[:, 0]
    for c in range(1, chunks):  # cluster rank 0 adds the chunks in rank order
        tm, tf = tm + m[:, c], tf + far[:, c]
    return tm, tf


def _terms(n):
    """(j, valid) of each round of the LANES-lane chains over n terms."""
    sub = torch.arange(ops.LANES)
    for j0 in range(0, n, ops.LANES):
        j = j0 + sub
        yield j.clamp(max=n - 1), j < n


def emulate_fwd(th, pos, pw, neg, nw, mu, cw, own):
    """(loss, m, far) summed in the forward kernel's order."""
    B, d = th.shape
    tm, far = _walk(th, mu, cw, own)
    mn = torch.zeros(B, ops.LANES)
    for j, valid in _terms(neg.shape[1]):
        diff = th[:, None, :] - neg[:, j]
        s = torch.ones(B, ops.LANES)
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        mn = torch.where(valid, _fma(nw[:, j], 1.0 / s, mn), mn)
    m = tm + _butterfly(mn, 1, ops.LANES)
    loss = torch.zeros(B, ops.LANES)
    for j, valid in _terms(pos.shape[1]):
        diff = th[:, None, :] - pos[:, j]
        s = torch.zeros(B, ops.LANES)
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        qp = 1.0 / (1.0 + s)
        loss = torch.where(valid, _fma(pw[:, j], torch.log(qp + m[:, None]) + torch.log1p(s), loss), loss)
    return _butterfly(loss, 1, ops.LANES), m, far


def emulate_bwd(th, pos, pw, neg, nw, m, far, gbar):
    """(g_i, g_pos, g_neg) summed in the backward kernel's order."""
    B, d = th.shape
    gb2 = 2.0 * gbar
    gp = torch.zeros(B, ops.LANES)
    a = torch.zeros(B, ops.LANES, d)
    g_pos, g_neg = torch.empty_like(pos), torch.empty_like(neg)
    for j, valid in _terms(pos.shape[1]):
        diff = th[:, None, :] - pos[:, j]
        s = torch.zeros(B, ops.LANES)
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        qp = 1.0 / (1.0 + s)
        qpm = qp + m[:, None]
        w = pw[:, j]
        gp = torch.where(valid, gp + w / qpm, gp)
        f = w * (qp - qp * qp / qpm)
        for dd in range(d):
            a[..., dd] = torch.where(valid, _fma(f, diff[..., dd], a[..., dd]), a[..., dd])
        g_pos[:, j[valid]] = (((-gb2)[:, None] * f)[..., None] * diff)[:, valid]
    G = _butterfly(gp, 1, ops.LANES)
    for j, valid in _terms(neg.shape[1]):
        diff = th[:, None, :] - neg[:, j]
        s = torch.ones(B, ops.LANES)
        for dd in range(d):
            s = _fma(diff[..., dd], diff[..., dd], s)
        qn = 1.0 / s
        coef = G[:, None] * nw[:, j] * qn * qn
        g_neg[:, j[valid]] = ((gb2[:, None] * coef)[..., None] * diff)[:, valid]
        a = torch.where(valid[:, None], a - coef[..., None] * diff, a)
    a = _butterfly(a, 1, ops.LANES)
    return gb2[:, None] * a - (gb2 * G)[:, None] * far, g_pos, g_neg


def _recompute_bwd(th, pos, pw, neg, nw, mu, cw, own, m, gbar):
    """The backward as it was before far: it walks the means again."""
    K = mu.shape[0]
    g2 = 2.0 * gbar
    diff_p = th[:, None, :] - pos
    qp = 1.0 / (1.0 + torch.sum(torch.square(diff_p), -1))
    qpm = qp + m[:, None]
    G = torch.sum(pw / qpm, -1)
    f = pw * (qp - qp * qp / qpm)
    g_pos = -g2[:, None, None] * f[..., None] * diff_p
    diff_n = th[:, None, :] - neg
    qn = 1.0 / (1.0 + torch.sum(torch.square(diff_n), -1))
    coef = G[:, None] * nw * qn * qn
    g_neg = g2[:, None, None] * coef[..., None] * diff_n
    diff_m = th[:, None, :] - mu[None, :, :]
    q = 1.0 / (1.0 + torch.sum(torch.square(diff_m), -1))
    mask = own[:, None] != torch.arange(K, dtype=own.dtype)[None, :]
    fm = cw[None, :] * mask * q * q
    near = torch.sum(f[..., None] * diff_p, 1) - torch.sum(coef[..., None] * diff_n, 1)
    far = torch.sum(fm[..., None] * diff_m, 1)
    return g2[:, None] * near - (g2 * G)[:, None] * far, g_pos, g_neg


def _inputs(B, k, S, K, d, seed):
    """The JAX spec's distribution (``ops.py:_make_inputs``), drawn in numpy;
    ḡ = 1/B, the batch mean's cotangent, as on the main path."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(rng.normal(0, 3, (B, d))), f32(rng.normal(0, 3, (B, k, d))), f32(rng.uniform(size=(B, k))),
            f32(rng.normal(0, 3, (B, S, d))), f32(rng.uniform(size=(B, S))), f32(rng.normal(0, 3, (K, d))),
            f32(rng.uniform(size=K)), rng.integers(0, K, B).astype(np.int32), np.full(B, 1.0 / B, np.float32))


def _oracle(args, slice_heads=1024):
    """loss and jax.grad of Σ ḡ·loss (θ_i, θ_pos, θ_neg) from the JAX oracle,
    in slices of heads (each head's terms are its own, so this is exact)."""
    B = args[0].shape[0]
    out = []
    for lo in range(0, B, slice_heads):
        part = [a[lo:lo + slice_heads] if i in HEAD_ARGS else a for i, a in enumerate(args)]
        out.append((np.asarray(nomad_step_ref(*part[:-1])), *map(np.asarray, _REF_GRAD(*part))))
    return [np.concatenate(o) for o in zip(*out)]


def _assert_close(got, want, scaled, label):
    atol = ops.TOL[1] * (float(np.abs(want).max()) if scaled else 1.0)
    np.testing.assert_allclose(got, want, rtol=ops.TOL[0], atol=atol, err_msg=label)


def test_spec_shapes_are_the_jax_specs():
    sigs = jax_registry.get("nomad_step").check_shapes
    assert [(s[0][0][0], s[1][0][1], s[3][0][1], s[5][0][0], s[0][0][1]) for s in sigs] == SPEC_SHAPES


@pytest.mark.parametrize("K", [1, 33, 64, 100, 130, 2048, 2049, 4096, 5000, 16384, 65536])
def test_plan_covers_K_contiguously(K):
    chunks, chunk_len = ops.plan(K)
    assert 1 <= chunks <= 8 and chunk_len % 32 == 0
    bounds = [(c * chunk_len, min(K, (c + 1) * chunk_len)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)  # no empty chunk
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # contiguous


@pytest.mark.parametrize("K,want", [(4096, (2, 2048)), (130, (1, 160)), (33, (1, 64)), (2049, (2, 1056)),
                                    (65536, (8, 8192)), (4133, (3, 1408))])
def test_plan_examples(K, want):
    """CHUNK means a block up to the cluster's 8, longer chunks beyond;
    ragged K gives a short last chunk."""
    assert ops.plan(K) == want


def test_plan_depends_on_K_alone():
    """The plan takes no B and no card: it fixes the order of every head's
    sum, which must not change with the batch."""
    assert list(inspect.signature(ops.plan).parameters) == ["K"]
    assert all(ops.plan(4096) == (2, 2048) for _ in range(3))


@pytest.mark.parametrize("shape", SPEC_SHAPES + [MAIN_SHAPE, GROWN_SHAPE], ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_jax_oracle(shape):
    """The forward's loss against ``nomad_step_ref`` and the backward
    (residuals m and far from the emulated forward) against ``jax.grad``,
    within the spec's (2e-5, 2e-5); at the main shape and at K' 4133 atol
    is scaled by the output's largest magnitude, as ``chip_smoke.py`` holds
    the card there (a sum over K ≥ 4096 signed terms rounds with the summed
    magnitudes, not with the cancelled result)."""
    args = _inputs(*shape, seed=sum(shape))
    want = _oracle(args)
    t = [torch.from_numpy(a) for a in args]
    loss, m, far = emulate_fwd(*t[:8])
    grads = emulate_bwd(*t[:5], m, far, t[8])
    scaled = shape in (MAIN_SHAPE, GROWN_SHAPE)
    for got, w, label in zip((loss, *grads), want, ("loss", "g_i", "g_pos", "g_neg")):
        _assert_close(got.numpy(), w, scaled, label)


def test_emulated_head_is_batch_invariant():
    """The first 512 heads of a 1024-head call and a 512-head call give the
    same bits, forward and backward: the split follows K, not B."""
    t = [torch.from_numpy(a) for a in _inputs(1024, 15, 16, 4096, 2, seed=11)]
    half = [a[:512] if i in HEAD_ARGS else a for i, a in enumerate(t)]
    full_f, half_f = emulate_fwd(*t[:8]), emulate_fwd(*half[:8])
    assert all(torch.equal(a[:512], b) for a, b in zip(full_f, half_f))
    full_b = emulate_bwd(*t[:5], *full_f[1:], t[8])
    half_b = emulate_bwd(*half[:5], *half_f[1:], half[8])
    assert all(torch.equal(a[:512], b) for a, b in zip(full_b, half_b))


def test_emulated_order_is_not_the_plain_order():
    """The split reorders the sum: the emulated m and far differ from the
    plain version's in the last bits, so the tests above see the kernel's
    order and not the plain one's."""
    t = [torch.from_numpy(a) for a in _inputs(1024, 15, 16, 4096, 2, seed=12)]
    _, m, far = emulate_fwd(*t[:8])
    _, m_p, far_p = ops.nomad_step_fwd_plain(*t[:8], want_far=True)
    assert not torch.equal(m, m_p) and not torch.equal(far, far_p)
    torch.testing.assert_close(m, m_p, rtol=ops.TOL[0], atol=ops.TOL[1])


@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_far_gives_the_recompute_gradients(shape):
    """The plain forward's far, handed to the plain backward, gives the
    gradients of the backward that walked the means again, bit for bit."""
    t = [torch.from_numpy(a) for a in _inputs(*shape, seed=sum(shape) + 1)]
    _, m, far = ops.nomad_step_fwd_plain(*t[:8], want_far=True)
    got = ops.nomad_step_bwd_plain(*t[:5], m, far, t[8])
    for g, w in zip(got, _recompute_bwd(*t[:8], m, t[8])):
        assert torch.equal(g, w)


def _spy_fwd(monkeypatch):
    kernel = registry.get("nomad_step_fwd")
    plain, asked = kernel.plain, []

    def spy(*args, **options):
        asked.append(options["want_far"])
        return plain(*args, **options)

    monkeypatch.setattr(kernel, "plain", spy)
    return asked


def test_nomad_step_sums_far_only_for_a_theta_i_gradient(monkeypatch):
    """``NomadStep`` asks the forward for far when θ_i's gradient can be
    asked for, and not under ``torch.no_grad`` or for a θ_i that needs no
    gradient; without far the gradients to θ_pos and θ_neg are the same
    bits and θ_i gets none."""
    asked = _spy_fwd(monkeypatch)
    t = [torch.from_numpy(a) for a in _inputs(100, 5, 4, 33, 2, seed=3)][:8]
    with torch.no_grad():
        ops.nomad_step_fused(t[0].requires_grad_(), *t[1:])
    diff = [t[i].clone().requires_grad_() for i in (0, 1, 3)]
    ops.nomad_step_fused(diff[0], diff[1], t[2], diff[2], *t[4:]).sum().backward()
    th = t[0].detach()
    part = [t[i].clone().requires_grad_() for i in (1, 3)]
    ops.nomad_step_fused(th, part[0], t[2], part[1], *t[4:]).sum().backward()
    assert asked == [False, True, False]
    assert th.grad is None
    assert torch.equal(part[0].grad, diff[1].grad) and torch.equal(part[1].grad, diff[2].grad)
