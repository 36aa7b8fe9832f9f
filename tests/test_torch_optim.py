"""The port's optimisers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the CPU, from identical numpy parameters and
gradients: the int8 quantiser bit for bit, AdamW with float32, bfloat16 and
int8 moments over five steps (weights and moments), ``QUANT_MIN_SIZE``,
SGD's in-place ``update_`` with and without momentum, and AdamW's in-place
``update_`` against its functional ``update``.

Tolerances: the quantiser's payloads and scales are bit-equal (round half
to even and a correctly rounded float32 division and square root on both
sides). An update agrees to ``rtol = 1e-6`` (plus 1e-7 absolute): the two
frameworks evaluate ``(m / bc1) / (sqrt(v / bc2) + eps)`` with the same
float32 operations but round an intermediate differently in a few places
(measured ≤ 2.4e-7 absolute on weights of magnitude ~1). Stored moments
are equal: a bfloat16 moment rounds the same float32 value, an int8 one
quantises it.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import SGD as JaxSGD  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.optim.quantized import QTensor as JaxQTensor  # noqa: E402
from repro.optim.quantized import dequantize_int8 as jax_dequantize  # noqa: E402
from repro.optim.quantized import quantize_int8 as jax_quantize  # noqa: E402
from repro_torch.optim import SGD, AdamW, QTensor, constant, dequantize_int8, quantize_int8, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import QUANT_MIN_SIZE  # noqa: E402

UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)
# the moments' shapes: a matrix and a vector above QUANT_MIN_SIZE, a
# matrix and a vector below it (they keep float32 moments under "int8")
SHAPES = [(512, 160), (70_000,), (64, 32), (16,)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_close(got: torch.Tensor, want) -> None:
    """bf16 weights updated in float32 within ``UPDATE_TOL`` of each other:
    a value near a rounding boundary may land on the neighbouring bf16
    value, one bf16 ulp (2^-8 relative, 2^-7 bounds it) on a few elements."""
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all() and (got != want).mean() < 1e-3


def _same_q(ours: QTensor, theirs: JaxQTensor) -> None:
    assert ours.q.dtype == torch.int8 and ours.sqrt_scaled == theirs.sqrt_scaled
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(theirs.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs.scale))


# ---------------------------------------------------------------------------
# The quantiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sqrt_scaled", [False, True])
@pytest.mark.parametrize("shape", [(64,), (7, 33), (3, 5, 17), (300,), (512, 256)])
def test_quantize_int8_bit_equal_to_jax(shape, sqrt_scaled):
    """``tests/test_optim.py``'s shapes (and the int8 moments' 512 × 256):
    payload, scales and the dequantised values equal JAX's bit for bit."""
    x = np.random.default_rng(len(shape) * 1000 + shape[-1]).normal(size=shape).astype(np.float32) * 3
    if sqrt_scaled:
        x = np.abs(x) * 5
    ours, theirs = quantize_int8(torch.from_numpy(x), sqrt_scaled=sqrt_scaled), jax_quantize(
        jnp.asarray(x), sqrt_scaled=sqrt_scaled)
    _same_q(ours, theirs)
    assert ours.scale.shape == x.shape[:-1]
    np.testing.assert_array_equal(dequantize_int8(ours).numpy(), np.asarray(jax_dequantize(theirs)))


def test_quantize_int8_zero_rows_and_bounds():
    """An all-zero row takes the 1e-12 floor and dequantises to 0; the
    payload stays within ±127 and the error within a row's scale / 2."""
    x = np.random.default_rng(1).normal(size=(5, 40)).astype(np.float32)
    x[2] = 0.0
    q = quantize_int8(torch.from_numpy(x))
    _same_q(q, jax_quantize(jnp.asarray(x)))
    assert float(q.scale[2]) == np.float32(1e-12) and not q.q[2].any()
    assert int(q.q.abs().max()) == 127
    err = (dequantize_int8(q) - torch.from_numpy(x)).abs()
    assert bool((err <= q.scale[:, None] / 2 * (1 + 1e-6)).all())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _problem(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_moments_match_jax(moment_dtype):
    """Five updates under warmup_cosine from the same params and grads:
    weights within ``UPDATE_TOL``, moments stored alike (float32 equal,
    bfloat16 bit-equal, int8 payloads and scales bit-equal above
    ``QUANT_MIN_SIZE`` and float32 below it)."""
    params, grads = _problem()
    kw = dict(weight_decay=1e-2, moment_dtype=moment_dtype)
    opt, jopt = AdamW(schedule=warmup_cosine(3e-2, 2, 5), **kw), JaxAdamW(schedule=jax_warmup_cosine(3e-2, 2, 5), **kw)
    p, jp = [torch.from_numpy(a) for a in params], [jnp.asarray(a) for a in params]
    st, jst = opt.init(p), jopt.init(jp)
    for g in grads:
        p, st = opt.update(p, [torch.from_numpy(a) for a in g], st)
        jp, jst = jopt.update(jp, [jnp.asarray(a) for a in g], jst)
        for a, b in zip(p, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **UPDATE_TOL)
    assert st["count"] == int(jst["count"]) == len(grads)
    for shape, mv, jmv in zip(SHAPES, st["mu"], jst["mu"]):
        quantized = moment_dtype == "int8" and int(np.prod(shape)) >= QUANT_MIN_SIZE
        assert isinstance(mv["m"], QTensor) == isinstance(jmv["m"], JaxQTensor) == quantized
        for k in ("m", "v"):
            if quantized:
                _same_q(mv[k], jmv[k])
                assert mv[k].sqrt_scaled == (k == "v")
            else:
                want = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.float32}[moment_dtype]
                assert mv[k].dtype == want
                np.testing.assert_array_equal(mv[k].float().numpy(), np.asarray(jmv[k]).astype(np.float32))


def test_adamw_quant_min_size_boundary():
    """Under "int8" a leaf of exactly ``QUANT_MIN_SIZE`` elements is
    quantised and one of ``QUANT_MIN_SIZE - 1`` keeps float32 moments, as
    in the reference."""
    opt = AdamW(schedule=constant(1e-3), moment_dtype="int8")
    jopt = JaxAdamW(schedule=jax_constant(1e-3), moment_dtype="int8")
    shapes = [(QUANT_MIN_SIZE,), (QUANT_MIN_SIZE - 1,), (256, 256), (255, 256)]
    st = opt.init([torch.zeros(s) for s in shapes])
    jst = jopt.init([jnp.zeros(s) for s in shapes])
    got = [isinstance(mv["m"], QTensor) for mv in st["mu"]]
    assert got == [isinstance(mv["m"], JaxQTensor) for mv in jst["mu"]] == [True, False, True, False]
    assert QUANT_MIN_SIZE == 65_536


def test_adamw_update_in_place_equals_update():
    """``update_`` writes each leaf into its parameter and drops its
    gradient; the weights and the state are :meth:`update`'s."""
    params, grads = _problem(seed=1, steps=3)
    for moment_dtype in ("float32", "bfloat16", "int8"):
        opt = AdamW(schedule=warmup_cosine(1e-2, 1, 3), moment_dtype=moment_dtype)
        p = [torch.from_numpy(a.copy()) for a in params]
        q = [torch.from_numpy(a.copy()) for a in params]
        sp, sq = opt.init(p), opt.init(q)
        for g in grads:
            p, sp = opt.update(p, [torch.from_numpy(a) for a in g], sp)
            held = [t.data_ptr() for t in q]
            gl = [torch.from_numpy(a) for a in g]
            sq = opt.update_(q, gl, sq)
            assert gl == [None] * len(gl) and [t.data_ptr() for t in q] == held
        for a, b in zip(p, q):
            assert torch.equal(a, b)
        for x, y in zip(sp["mu"], sq["mu"]):
            for k in ("m", "v"):
                if isinstance(x[k], QTensor):
                    assert torch.equal(x[k].q, y[k].q) and torch.equal(x[k].scale, y[k].scale)
                else:
                    assert torch.equal(x[k], y[k])
        assert sp["count"] == sq["count"] == 3


def test_adamw_bf16_weights_update_in_float32():
    """A bf16 weight: the update runs in float32 and lands in bf16, as the
    reference's ``(p.astype(f32) - lr * upd).astype(p.dtype)``."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(300, 256)).astype(np.float32)
    gs = [rng.normal(size=w.shape).astype(np.float32) * 0.01 for _ in range(3)]
    for moment_dtype in ("bfloat16", "int8"):
        opt = AdamW(schedule=constant(1e-2), moment_dtype=moment_dtype)
        jopt = JaxAdamW(schedule=jax_constant(1e-2), moment_dtype=moment_dtype)
        p, jp = [torch.from_numpy(w).to(torch.bfloat16)], [jnp.asarray(w).astype(jnp.bfloat16)]
        st, jst = opt.init(p), jopt.init(jp)
        for g in gs:
            p, st = opt.update(p, [torch.from_numpy(g).to(torch.bfloat16)], st)
            jp, jst = jopt.update(jp, [jnp.asarray(g).astype(jnp.bfloat16)], jst)
        assert p[0].dtype == torch.bfloat16
        _bf16_close(p[0], jp[0])


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    """Five in-place steps (``update_``) under warmup_cosine (read at the
    incremented count) with and without momentum, against the reference's
    functional update; each weight keeps its storage, each gradient is
    dropped as it is used, and the velocity is float32 for a bf16 weight."""
    params, grads = _problem(seed=3)
    params = params + [params[0].copy()]
    grads = [g + [g[0]] for g in grads]
    opt, jopt = SGD(warmup_cosine(0.5, 2, 5), momentum), JaxSGD(jax_warmup_cosine(0.5, 2, 5), momentum)
    p = [torch.from_numpy(a.copy()) for a in params[:-1]] + [torch.from_numpy(params[-1]).to(torch.bfloat16)]
    jp = [jnp.asarray(a) for a in params[:-1]] + [jnp.asarray(params[-1]).astype(jnp.bfloat16)]
    st, jst = opt.init(p), jopt.init(jp)
    held = [t.data_ptr() for t in p]
    for g in grads:
        gl = [torch.from_numpy(a) for a in g]
        st = opt.update_(p, gl, st)
        assert gl == [None] * len(gl)
        jp, jst = jopt.update(jp, [jnp.asarray(a) for a in g], jst)
    assert [t.data_ptr() for t in p] == held
    for a, b in zip(p[:-1], jp[:-1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **UPDATE_TOL)
    assert p[-1].dtype == torch.bfloat16
    _bf16_close(p[-1], jp[-1])
    assert st["count"] == int(jst["count"]) == 5
    assert ("velocity" in st) == ("velocity" in jst) == bool(momentum)
    if momentum:
        assert st["velocity"][-1].dtype == torch.float32
        for v, jv in zip(st["velocity"], jst["velocity"]):
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), **UPDATE_TOL)
