"""The port's ``attend_flash`` (``repro_torch.models.attention``) against
the JAX package's ``attend_flash`` (its custom VJP) and against autograd
through the port's ``attend_full``, on the CPU.

The same numpy q, k, v (k/v at KV heads: the GQA repeat and its head-sum
are inside both functions) and the same upstream gradient go through
``jax.vjp`` of the reference and ``torch.autograd.grad`` of the port, for
causal, sliding-window, bidirectional and MHA attention with several
chunks (S 64, chunk 16) and one chunk. Tolerances, ‖Δ‖/‖ref‖ per tensor:
float32 ``FP32_REL`` = 1e-5 (measured ~3e-7: sum order only); bfloat16
``BF16_REL`` = 1e-2 (the inputs, the output and the gradients are rounded
to bf16, 2^-9 relative a value, at places where the two frameworks' sums
already differ by float32 rounding; measured ≤ 4e-3).

A ``saved_tensors_hooks`` count shows what each path keeps for the
backward: flash no (cq, ck) tile, chunked every one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import attention  # noqa: E402

FP32_REL = 1e-5
BF16_REL = 1e-2
B, S, HD = 2, 64, 16
CASES = {  # name: (H, KV, causal, window, chunk)
    "causal_gqa": (4, 2, True, 0, 16),
    "window_gqa": (4, 2, True, 8, 16),
    "bidirectional_gqa": (4, 2, False, 0, 16),
    "causal_mha": (4, 4, True, 0, 16),
    "window_one_chunk": (4, 1, True, 24, 64),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(H, KV, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    dout = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, dout, pos


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port(fn, q, k, v, dout, pos, dtype, **kw):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    p = torch.from_numpy(pos)
    out = fn(*ts, p, p, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dout).to(dtype))
    return [out.detach().float().numpy()] + [g.float().numpy() for g in grads], out.dtype, [g.dtype for g in grads]


def _jax(q, k, v, dout, pos, dtype, **kw):
    p = jnp.asarray(pos)
    out, vjp = jax.vjp(lambda a, b, c: ref_attention.attend_flash(a, b, c, p, p, **kw),
                       *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(out.astype(jnp.float32))] + [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_vjp(case, dtype):
    H, KV, causal, window, chunk = CASES[case]
    q, k, v, dout, pos = _inputs(H, KV)
    kw = dict(causal=causal, window=window, chunk=chunk)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    ours, out_dt, grad_dts = _port(attention.attend_flash, q, k, v, dout, pos, tdt, **kw)
    theirs = _jax(q, k, v, dout, pos, jdt, **kw)
    assert out_dt == tdt and grad_dts == [tdt] * 3
    tol = FP32_REL if dtype == "float32" else BF16_REL
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_autograd_through_full(case):
    """Float32: flash's output and gradients against autograd through the
    port's ``attend_full`` (the oracle), and the chunked path's forward is
    flash's bit for bit."""
    H, KV, causal, window, chunk = CASES[case]
    q, k, v, dout, pos = _inputs(H, KV, seed=1)
    flash, _, _ = _port(attention.attend_flash, q, k, v, dout, pos, torch.float32, causal=causal, window=window,
                        chunk=chunk)
    full, _, _ = _port(attention.attend_full, q, k, v, dout, pos, torch.float32, causal=causal, window=window)
    chunked, _, _ = _port(attention.attend_chunked, q, k, v, dout, pos, torch.float32, causal=causal, window=window,
                          chunk=chunk)
    for name, a, b in zip(("out", "dq", "dk", "dv"), flash, full):
        assert _rel(a, b) <= FP32_REL, (name, _rel(a, b))
    np.testing.assert_array_equal(flash[0], chunked[0])
    for a, b in zip(flash[1:], chunked[1:]):
        assert _rel(a, b) <= FP32_REL


def _saved_shapes(fn, **kw):
    q, k, v, dout, pos = _inputs(4, 2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    p = torch.from_numpy(pos)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*ts, p, p, causal=True, **kw)
    torch.autograd.grad(out, ts, torch.from_numpy(dout))
    return shapes


def test_flash_saves_no_tile():
    """Flash keeps q, k, v (at H heads), out, L and the positions: no
    (cq, ck) probability or score tile, and O(S) per row. The chunked
    path's autograd keeps (B, H, 16, 16) tiles, 16 of them at least."""
    flash = _saved_shapes(attention.attend_flash, chunk=16)
    tile = lambda s: len(s) == 4 and s[-2:] == (16, 16)  # noqa: E731
    assert not [s for s in flash if tile(s)], flash
    assert (B, 4, S) in flash and flash.count((B, S, 4, HD)) >= 4  # L; q, k, v, out
    assert max(int(np.prod(s)) for s in flash) == B * S * 4 * HD
    chunked = _saved_shapes(attention.attend_chunked, chunk=16)
    assert sum(tile(s) for s in chunked) >= (S // 16) ** 2


def test_flash_masked_rows_are_zero_not_nan():
    """A window narrower than a chunk leaves whole rows of a tile masked
    (NEG_INF bias): their ``exp(s − L)`` is 0, and every gradient is finite."""
    q, k, v, dout, pos = _inputs(4, 2, seed=2)
    got, _, _ = _port(attention.attend_flash, q, k, v, dout, pos, torch.float32, causal=True, window=3, chunk=16)
    assert all(np.isfinite(a).all() for a in got)
    full, _, _ = _port(attention.attend_full, q, k, v, dout, pos, torch.float32, causal=True, window=3)
    for a, b in zip(got, full):
        assert _rel(a, b) <= FP32_REL


def test_attention_block_honours_attn_impl():
    """Past ``attn_chunk``, ``attention_block`` takes ``cfg.attn_impl``:
    "flash" and "chunked" give the same output bit for bit and the same
    weight gradients within fp32; flash keeps no tile."""
    base = dataclasses.replace(reduced(ARCHS["mixtral-8x7b"]), attn_chunk=16)
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attention(gen, base)
    x = torch.randn(B, S, base.d_model, generator=gen)
    positions = torch.arange(S, dtype=torch.int32).expand(B, S)
    outs, grads, tiles = {}, {}, {}
    for impl in ("flash", "chunked"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        for w in p.parameters():
            w.requires_grad_(True)
        n = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: n.append(tuple(t.shape)) or t, lambda t: t):
            y, _ = attention.attention_block(p, x, positions, cfg, causal=True)
        grads[impl] = torch.autograd.grad(y.square().sum(), list(p.parameters()))
        for w in p.parameters():
            w.requires_grad_(False)
        outs[impl], tiles[impl] = y.detach(), sum(1 for s in n if s[-2:] == (16, 16))
    assert torch.equal(outs["flash"], outs["chunked"])
    for a, b in zip(grads["flash"], grads["chunked"]):
        assert float((a - b).norm() / b.norm()) <= FP32_REL
    assert tiles["flash"] == 0 < tiles["chunked"]
