"""The port's attention, SSD scan and MoE (``repro_torch.models``) against
the JAX package's functions on the same numpy inputs, on the CPU.

Tolerances (float32): attention paths 2e-5 (the JAX package's own
full-vs-chunked bound, ``tests/test_attention.py``); the SSD scan 2e-4
relative, 2e-5 absolute against the float64 naive recurrence (the bound of
``tests/test_ssm.py``) and 1e-5 against the JAX scan; the MoE 3e-5 (the
bound of ``tests/test_moe.py``). Routing decisions are compared exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import attention, moe, ssm  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_ssm import _naive_recurrence  # noqa: E402

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MOE_TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's functions here run at tiny shapes: one intra-op thread
    runs them faster than a pool, and keeps the module from contending
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_inputs(B=2, Sq=64, Sk=64, H=4, KV=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    return q, k, v, qp, kp


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_attend_chunked_equals_full_and_reference(causal, window, chunk):
    """GQA (4 heads on 2 kv heads), causal or not, with a sliding window."""
    ins = _attn_inputs()
    kw = dict(causal=causal, window=window)
    full = attention.attend_full(*map(_t, ins), **kw).numpy()
    chunked = attention.attend_chunked(*map(_t, ins), chunk=chunk, **kw).numpy()
    j = [jnp.asarray(a) for a in ins]
    np.testing.assert_allclose(chunked, full, **ATTN_TOL)
    np.testing.assert_allclose(full, np.asarray(ref_attn.attend_full(*j, **kw)), **ATTN_TOL)
    np.testing.assert_allclose(chunked, np.asarray(ref_attn.attend_chunked(*j, chunk=chunk, **kw)), **ATTN_TOL)


@pytest.mark.parametrize("sq,sk,chunk", [(32, 128, 32), (64, 32, 16), (16, 64, 128)])
def test_attend_chunked_uneven_chunks(sq, sk, chunk):
    """Sq ≠ Sk: q and kv chunks of different lengths, and a chunk past both."""
    ins = _attn_inputs(Sq=sq, Sk=sk, seed=7)
    want = np.asarray(ref_attn.attend_full(*map(jnp.asarray, ins), causal=False, window=0))
    got = attention.attend_chunked(*map(_t, ins), causal=False, window=0, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


def test_attend_chunked_refuses_ragged_chunks():
    with pytest.raises(ValueError, match="multiples"):
        attention.attend_chunked(*map(_t, _attn_inputs(Sq=48)), causal=True, chunk=32)


def test_attention_block_takes_the_chunked_path_past_attn_chunk():
    """Past ``attn_chunk`` the block runs the online softmax (the reference
    runs ``attend_flash``, the same forward): ≡ the reference's block."""
    from repro_torch.models.convert import _Leaves, _attention

    rcfg = ref_configs.reduced(ref_configs.ARCHS["mixtral-8x7b"], attn_chunk=16)
    cfg = reduced(ARCHS["mixtral-8x7b"], attn_chunk=16)
    p = jax.jit(ref_attn.init_attention, static_argnums=1)(jax.random.key(0), rcfg)
    x = np.random.default_rng(1).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    block = jax.jit(lambda p_, x_, pos_: ref_attn.attention_block(p_, x_, pos_, rcfg, causal=True))
    want, (want_k, want_v) = block(p, jnp.asarray(x), jnp.asarray(pos))
    ours = _attention(_Leaves(jax.tree.map(np.asarray, p), (), torch.device("cpu"), "float32"))
    got, (k, v) = attention.attention_block(ours, _t(x), _t(pos), cfg, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(want_k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(Bsz=2, T=32, H=3, P=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bsz, T, H, P)).astype(np.float32)
    Bm = (rng.normal(size=(Bsz, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(Bsz, T, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, T, H)) - 1.0)).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    h0 = (rng.normal(size=(Bsz, H, P, N)) * 0.1).astype(np.float32)
    return x, Bm, Cm, dt, A, h0


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_ssd_scan_matches_recurrence_and_reference(chunk):
    ins = _ssd_inputs()
    y, h = ssm.ssd_scan(*map(_t, ins), chunk)
    y_naive, h_naive = _naive_recurrence(*ins)
    np.testing.assert_allclose(y.numpy(), y_naive, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(h.numpy(), h_naive, rtol=2e-4, atol=2e-5)
    y_ref, h_ref = ref_ssm.ssd_scan(*map(jnp.asarray, ins), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)


def test_ssd_scan_long_sequence_stays_finite():
    """Large Δ·A saturates the clip(−60, 0) on every exponent, as in the
    reference. The chunk's cumulative sums reach ~3000 here, whose float32
    ulp (2.4e-4) is the relative error of each decay: hence 1e-3."""
    x, Bm, Cm, dt, A, h0 = _ssd_inputs(T=256)
    dt = dt * 50.0
    y, h = ssm.ssd_scan(*map(_t, (x, Bm, Cm, dt, A, h0)), 64)
    y_ref, _ = ref_ssm.ssd_scan(*map(jnp.asarray, (x, Bm, Cm, dt, A, h0)), 64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_setup(name, cf=8.0, B=2, S=16, seed=0):
    from repro_torch.models.convert import _Leaves, _moe

    rcfg = ref_configs.reduced(ref_configs.ARCHS[name], capacity_factor=cf)
    cfg = reduced(ARCHS[name], capacity_factor=cf)
    p = jax.jit(ref_moe.init_moe, static_argnums=1)(jax.random.key(seed), rcfg)
    ours = _moe(_Leaves(jax.tree.map(np.asarray, p), (), torch.device("cpu"), "float32"))
    x = np.random.default_rng(seed + 1).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, p, ours, x


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"])
def test_moe_sort_equals_einsum_dropfree_and_reference(name):
    rcfg, cfg, p, ours, x = _moe_setup(name)
    y_sort, a_sort = moe.moe_sort(ours, _t(x), cfg)
    y_ein, a_ein = moe.moe_einsum(ours, _t(x), cfg)
    np.testing.assert_allclose(y_sort.numpy(), y_ein.numpy(), **MOE_TOL)
    assert float(a_sort) == pytest.approx(float(a_ein), rel=1e-6)
    y_ref, a_ref = jax.jit(ref_moe.moe_sort, static_argnums=2)(p, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(y_sort.numpy(), np.asarray(y_ref), **MOE_TOL)
    assert float(a_sort) == pytest.approx(float(a_ref), rel=1e-5)


def _ref_keep(idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """The reference's capacity rule (``moe_sort``'s lines), applied to the
    reference router's choices: choice-major cumulative positions."""
    T, k = idx.shape
    onehot = jax.nn.one_hot(jnp.asarray(idx), E, dtype=jnp.int32)
    flat = onehot.transpose(1, 0, 2).reshape(k * T, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos_tok = (pos * flat).sum(-1).reshape(k, T).transpose(1, 0)
    return np.asarray(pos_tok < C)


@pytest.mark.parametrize("cf", [0.5, 0.75, 1.0])
def test_moe_capacity_drops_equal_reference(cf):
    """At capacities that drop tokens: the same experts chosen, the same
    keep/drop decision for every (token, choice), and the same outputs
    (a dropped token's row is exactly zero in both: Mixtral has no shared
    expert)."""
    rcfg, cfg, p, ours, x = _moe_setup("mixtral-8x7b", cf=cf, B=4, S=32)
    T, E, k = 4 * 32, cfg.n_experts, cfg.top_k
    C = moe.expert_capacity(T, E, k, cf)
    _, _, idx_ref = ref_moe._route(jnp.asarray(x.reshape(T, -1)), p, k)
    _, _, idx = moe._route(_t(x.reshape(T, -1)), ours, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    _, keep = moe.capacity_positions(idx, E, C)
    keep_ref = _ref_keep(np.asarray(idx_ref), E, C)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    assert 0 < keep_ref.sum() < keep_ref.size  # the capacity really drops
    y, _ = moe.moe_sort(ours, _t(x), cfg)
    y_ref, _ = jax.jit(ref_moe.moe_sort, static_argnums=2)(p, jnp.asarray(x), rcfg)
    y, y_ref = y.numpy().reshape(T, -1), np.asarray(y_ref).reshape(T, -1)
    np.testing.assert_array_equal(np.all(y == 0, axis=-1), ~keep_ref.any(-1))
    np.testing.assert_array_equal(np.all(y_ref == 0, axis=-1), ~keep_ref.any(-1))
    np.testing.assert_allclose(y, y_ref, **MOE_TOL)
    y_ein, _ = moe.moe_einsum(ours, _t(x), cfg)
    np.testing.assert_allclose(y_ein.numpy().reshape(T, -1), y, **MOE_TOL)


def test_moe_router_ties_pick_the_lower_expert():
    """Tied probabilities: ``jax.lax.top_k``'s order, the lower id first."""
    rcfg, cfg, p, ours, x = _moe_setup("mixtral-8x7b")
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 1] = router[:, 3] = 1.0  # experts 1 and 3 tie above the rest
    x = np.abs(x)
    for r in (router, np.zeros_like(router)):  # a pair tied; all tied
        ours.router.data = _t(r)
        p = p._replace(router=jnp.asarray(r))
        _, _, idx = moe._route(_t(x.reshape(-1, cfg.d_model)), ours, 2)
        _, _, idx_ref = ref_moe._route(jnp.asarray(x.reshape(-1, cfg.d_model)), p, 2)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
        assert (idx.numpy() == ([1, 3] if r.any() else [0, 1])).all()


def test_moe_sort_rerun_is_bit_equal_and_dispatch_validates():
    _, cfg, _, ours, x = _moe_setup("llama4-scout-17b-a16e", cf=1.0)
    a, _ = moe.moe_block(ours, _t(x), cfg)
    b, _ = moe.moe_block(ours, _t(x), cfg)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_block(ours, _t(x), cfg, dispatch="ep")


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_route_hook_reports_every_decision(dispatch):
    """``moe.route_hook`` sees each block's (probs, ids, keep): the router's
    choices and the capacity rule's keeps, at a capacity that drops."""
    _, cfg, _, ours, x = _moe_setup("mixtral-8x7b", cf=0.5, B=4, S=32)
    seen = []
    with moe.route_hook(lambda p, i, k: seen.append((p, i, k))):
        moe.moe_block(ours, _t(x), cfg, dispatch=dispatch)
    moe.moe_block(ours, _t(x), cfg, dispatch=dispatch)  # outside the block: not reported
    T = x.shape[0] * x.shape[1]
    probs, _, idx = moe._route(_t(x.reshape(T, -1)), ours, cfg.top_k)
    _, keep = moe.capacity_positions(idx, cfg.n_experts, moe.expert_capacity(T, cfg.n_experts, cfg.top_k, 0.5))
    assert len(seen) == 1
    assert torch.equal(seen[0][0], probs) and torch.equal(seen[0][1], idx) and torch.equal(seen[0][2], keep)
    assert not keep.all()
