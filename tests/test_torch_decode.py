"""The port's serving path (``repro_torch.models``: ``steps.make_prefill_step``,
``lm.init_cache``, ``lm.load_cache_from_prefill``, ``lm.decode_step``)
against the JAX package's on the CPU, for the nine decode-capable
``ARCHS`` at ``reduced()`` size (HuBERT is encoder-only).

The JAX package's ``init_params`` tree is carried across by
``convert.from_reference``; the same numpy tokens (and patches for
InternVL2) go through both packages. Prefill takes the first ``P`` tokens
and four decode steps follow; the prefill lengths stay within
``attn_chunk`` (64) and are whole SSD chunks (``ssm_chunk`` 32 ≥ the
length), as both packages require. ``reduced()`` runs the MoE drop-free
(capacity factor 8 ≥ E/k), so decode and the full forward make the same
routing decisions. Tolerances: ``FP32_TOL`` (rtol = atol = 1e-4) as
``test_torch_models.py``; measured ≤ 2e-5 (summation order only).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.data.embeddings import hidden_states  # noqa: E402
from repro_torch.models import attention, convert, lm, steps  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=0.1)
# the bf16 decode's logits against the bf16 full forward's, ‖Δ‖/‖logits‖
# a sequence: bf16 keeps 8 bits (unit roundoff 2^-9 ≈ 0.002) and both
# round the activations at every product and norm, ~10 times a layer
BF16_REL = 0.05
B, S, P = 2, 32, 28  # batch, tokens in all, prefill length (four decode steps)
DECODE_ARCHS = sorted(n for n in ARCHS if not ARCHS[n].encoder_only)
CACHE_KEYS = ("k", "v", "pos", "ssm_h", "ssm_tx", "ssm_tb", "ssm_tc")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread runs them
    faster than a pool, and keeps the module from contending with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n_patches(cfg) -> int:
    return cfg.n_vision_patches if cfg.family == "vlm" else 0


def _inputs(cfg, n: int = S, seed: int = 0):
    """(tokens (B, n − patches) int32, patches (B, P_v, D) or None): a
    sequence of ``n`` positions."""
    rng = np.random.default_rng(seed)
    nv = _n_patches(cfg)
    toks = rng.integers(0, cfg.vocab_size, (B, n - nv)).astype(np.int32)
    patches = rng.normal(size=(B, nv, cfg.d_model)).astype(np.float32) if nv else None
    return toks, patches


def _batch(cfg, toks, patches, n_pre: int) -> dict:
    """The prefill batch of the first ``n_pre`` positions."""
    batch = {"tokens": toks[:, : n_pre - _n_patches(cfg)]}
    if patches is not None:
        batch["patches"] = patches
    return batch


def _leaves(cache) -> dict:
    """A copy of a cache's leaves as numpy (``idx`` as an int), either
    package: the port's next decode step writes its tensors in place."""
    return {k: (int(v) if k == "idx" else np.array(v.numpy() if hasattr(v, "numpy") else v))
            for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def _reference(name: str, n_pre: int = P, n_all: int = S, **overrides):
    """The JAX package's run of ``name``: its params as numpy, the
    prefill's last logits and its loaded cache, then each decode step's
    logits and cache, and the full forward's logits over all positions."""
    rcfg = ref_configs.reduced(ref_configs.ARCHS[name], **overrides)
    params = ref_lm.init_params(jax.random.key(0), rcfg)
    toks, patches = _inputs(rcfg, n_all)
    jb = {k: jnp.asarray(v) for k, v in _batch(rcfg, toks, patches, n_pre).items()}
    logits, stacked = jax.jit(ref_steps.make_prefill_step(rcfg))(params, jb)
    cache = ref_lm.init_cache(rcfg, B, n_all, filled=n_pre)
    cache = ref_lm.load_cache_from_prefill(rcfg, cache, stacked, n_pre)
    out = {"tree": jax.tree.map(np.asarray, params), "prefill_logits": np.asarray(logits),
           "prefill_cache": _leaves(cache), "steps": []}
    decode = jax.jit(ref_steps.make_decode_step(rcfg))
    nv = _n_patches(rcfg)
    for t in range(n_pre, n_all):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, t - nv : t - nv + 1]))
        out["steps"].append((np.asarray(logits), _leaves(cache)))
    full, _, _ = jax.jit(functools.partial(ref_lm.forward, cfg=rcfg))(
        params, tokens=jnp.asarray(toks), patches=None if patches is None else jnp.asarray(patches))
    out["full_logits"] = np.asarray(full)
    return out


def _port_run(name: str, n_pre: int = P, n_all: int = S, **overrides):
    """The port's prefill, loaded cache and decode steps on the JAX
    package's weights: (prefill logits, prefill cache leaves, [(logits,
    cache leaves)] a step, the port's full-forward logits)."""
    ref = _reference(name, n_pre, n_all, **overrides)
    cfg = reduced(ARCHS[name], **overrides)
    model = convert.from_reference(ref["tree"], cfg, device="cpu")
    toks, patches = _inputs(cfg, n_all)
    logits, stacked = steps.make_prefill_step(cfg)(model, _batch(cfg, toks, patches, n_pre))
    cache = lm.init_cache(cfg, B, n_all, filled=n_pre, device="cpu")
    cache = lm.load_cache_from_prefill(cfg, cache, stacked, n_pre)
    pre = (logits.numpy(), _leaves(cache))
    decode = steps.make_decode_step(cfg)
    nv = _n_patches(cfg)
    got = []
    for t in range(n_pre, n_all):
        logits, cache = decode(model, cache, toks[:, t - nv : t - nv + 1])
        got.append((logits.numpy(), _leaves(cache)))
    with torch.inference_mode():
        full, _, _ = lm.forward(model, cfg, tokens=toks, patches=patches)
    return ref, pre, got, full.numpy()


def _assert_cache_equal(got: dict, want: dict):
    assert set(got) == set(want)
    assert got["idx"] == want["idx"]
    for k in CACHE_KEYS:
        if k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            if k == "pos":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **FP32_TOL)


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_prefill_and_cache_equal_reference(name):
    """The prefill's last logits and every cache leaf after init_cache +
    load_cache_from_prefill equal the JAX package's."""
    ref, (logits, cache), _, _ = _port_run(name)
    assert logits.shape == ref["prefill_logits"].shape == (B, 1, reduced(ARCHS[name]).vocab_padded)
    np.testing.assert_allclose(logits, ref["prefill_logits"], **FP32_TOL)
    _assert_cache_equal(cache, ref["prefill_cache"])


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_steps_equal_reference(name):
    """Four decode steps: after each, the logits, idx, pos and every
    k/v/SSM leaf equal the JAX decode_step's."""
    ref, _, got, _ = _port_run(name)
    assert len(got) == len(ref["steps"]) == S - P
    for (logits, cache), (want_logits, want_cache) in zip(got, ref["steps"]):
        np.testing.assert_allclose(logits, want_logits, **FP32_TOL)
        _assert_cache_equal(cache, want_cache)
    assert got[-1][1]["idx"] == S


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_equals_full_forward(name):
    """decode(token_t | cache from prefill(x_<t)) ≡ forward(x_≤t)'s logits
    at t, for each of the four steps (the reference's own test holds
    2e-3; the port holds FP32_TOL)."""
    ref, _, got, full = _port_run(name)
    np.testing.assert_allclose(full, ref["full_logits"], **FP32_TOL)
    for t, (logits, _) in zip(range(P, S), got):
        np.testing.assert_allclose(logits[:, 0], full[:, t], **FP32_TOL)


def test_swa_ring_wraps_as_reference():
    """Mixtral's ring (reduced window 16, capacity 16): a prefill of 31 >
    16 keeps the last 16 positions at their slots p % 16, then the decode
    at positions 31..34 writes slots 15, 0, 1, 2: each step ≡ the JAX
    package's and ≡ the full forward over 35 positions."""
    ref, (_, cache), got, full = _port_run("mixtral-8x7b", 31, 35)
    assert cache["k"].shape[2] == 16 and ARCHS["mixtral-8x7b"].sliding_window == 4096
    _assert_cache_equal(cache, ref["prefill_cache"])
    assert sorted(cache["pos"].tolist()) == list(range(15, 31))
    for t, ((logits, c), (want_logits, want_cache)) in enumerate(zip(got, ref["steps"]), start=31):
        np.testing.assert_allclose(logits, want_logits, **FP32_TOL)
        np.testing.assert_allclose(logits[:, 0], full[:, t], **FP32_TOL)
        _assert_cache_equal(c, want_cache)
        assert c["pos"][t % 16] == t
    assert got[-1][1]["pos"].max() == 34


@pytest.mark.parametrize("filled", [0, 5, 15, 16, 17, 31, 40, 100])
def test_init_cache_positions_equal_reference(filled):
    """``pos`` of a fresh cache, the ring's ``filled ≥ Sc`` branch included."""
    cfg, rcfg = reduced(ARCHS["mixtral-8x7b"]), ref_configs.reduced(ref_configs.ARCHS["mixtral-8x7b"])
    got = lm.init_cache(cfg, B, 64, filled=filled, device="cpu")
    want = ref_lm.init_cache(rcfg, B, 64, filled=filled)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    assert got["idx"] == int(want["idx"]) == filled
    assert got["k"].shape == want["k"].shape and lm.cache_capacity(cfg, 64) == 16


def _attn_case(H=8, KV=2, hd=16, Sk=40, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 7])
def test_attend_decode_equals_full_last_row_and_reference(window):
    """GQA with g = 4: one query at position Sk − 1 against the cache ≡
    ``attend_full``'s last row over the same keys; against the JAX
    ``attend_decode`` also with slots out of order and some invalid."""
    q, k, v = _attn_case()
    Sk = k.shape[1]
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    qpos = np.full((B, 1), Sk - 1, np.int32)
    t = torch.from_numpy
    got = attention.attend_decode(t(q), t(k), t(v), t(qpos), t(kpos), t(np.ones((B, Sk), bool)), window=window)
    q_all = np.random.default_rng(1).normal(size=(B, Sk, 8, 16)).astype(np.float32)
    q_all[:, -1:] = q
    full = attention.attend_full(t(q_all), t(k), t(v), t(kpos), t(kpos), causal=True, window=window)
    np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, -1], **FP32_TOL)
    # a ring's slot order and never-written slots
    perm = np.random.default_rng(2).permutation(Sk)
    kpos_r, valid = kpos[:, perm], (np.arange(Sk) % 5 != 3)[None, :].repeat(B, 0)
    kpos_r = np.where(valid, kpos_r, -(2**30)).astype(np.int32)
    args = (q, k[:, perm], v[:, perm], qpos, kpos_r, valid)
    got = attention.attend_decode(*map(t, args), window=window)
    want = ref_attn.attend_decode(*map(jnp.asarray, args), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("name", ["qwen3-14b", "mixtral-8x7b"])
def test_attention_block_keys_and_values_equal_reference(name):
    """``attention_block`` returns (y, (k, v)) as the reference's does;
    qwen3's qk-norm and mixtral's window included."""
    from repro_torch.models.convert import _attention, _Leaves

    rcfg, cfg = ref_configs.reduced(ref_configs.ARCHS[name]), reduced(ARCHS[name])
    p = jax.jit(ref_attn.init_attention, static_argnums=1)(jax.random.key(3), rcfg)
    x = np.random.default_rng(4).normal(size=(B, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (B, 24)).copy()
    want_y, (want_k, want_v) = jax.jit(
        lambda p_, x_, pos_: ref_attn.attention_block(p_, x_, pos_, rcfg, causal=True))(p, x, pos)
    ours = _attention(_Leaves(jax.tree.map(np.asarray, p), (), torch.device("cpu"), "float32"))
    y, (k, v) = attention.attention_block(ours, torch.from_numpy(x), torch.from_numpy(pos), cfg, causal=True)
    assert k.shape == (B, 24, cfg.n_kv_heads, cfg.head_dim) == v.shape
    for a, b_ in ((y, want_y), (k, want_k), (v, want_v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **FP32_TOL)


def test_bf16_decode_against_reference():
    """Phi-4-mini in bf16: the prefill's logits and cache equal the JAX
    package's bf16 prefill at ``BF16_TOL``, and each decode step's logits
    the JAX bf16 full forward's at that position (``BF16_TOL``, and
    ``BF16_REL`` a sequence). The JAX package's own bf16 ``decode_step``
    refuses to run: its float32 decode attention promotes the residual
    stream, and its scan over the layers rejects the carry's new dtype; the
    port keeps the residual in the compute dtype."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    rcfg = ref_configs.reduced(ref_configs.ARCHS["phi4-mini-3.8b"], **kw)
    cfg = reduced(ARCHS["phi4-mini-3.8b"], **kw)
    params = ref_lm.init_params(jax.random.key(0), rcfg)
    toks, _ = _inputs(cfg)
    want_logits, stacked = jax.jit(ref_steps.make_prefill_step(rcfg))(params, {"tokens": jnp.asarray(toks[:, :P])})
    want_cache = ref_lm.load_cache_from_prefill(rcfg, ref_lm.init_cache(rcfg, B, S, filled=P), stacked, P)
    full = np.asarray(jax.jit(lambda p_, t_: ref_lm.forward(p_, rcfg, tokens=t_)[0])(params, jnp.asarray(toks)))
    model = convert.from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    logits, got_stacked = steps.make_prefill_step(cfg)(model, {"tokens": toks[:, :P]})
    cache = lm.load_cache_from_prefill(cfg, lm.init_cache(cfg, B, S, filled=P, device="cpu"), got_stacked, P)
    assert cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **BF16_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].float().numpy(), np.asarray(want_cache[key], np.float32),
                                   **BF16_TOL)
    for t in range(P, S):
        logits, cache = lm.decode_step(model, cfg, cache, toks[:, t : t + 1])
        np.testing.assert_allclose(logits.numpy()[:, 0], full[:, t], **BF16_TOL)
        rel = np.linalg.norm(logits.numpy()[:, 0] - full[:, t], axis=-1) / np.linalg.norm(full[:, t], axis=-1)
        assert rel.max() <= BF16_REL, rel


def _body_before_cache_outputs(params, cfg, x):
    """The sequence forward as it read before the blocks returned their
    cache pieces: each block adds its attention / SSM output and its MLP,
    nothing else."""
    Bx, Sx, _ = x.shape
    positions = torch.arange(Sx, dtype=torch.int32).expand(Bx, Sx)
    causal = not cfg.encoder_only
    for block in params.blocks if cfg.family == "hybrid" else params.layers:
        if cfg.family == "hybrid":
            x = x + attention.attention_block(block.attn, rms_norm(x, block.attn_ln), positions, cfg,
                                              causal=causal)[0]
            aux, counters = torch.zeros(()), (0, 0)
            x, counters, aux = block._mlp_at(x, 0, counters, aux, cfg)
            for pos in range(1, cfg.attn_period):
                x = x + block.mamba[pos - 1](rms_norm(x, block.mamba_ln[pos - 1]), cfg)[0]
                x, counters, aux = block._mlp_at(x, pos, counters, aux, cfg)
            continue
        h = rms_norm(x, block.ln1)
        if block.attn is not None:
            x = x + attention.attention_block(block.attn, h, positions, cfg, causal=causal)[0]
        else:
            x = x + block.ssm(h, cfg)[0]
        if cfg.d_ff:
            h = rms_norm(x, block.ln2)
            x = x + (block.moe(h, cfg)[0] if block.moe is not None else block.mlp(h))
    return rms_norm(x, params.final_ln)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_embed_hidden_states_bit_equal_with_cache_outputs(name):
    """The embed pipeline's hidden states are bit-equal to the forward
    before the blocks returned cache pieces, and ``with_cache`` changes no
    logit."""
    cfg = reduced(ARCHS[name])
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    kw = {}
    if cfg.family == "audio":
        kw["embeds"] = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    else:
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (B, 16 - _n_patches(cfg))).astype(np.int32)
    if cfg.family == "vlm":
        kw["patches"] = rng.normal(size=(B, cfg.n_vision_patches, cfg.d_model)).astype(np.float32)
    got = hidden_states(model, cfg, **kw)
    with torch.inference_mode():
        want = _body_before_cache_outputs(model, cfg, lm.embed_in(model, cfg, **kw))
        a, _, none = lm.forward(model, cfg, **kw)
        b, _, cache = lm.forward(model, cfg, with_cache=True, **kw)
    assert torch.equal(got, want)
    assert none is None and torch.equal(a, b) and isinstance(cache, tuple) and len(cache) in (2, 4, 6)


def test_encoder_prefill_gives_no_cache():
    """HuBERT is encoder-only: its prefill step returns the last frame's
    logits and no cache, as the reference's."""
    cfg = reduced(ARCHS["hubert-xlarge"])
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(7))
    embeds = np.random.default_rng(8).normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    logits, cache = steps.make_prefill_step(cfg)(model, {"embeds": embeds})
    with torch.inference_mode():
        full, _, _ = lm.forward(model, cfg, embeds=embeds)
    assert cache is None and logits.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), full.numpy()[:, -1:], **FP32_TOL)
