"""The port's model zoo (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU, for every architecture of ``ARCHS`` at its
``reduced(...)`` size.

Both frameworks draw different random weights from one seed, so the JAX
package's ``init_params`` tree is carried across by
``repro_torch.models.convert.from_reference``; then the same numpy tokens
(frame embeddings for HuBERT, patches and tokens for InternVL2) go through
``repro.data.embeddings.hidden_states`` / ``repro.models.lm.forward`` and
the port's counterparts.

Tolerances: float32 forwards agree to ``FP32_TOL`` (rtol = atol = 1e-4;
measured ≤ 2e-5 at hidden states of magnitude ~4 through Jamba's 16
layers: summation order only). The bf16 forward is held to
``BF16_TOL`` (atol 0.1 at magnitude ~4, i.e. ~6 bf16 ulps at 4: each
framework rounds to bf16 after every product and norm, at different
points inside fused ops).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.data.embeddings import hidden_states as ref_hidden_states  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, reduced  # noqa: E402
from repro_torch.data.embeddings import hidden_states  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=0.1)
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's forwards here are tiny: one intra-op thread
    runs them faster than a pool, and keeps the module from contending
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.family == "audio":
        kw["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        kw["patches"] = rng.normal(size=(B, cfg.n_vision_patches, cfg.d_model)).astype(np.float32)
    return kw


@functools.lru_cache(maxsize=None)
def _ref_params(ref_cfg):
    """The JAX package's ``init_params`` tree for a config (seed 0), made
    once a module."""
    return ref_lm.init_params(jax.random.key(0), ref_cfg)


def _reference(ref_cfg):
    """The JAX package's params as numpy, and its (hidden states, logits,
    aux) on ``_inputs``: one jitted function for all three."""
    params = _ref_params(ref_cfg)

    @jax.jit
    def run(p, kw):
        h = ref_hidden_states(p, ref_cfg, **kw)
        logits, aux, _ = ref_lm.forward(p, ref_cfg, **kw)
        return h, logits, aux

    kw = {k: jnp.asarray(v) for k, v in _inputs(ref_cfg).items()}
    h, logits, aux = run(params, kw)
    return jax.tree.map(np.asarray, params), np.asarray(h, np.float32), np.asarray(logits), float(aux)


def _port(tree, cfg):
    model = convert.from_reference(tree, cfg, device="cpu")
    kw = _inputs(cfg)
    h = hidden_states(model, cfg, **kw).float().numpy()
    with torch.inference_mode():
        logits, aux, _ = lm.forward(model, cfg, **kw)
    return model, h, logits.numpy(), float(aux)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_config_equals_reference(name):
    """Field by field, published and reduced, with the derived properties."""
    ours, ref = ARCHS[name], ref_configs.ARCHS[name]
    for a, b in ((ours, ref), (reduced(ours), ref_configs.reduced(ref))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("d_inner", "ssm_heads", "q_per_kv", "n_heads_padded", "vocab_padded", "sub_quadratic"):
            assert getattr(a, prop) == getattr(b, prop), prop
        assert [a.layer_is_attention(i) for i in range(a.n_layers)] == [
            b.layer_is_attention(i) for i in range(b.n_layers)]
        assert [a.layer_is_moe(i) for i in range(a.n_layers)] == [b.layer_is_moe(i) for i in range(b.n_layers)]
        assert a.param_counts() == b.param_counts()
        assert a.supported_shapes() == b.supported_shapes()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


def _port_key(path) -> str:
    """The port's ``state_dict`` key of one stacked reference leaf, with
    ``{}`` where the layer (and a meta-block's position) index goes."""
    names = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    out = []
    for i, n in enumerate(names):
        out.append(n)
        if n in ("layers", "blocks") and i == 0:
            out.append("{}")
        elif names[0] == "blocks" and i == 1 and n in ("mamba", "moe", "dense"):
            out.append("{}")
    return ".".join(out)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_convert_carries_every_leaf(name):
    """Every leaf of the JAX tree lands, layer by layer, in the port's
    module with the same values, and the port holds nothing else."""
    cfg = reduced(ARCHS[name])
    tree = jax.tree.map(np.asarray, _ref_params(ref_configs.reduced(ref_configs.ARCHS[name])))
    state = convert.from_reference(tree, cfg, device="cpu").state_dict()
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = _port_key(path)
        n_idx = key.count("{}")
        leaf = np.asarray(leaf, np.float32)
        for idx in np.ndindex(*leaf.shape[:n_idx]):
            k = key.format(*idx)
            np.testing.assert_array_equal(state[k].float().numpy(), leaf[idx], err_msg=k)
            seen.add(k)
    assert seen == set(state)
    assert lm.n_params(convert.from_reference(tree, cfg, device="cpu")) == sum(np.size(x) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_reference(name):
    """hidden_states and forward's logits and MoE aux, float32."""
    cfg = reduced(ARCHS[name])
    tree, h_ref, logits_ref, aux_ref = _reference(ref_configs.reduced(ref_configs.ARCHS[name]))
    _, h, logits, aux = _port(tree, cfg)
    assert h.shape == h_ref.shape and logits.shape == logits_ref.shape
    np.testing.assert_allclose(h, h_ref, **FP32_TOL)
    np.testing.assert_allclose(logits, logits_ref, **FP32_TOL)
    assert aux == pytest.approx(aux_ref, rel=1e-5, abs=1e-6)


def test_forward_bf16_matches_reference():
    """Phi-4-mini's published dtypes (bf16 params and compute) at the
    reduced widths, held to BF16_TOL."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = reduced(ARCHS["phi4-mini-3.8b"], **kw)
    tree, h_ref, logits_ref, _ = _reference(ref_configs.reduced(ref_configs.ARCHS["phi4-mini-3.8b"], **kw))
    model, h, logits, _ = _port(tree, cfg)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_allclose(h, h_ref, **BF16_TOL)
    np.testing.assert_allclose(logits, logits_ref, **BF16_TOL)


def test_padded_heads_and_vocab_match_reference():
    """head_pad_to > 1 (inert heads masked) and vocab_pad_to > 1 (inert
    logit columns at -1e30), carried across as padded."""
    kw = dict(head_pad_to=8, vocab_pad_to=64, vocab_size=500)
    cfg = reduced(ARCHS["qwen3-14b"], **kw)
    assert cfg.n_heads_padded == 8 > cfg.n_heads and cfg.vocab_padded == 512 > cfg.vocab_size
    tree, h_ref, logits_ref, _ = _reference(ref_configs.reduced(ref_configs.ARCHS["qwen3-14b"], **kw))
    model, h, logits, _ = _port(tree, cfg)
    assert model.layers[0].attn.wq.shape[1] == 8
    np.testing.assert_allclose(h, h_ref, **FP32_TOL)
    np.testing.assert_array_equal(logits[..., 500:], np.float32(-1e30))
    np.testing.assert_allclose(logits, logits_ref, **FP32_TOL)
    with pytest.raises(ValueError, match="pads to"):
        convert.from_reference(tree, reduced(ARCHS["qwen3-14b"], vocab_size=500), device="cpu")


def test_from_reference_defaults_to_the_card(monkeypatch):
    """Without a device, ``from_reference`` goes to the card as every
    entry point of the port does, and without a card it raises as
    ``resolve_device`` does, instead of landing on the CPU."""
    from repro_torch.index.build import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(ARCHS["phi4-mini-3.8b"])
    tree = jax.tree.map(np.asarray, _ref_params(ref_configs.reduced(ref_configs.ARCHS["phi4-mini-3.8b"])))
    with pytest.raises(RuntimeError, match="device='cpu'") as got:
        convert.from_reference(tree, cfg)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    assert str(got.value) == str(want.value)
    assert convert.from_reference(tree, cfg, device="cpu").device == torch.device("cpu")


def test_init_params_draws_the_reference_shapes_and_scales():
    """The port's own init: the reference's leaf shapes and dtypes, and
    its distributions (0.02 for the table, 1/√d_in for projections), from
    one seeded generator; two draws of one seed are bit-equal."""
    cfg = reduced(ARCHS["mixtral-8x7b"], d_model=256)
    a = lm.init_params(cfg, generator=torch.Generator().manual_seed(3))
    b = lm.init_params(cfg, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    tree = jax.eval_shape(lambda k: ref_lm.init_params(k, ref_configs.reduced(
        ref_configs.ARCHS["mixtral-8x7b"], d_model=256)), jax.random.key(0))
    assert lm.n_params(a) == sum(np.prod(x.shape) for x in jax.tree.leaves(tree))
    assert float(a.embed.std()) == pytest.approx(0.02, rel=0.05)
    assert float(a.layers[0].attn.wq.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert a.layers[0].moe.router.dtype == torch.float32


def test_cast_keeps_the_float32_leaves():
    """``lm.cast`` to bf16: every weight bf16 but the router and the SSM's
    A_log/D/dt_bias (``layers.FP32_LEAVES``), the values rounded once; the
    source model is left as it was."""
    from repro_torch.models.layers import FP32_LEAVES

    cfg = reduced(ARCHS["jamba-1.5-large-398b"], n_layers=8)
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    m16 = lm.cast(model, cfg16)
    assert m16.cfg is cfg16 and model.cfg is cfg
    kept = set()
    for (name, a), (_, b) in zip(model.named_parameters(), m16.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        assert a.dtype == torch.float32
        if leaf in FP32_LEAVES:
            kept.add(leaf)
            assert b.dtype == torch.float32 and torch.equal(a, b)
        else:
            assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
    assert kept == FP32_LEAVES
