"""The port's training step (``repro_torch.models.steps``: ``cross_entropy``,
``make_loss_fn``, ``make_train_step``) against the JAX package's on the
CPU, for the attention architectures of ``ARCHS`` at ``reduced(...)`` size
(``tests/test_torch_train_ssm.py`` has Mamba-2 and Jamba;
``tests/test_torch_remat.py`` the tests that run the port alone).

The JAX package's ``init_params`` tree is carried across by
``convert.from_reference(..., device="cpu")``; the same numpy batch goes
through both. The reference's ``make_train_step`` is run with an
"optimiser" whose update returns the gradients it is given, so its
gradients come out exactly as the step computes them (microbatches and
accumulation included); the port's step gets one that records them.

Tolerances (float32): the loss, ce and aux agree to ``LOSS_REL`` = 1e-6
relative (measured ≤ 2.2e-7); each leaf's gradient to ‖Δ‖/‖g‖ ≤
``GRAD_REL`` = 1e-4 (measured ≤ 4e-5, Jamba's 16 layers the most: sum
order only). With two microbatches a leaf's gradient is the mean of two
that may nearly cancel (random weights and labels), so its error is held
against the mean of the two microbatches' gradient norms, the scale at
which the sum's rounding happens. An SGD step, linear in g, is held to
``GRAD_REL`` × lr × ‖g‖ plus the float32 rounding of the new weight.
Jamba's published config sums its microbatches in bf16
(``grad_accum_dtype``): there a few elements of a leaf (``BF16_FLIPS``) may
land one bf16 ulp apart, and the leaf's bound grows by 2^-8 ‖g‖.
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
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro.optim import SGD as JaxSGD  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import convert, steps  # noqa: E402
from repro_torch.optim import SGD, constant  # noqa: E402

LOSS_REL = 1e-6
GRAD_REL = 1e-4
SGD_LR = 0.1
BF16_FLIPS = 0.02  # the share of a bf16-accumulated leaf's elements (2 at least) that may differ by an ulp
B, S = 4, 64
SSM_ARCHS = ("jamba-1.5-large-398b", "mamba2-2.7b")
ATTN_ARCHS = tuple(n for n in sorted(ARCHS) if n not in SSM_ARCHS)
# past attn_chunk the step goes through attend_flash (Mixtral's window 16 included)
FLASH = {"attn_chunk": 16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class GradOut:
    """The reference step's "optimiser": its update returns the gradients."""

    def update(self, params, grads, state, *args):
        return grads, state


class Record:
    """The port step's optimiser: records the gradients, changes nothing."""

    def update_(self, params, grads, state):
        self.grads = [g.clone() for g in grads]
        return state


def configs(name: str, **kw):
    """(port config, reference config) at ``reduced`` size with ``kw``."""
    return reduced(ARCHS[name], **kw), ref_configs.reduced(ref_configs.ARCHS[name], **kw)


def make_batch(cfg, b: int = B, s: int = S, seed: int = 0) -> dict:
    """A numpy batch in the step's convention (labels pre-shifted)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "audio":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        P = cfg.n_vision_patches
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s - P)).astype(np.int32)
        if P:
            batch["patches"] = rng.normal(size=(b, P, cfg.d_model)).astype(np.float32)
    lab = s - cfg.n_vision_patches if cfg.family == "vlm" else s
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, lab)).astype(np.int32)
    return batch


def presplit(batch: dict, accum: int) -> dict:
    """The batch as (accum, micro, …), the reference's reshape."""
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:]) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ref_tree(ref_cfg):
    """The reference's ``init_params`` (seed 0) as numpy, made once."""
    return jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0), ref_cfg))


def port_model(name: str, cfg, ref_cfg):
    return convert.from_reference(ref_tree(ref_cfg), cfg, device="cpu")


def named(cfg, tree) -> dict:
    """A reference tree (weights or gradients) by the port's parameter names."""
    return dict(convert.from_reference(tree, cfg, device="cpu").named_parameters())


def ref_grads(ref_cfg, batch: dict, microbatched: bool = False):
    """(gradients as numpy, loss) of the reference's ``make_train_step``."""
    step = jax.jit(ref_steps.make_train_step(ref_cfg, GradOut(), microbatched=microbatched))
    g, _, loss = step(jax.tree.map(jnp.asarray, ref_tree(ref_cfg)), None, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, g), float(loss)


def port_grads(name: str, cfg, ref_cfg, batch: dict, microbatched: bool = False):
    """(gradients by parameter name, loss) of the port's ``make_train_step``."""
    model = port_model(name, cfg, ref_cfg)
    rec = Record()
    out, state, loss = steps.make_train_step(cfg, rec, microbatched=microbatched)(model, None, batch)
    assert out is model and state is None
    assert not any(p.requires_grad for p in model.parameters())
    return dict(zip([n for n, _ in model.named_parameters()], rec.grads)), float(loss)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 17, 301)) * 4).astype(np.float32)
    labels = rng.integers(0, 301, (3, 17)).astype(np.int32)
    ours = steps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    theirs = ref_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(float(ours), float(theirs), rtol=LOSS_REL)
    assert steps.MOE_AUX_COEF == ref_steps.MOE_AUX_COEF == 0.01


def check_loss_fn_against_reference(name: str) -> None:
    """loss, ce and moe_aux of ``make_loss_fn`` (the VLM's text positions
    only; ce + 0.01·aux with experts) on the same weights and batch."""
    cfg, ref_cfg = configs(name)
    batch = make_batch(cfg)
    loss, aux = jax.jit(ref_steps.make_loss_fn(ref_cfg))(jax.tree.map(jnp.asarray, ref_tree(ref_cfg)),
                                                         {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        ours, ours_aux = steps.make_loss_fn(cfg)(port_model(name, cfg, ref_cfg), batch)
    np.testing.assert_allclose(float(ours), float(loss), rtol=LOSS_REL)
    np.testing.assert_allclose(float(ours_aux["ce"]), float(aux["ce"]), rtol=LOSS_REL)
    np.testing.assert_allclose(float(ours_aux["moe_aux"]), float(aux["moe_aux"]), rtol=LOSS_REL, atol=1e-7)
    if cfg.n_experts:
        assert float(ours_aux["moe_aux"]) > 0
        np.testing.assert_allclose(float(ours), float(ours_aux["ce"]) + 0.01 * float(ours_aux["moe_aux"]), rtol=1e-6)
    else:
        assert float(ours) == float(ours_aux["ce"])


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_loss_fn_matches_jax(name):
    check_loss_fn_against_reference(name)


# ---------------------------------------------------------------------------
# The train step against the reference's
# ---------------------------------------------------------------------------


def check_step_against_reference(name: str, accum: int, **kw) -> None:
    """Gradients and an SGD step of the port's ``make_train_step`` against
    the reference's, with ``accum`` microbatches; the port's pre-split
    (``microbatched=True``) batch gives the same gradients bit for bit."""
    cfg, ref_cfg = configs(name, accum_steps=accum, **kw)
    batch = make_batch(cfg)
    want, want_loss = ref_grads(ref_cfg, batch)
    want = named(cfg, want)
    got, loss = port_grads(name, cfg, ref_cfg, batch)
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss)
    assert got.keys() == want.keys()
    if accum == 1:
        scale = {n: float(g.norm()) for n, g in want.items()}
    else:  # the mean of the microbatches' own gradient norms (see the module docstring)
        one, one_ref = configs(name, accum_steps=1, **kw)
        parts = [port_grads(name, one, one_ref, mb)[0] for mb in steps._split(batch, accum)]
        scale = {n: float(np.mean([float(p[n].norm()) for p in parts])) for n in want}
    gtol = {n: GRAD_REL * scale[n] for n in want}
    if cfg.grad_accum_dtype == "bfloat16" and accum > 1:
        # Jamba sums its microbatches in bf16 (its published config): a sum
        # whose float32 terms differ within GRAD_REL may round to the
        # neighbouring bf16 value, one bf16 ulp (2^-8 relative at most), on
        # a few elements
        gtol = {n: t + 2.0 ** -8 * float(want[n].norm()) for n, t in gtol.items()}
        flips = {n: int((got[n] != want[n]).sum()) for n in want}
        assert all(f <= max(2, BF16_FLIPS * want[n].numel()) for n, f in flips.items()), flips
    bad = {n: float((got[n] - want[n]).norm()) / scale[n] for n in want if float((got[n] - want[n]).norm()) > gtol[n]}
    assert not bad, bad
    pre, pre_loss = port_grads(name, cfg, ref_cfg, presplit(batch, accum) if accum > 1 else
                               {k: v[None] for k, v in batch.items()}, microbatched=True)
    assert pre_loss == loss and all(torch.equal(pre[n], got[n]) for n in got)
    # one SGD step, linear in g: the reference's SGD on the reference's gradients
    ref_p = named(cfg, ref_tree(ref_cfg))
    new_ref, _ = JaxSGD(jax_constant(SGD_LR)).update(
        [jnp.asarray(p.detach().numpy()) for p in ref_p.values()],
        [jnp.asarray(g.numpy()) for g in want.values()], JaxSGD(jax_constant(SGD_LR)).init([]))
    model = port_model(name, cfg, ref_cfg)
    opt = SGD(constant(SGD_LR))
    steps.make_train_step(cfg, opt)(model, opt.init(list(model.parameters())), batch)
    for (n, p), w in zip(model.named_parameters(), new_ref):
        w = torch.from_numpy(np.array(w))
        slack = SGD_LR * gtol[n] + 2.0 ** -23 * float(w.norm())
        assert float((p.detach() - w).norm()) <= slack, (n, float((p.detach() - w).norm()), slack)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_train_step_matches_jax(name, accum):
    check_step_against_reference(name, accum)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "mixtral-8x7b"])
def test_train_step_through_flash_matches_jax(name):
    """attn_chunk 16 < S: both steps take their flash attention (Mixtral
    with its window of 16), two microbatches."""
    check_step_against_reference(name, 2, **FLASH)


def test_reference_microbatched_layout_equals_the_ports():
    """The reference's pre-split path (``microbatched=True``) against the
    port's, on one pre-split batch."""
    cfg, ref_cfg = configs("qwen3-14b", accum_steps=2)
    batch = presplit(make_batch(cfg), 2)
    want, want_loss = ref_grads(ref_cfg, batch, microbatched=True)
    want = named(cfg, want)
    got, loss = port_grads("qwen3-14b", cfg, ref_cfg, batch, microbatched=True)
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss)
    one, one_ref = configs("qwen3-14b", accum_steps=1)
    parts = [port_grads("qwen3-14b", one, one_ref, {k: v[i] for k, v in batch.items()})[0] for i in range(2)]
    for n in want:
        scale = np.mean([float(p[n].norm()) for p in parts])
        assert float((got[n] - want[n]).norm()) <= GRAD_REL * scale, n


def test_bf16_gradient_accumulator():
    """``make_train_step`` reads ``accum_steps`` and ``grad_accum_dtype``
    from the config it is given: a bf16 accumulator sums in bf16, then
    divides in float32, as the reference's ``gz`` in ``acc_dt``."""
    cfg, ref_cfg = configs("yi-34b", accum_steps=2)
    cfg16 = dataclasses.replace(cfg, grad_accum_dtype="bfloat16")
    batch = make_batch(cfg)
    g32, _ = port_grads("yi-34b", cfg, ref_cfg, batch)
    g16, _ = port_grads("yi-34b", cfg16, ref_cfg, batch)
    for n in g32:
        assert g16[n].dtype == torch.float32
        assert rel(g16[n], g32[n]) <= 2.0 ** -7  # the sum rounded to bf16 once or twice
        assert not torch.equal(g16[n], g32[n]) or g32[n].abs().max() == 0
