"""The port's training step on its own, on the CPU, for every architecture
of ``ARCHS`` at ``reduced(...)`` size (on the JAX package's weights, carried
across): remat's three modes give bit-equal gradients; two microbatches
give the mean of the two microbatches' gradients, and (without experts,
whose auxiliary loss is per microbatch) the gradient of the whole batch;
the loss falls over four AdamW steps (the reference's
``test_train_step_decreases_loss``); MoE gradients reach the router and
every expert; a rematerialised layer reports each route once; the
weights ask for gradients only inside the step, which updates them in
place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import B, GRAD_REL, Record, configs, make_batch, port_grads, port_model  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import lm, moe, steps  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_remat_modes_give_bit_equal_gradients(name):
    """"none", "full" (every layer rerun in the backward) and "dots" (the
    matrix products kept, the rest rerun) compute the same gradients and
    loss bit for bit: the rerun repeats the forward's arithmetic."""
    got = {}
    for remat in ("none", "full", "dots"):
        cfg, ref_cfg = configs(name, remat=remat, attn_chunk=16)
        got[remat] = port_grads(name, cfg, ref_cfg, make_batch(cfg))
    for remat in ("full", "dots"):
        assert got[remat][1] == got["none"][1]
        for n, g in got["none"][0].items():
            assert torch.equal(got[remat][0][n], g), (remat, n)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_accumulation(name):
    """Two microbatches: the gradient is the mean of the two microbatches'
    (float32 sums, or the running sum's bf16 roundings for Jamba's bf16
    accumulator) and
    the loss the mean of their losses; without experts, also the whole
    batch's gradient within ``GRAD_REL`` (the cross-entropy's mean over
    equal microbatches is the batch mean; an MoE's aux loss and capacity are
    per microbatch, so there the two differ by design)."""
    cfg2, ref2 = configs(name, accum_steps=2)
    cfg1, ref1 = configs(name, accum_steps=1)
    batch = make_batch(cfg2)
    g2, l2 = port_grads(name, cfg2, ref2, batch)
    parts = [port_grads(name, cfg1, ref1, mb) for mb in steps._split(batch, 2)]
    assert abs(l2 - (parts[0][1] + parts[1][1]) / 2) <= 1e-6 * abs(l2)
    bf16 = cfg2.grad_accum_dtype == "bfloat16"
    for n, g in g2.items():
        mean = (parts[0][0][n] + parts[1][0][n]) / 2
        scale = (float(parts[0][0][n].norm()) + float(parts[1][0][n].norm())) / 2
        # bf16: the running sum is rounded twice, each within 2^-9 of its value
        tol = 2.0 ** -8 * (float(mean.norm()) + scale) if bf16 else 1e-6 * scale
        assert float((g - mean).norm()) <= tol, n
    if not cfg2.n_experts:
        g1, l1 = port_grads(name, cfg1, ref1, batch)
        assert abs(l1 - l2) <= 1e-6 * abs(l1)
        for n, g in g1.items():
            tol = 2.0 ** -8 * float(g.norm()) if bf16 else GRAD_REL * float(g.norm())
            assert float((g2[n] - g).norm()) <= tol, n


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_decreases_loss(name):
    """``tests/test_models_smoke.py:test_train_step_decreases_loss`` on the
    port: four AdamW steps (float32 moments, lr 3e-3, no weight decay) on
    one batch; every loss finite, the last below the first."""
    cfg, ref_cfg = configs(name)
    model = port_model(name, cfg, ref_cfg)
    opt = AdamW(schedule=constant(3e-3), moment_dtype="float32", weight_decay=0.0)
    state = opt.init(list(model.parameters()))
    step = steps.make_train_step(cfg, opt)
    batch = make_batch(cfg, b=2)
    losses = []
    for _ in range(4):
        model, state, loss = step(model, state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert state["count"] == 4


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"])
def test_moe_gradients_reach_router_and_every_expert(name):
    """Drop-free routing at ``reduced`` size: every expert is chosen by some
    token, so each expert's slices of w_gate/w_up/w_down get a gradient, and
    the router gets one through the gates and the aux loss."""
    cfg, ref_cfg = configs(name)
    grads, _ = port_grads(name, cfg, ref_cfg, make_batch(cfg))
    routers = [n for n in grads if n.endswith(".router")]
    assert routers
    for r in routers:
        assert float(grads[r].abs().max()) > 0, r
        stem = r[: -len("router")]
        for w in ("w_gate", "w_up", "w_down"):
            g = grads[stem + w]  # (E, ·, ·)
            assert bool((g.flatten(1).abs().amax(1) > 0).all()), (stem + w, g.flatten(1).abs().amax(1))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_reports_each_route_once(remat):
    """``moe.route_hook`` sees each MoE layer's decisions once a step: the
    backward's rerun of a rematerialised layer reports nothing."""
    cfg, ref_cfg = configs("mixtral-8x7b", remat=remat)
    model = port_model("mixtral-8x7b", cfg, ref_cfg)
    seen = []
    with moe.route_hook(lambda p, i, k: seen.append(i.shape)):
        steps.make_train_step(cfg, Record())(model, None, make_batch(cfg))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert len(seen) == n_moe and all(s == (B * 64, cfg.top_k) for s in seen)


def test_weights_ask_for_gradients_only_in_the_step():
    """A model's weights ask for no gradient after init, conversion and a
    step; inside the step's loss they all do; the forward under
    ``inference_mode`` records nothing; the step writes the new values into
    the same parameters (no second copy of the model)."""
    cfg, ref_cfg = configs("qwen3-14b")
    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    with torch.inference_mode():
        logits, _, _ = lm.forward(model, cfg, tokens=make_batch(cfg)["tokens"])
    assert logits.grad_fn is None
    inside = []
    real = steps.make_loss_fn

    def spy(c):
        f = real(c)

        def loss_fn(params, batch):
            inside.append(all(p.requires_grad for p in params.parameters()))
            return f(params, batch)

        return loss_fn

    steps.make_loss_fn = spy
    try:
        step = steps.make_train_step(cfg, AdamW(schedule=constant(1e-2), moment_dtype="int8"))
    finally:
        steps.make_loss_fn = real
    opt_state = AdamW(schedule=constant(1e-2), moment_dtype="int8").init(list(model.parameters()))
    before = {n: (p.data_ptr(), p.detach().clone()) for n, p in model.named_parameters()}
    out, opt_state, loss = step(model, opt_state, make_batch(cfg))
    assert out is model and inside == [True] and np.isfinite(float(loss))
    assert not any(p.requires_grad for p in model.parameters())
    for n, p in model.named_parameters():
        assert p.data_ptr() == before[n][0] and not torch.equal(p, before[n][1]), n
    assert opt_state["count"] == 1


def test_unknown_remat_raises():
    cfg, ref_cfg = configs("phi4-mini-3.8b")
    model = port_model("phi4-mini-3.8b", cfg, ref_cfg)
    with pytest.raises(ValueError, match="remat"):
        steps.make_train_step(dataclasses.replace(cfg, remat="some"), Record())(model, None, make_batch(cfg))


def test_presplit_batch_must_match_accum_steps():
    """A pre-split batch's leading axis is the microbatch count: one that
    does not match ``accum_steps`` is refused, not cut."""
    cfg, ref_cfg = configs("phi4-mini-3.8b", accum_steps=2)
    model = port_model("phi4-mini-3.8b", cfg, ref_cfg)
    batch = {k: v.reshape((4, 1) + v.shape[1:]) for k, v in make_batch(cfg).items()}
    with pytest.raises(ValueError, match="accumulates 2"):
        steps.make_train_step(cfg, Record(), microbatched=True)(model, None, batch)
