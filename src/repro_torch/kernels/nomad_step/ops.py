"""K1 ``nomad_step``: the fused per-head NOMAD loss and its gradient.

Replaces the TPU kernels ``src/repro/kernels/nomad_step/nomad_step.py``
(``nomad_step_fwd_pallas`` and ``nomad_step_bwd_pallas``) and their custom
VJP (``ops.py:_build_op``), hand-written for Hopper in
``csrc/nomad_step.cu``. Per head b, with q = 1/(1 + d²):

    m_b    = Σ_r cw_r·[r ≠ own_b]·q(θ_b, μ_r) + Σ_s nw_bs·q(θ_b, θneg_bs)
    far_b  = Σ_r cw_r·[r ≠ own_b]·q(θ_b, μ_r)²·(θ_b − μ_r)
    loss_b = Σ_j pw_bj·(log(q_pj + m_b) + log1p(d²_pj))

The forward returns (loss, m, far), far only when asked for; the backward
takes m and far as its residuals and returns gradients to θ, θpos and θneg
only, walking the k positives and S negatives of each head but never the
K means again. :class:`NomadStep` wraps the pair as a
``torch.autograd.Function`` whose gradient to pw, nw, μ, cw and own is
None, as the JAX VJP's is; its forward asks for far only when θ_i needs a
gradient. (The TPU kernels save m alone and walk the means again in the
backward.)

Bound on the card: d = 2, so the forward is B·K Cauchy terms (one SFU
reciprocal each) on CUDA cores, with only O(B·(k + S)·d + K·d) words
moved; the backward is bound by its bytes. The forward's walk over the
means is K4's (``csrc/cauchy_walk.cuh``): :func:`plan` cuts the K means
into chunks from K alone, the chunks of a 16-head tile form a thread-block
cluster whose rank 0 adds them in order, so a head's bits do not depend on
B. Heads write only their own gradient slots: no atomics, and the scatter
into θ happens outside.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.cauchy_mean.ops import split_means

TOL = (2e-5, 2e-5)
MAX_D = 4  # out dims the CUDA kernel is instantiated for
# csrc/nomad_step.cu's constants
CHUNK = 2048  # means a block walks, up to K = CHUNK·MAX_CLUSTER
HEADS = 16  # heads of one block
THREADS = 128
LANES = 8  # lanes of a head over its k positives and S negatives


def plan(K: int) -> tuple[int, int]:
    """(chunks, chunk_len) of the forward's walk: CHUNK means a block (2
    chunks of 2048 at K 4096), from K alone, never from B or the card."""
    return split_means(K, CHUNK)


def nomad_step_fwd_plain(th, pos, pw, neg, nw, mu, cw, own, want_far=False):
    """(loss (B,), m (B,), far (B, d) or None) in the JAX oracle's op
    sequence (``ref.py``); far only with ``want_far``."""
    K = mu.shape[0]
    diff_m = th[:, None, :] - mu[None, :, :]  # (B, K, d)
    q = 1.0 / (1.0 + torch.sum(torch.square(diff_m), -1))
    mask = own[:, None] != torch.arange(K, device=own.device, dtype=own.dtype)[None, :]
    m_tilde = torch.sum(q * cw[None, :] * mask, -1)
    d2_pos = torch.sum(torch.square(th[:, None, :] - pos), -1)
    q_pos = 1.0 / (1.0 + d2_pos)  # (B, k)
    d2_neg = torch.sum(torch.square(th[:, None, :] - neg), -1)
    q_neg = 1.0 / (1.0 + d2_neg)  # (B, S)
    m = m_tilde + torch.sum(nw * q_neg, -1)
    per_edge = torch.log(q_pos) - torch.log(q_pos + m[:, None])
    far = None
    if want_far:
        fm = cw[None, :] * mask * q * q
        far = torch.sum(fm[..., None] * diff_m, 1)
    return -torch.sum(pw * per_edge, -1), m, far


def nomad_step_bwd_plain(th, pos, pw, neg, nw, m, far, gbar):
    """(g_i (B, d) or None, g_pos (B, k, d), g_neg (B, S, d)) for upstream
    ``gbar``; g_i needs the forward's far, and is None without it."""
    g2 = 2.0 * gbar
    diff_p = th[:, None, :] - pos
    qp = 1.0 / (1.0 + torch.sum(torch.square(diff_p), -1))
    qpm = qp + m[:, None]
    G = torch.sum(pw / qpm, -1)  # ∂loss_b/∂m_b
    f = pw * (qp - qp * qp / qpm)
    g_pos = -g2[:, None, None] * f[..., None] * diff_p
    diff_n = th[:, None, :] - neg
    qn = 1.0 / (1.0 + torch.sum(torch.square(diff_n), -1))
    coef = G[:, None] * nw * qn * qn
    g_neg = g2[:, None, None] * coef[..., None] * diff_n
    if far is None:
        return None, g_pos, g_neg
    near = torch.sum(f[..., None] * diff_p, 1) - torch.sum(coef[..., None] * diff_n, 1)
    g_i = g2[:, None] * near - (g2 * G)[:, None] * far
    return g_i, g_pos, g_neg


def _check(name, th, pos, pw, neg, nw, **rest):
    """Device, dtypes and shapes of the inputs; returns (device, (B, k, S,
    K, d)), K None without means. ``rest``: means, cell_w and own_cell
    (forward) or m, far and gbar (backward)."""
    tensors = dict(theta_i=th, theta_pos=pos, pos_w=pw, theta_neg=neg, neg_w=nw, **rest)
    device = registry.require_cuda(name, **tensors)
    own = {label: t for label, t in tensors.items() if label == "own_cell"}
    registry.require_dtype(name, torch.float32, **{label: t for label, t in tensors.items() if label not in own})
    registry.require_dtype(name, torch.int32, **own)
    if th.dim() != 2:
        raise ValueError(f"{name}: theta_i must be (B, d), got {tuple(th.shape)}")
    B, d = th.shape
    k, S = pw.shape[-1], nw.shape[-1]
    K = rest["means"].shape[0] if "means" in rest else None
    want = {"theta_i": (B, d), "theta_pos": (B, k, d), "pos_w": (B, k), "theta_neg": (B, S, d),
            "neg_w": (B, S), "means": (K, d), "cell_w": (K,), "far": (B, d)}
    for label, t in tensors.items():
        if tuple(t.shape) != want.get(label, (B,)):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, want {want.get(label, (B,))}")
    if B < 1 or (K is not None and K < 1) or not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: B={B}, K={K}, d={d} outside the kernel (B, K ≥ 1, 1 ≤ d ≤ {MAX_D})")
    return device, (B, k, S, K, d)


def nomad_step_fwd_cuda(th, pos, pw, neg, nw, mu, cw, own, want_far=False):
    device, (B, k, S, K, d) = _check("nomad_step_fwd", th, pos, pw, neg, nw, means=mu, cell_w=cw, own_cell=own)
    loss = torch.empty((B,), dtype=torch.float32, device=device)
    m = torch.empty((B,), dtype=torch.float32, device=device)
    far = torch.empty((B, d), dtype=torch.float32, device=device) if want_far else None
    lib = _build.load("nomad_step")
    with torch.cuda.device(device):
        err = lib.nomad_step_fwd_f32(
            th.data_ptr(), pos.data_ptr(), pw.data_ptr(), neg.data_ptr(), nw.data_ptr(),
            mu.data_ptr(), cw.data_ptr(), own.data_ptr(), loss.data_ptr(), m.data_ptr(),
            None if far is None else far.data_ptr(),
            B, k, S, K, d, *plan(K), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "nomad_step_fwd")
    registry.count_launch(FWD)
    return loss, m, far


def nomad_step_bwd_cuda(th, pos, pw, neg, nw, m, far, gbar):
    residuals = {"m": m, "gbar": gbar} if far is None else {"m": m, "far": far, "gbar": gbar}
    device, (B, k, S, _, d) = _check("nomad_step_bwd", th, pos, pw, neg, nw, **residuals)
    g_i = None if far is None else torch.empty_like(th)
    g_pos = torch.empty_like(pos)
    g_neg = torch.empty_like(neg)
    lib = _build.load("nomad_step")
    with torch.cuda.device(device):
        err = lib.nomad_step_bwd_f32(
            th.data_ptr(), pos.data_ptr(), pw.data_ptr(), neg.data_ptr(), nw.data_ptr(),
            m.data_ptr(), None if far is None else far.data_ptr(), gbar.data_ptr(),
            None if g_i is None else g_i.data_ptr(), g_pos.data_ptr(), g_neg.data_ptr(),
            B, k, S, d, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "nomad_step_bwd")
    registry.count_launch(BWD)
    return g_i, g_pos, g_neg


class NomadStep(torch.autograd.Function):
    """Per-head loss (B,); differentiable in (θ_i, θ_pos, θ_neg) only.
    ``grad_mode``: whether the caller records a graph, which forward cannot
    see (it runs without grad mode, and ``needs_input_grad`` follows
    ``requires_grad`` alone); far is summed only when θ_i's gradient can
    be asked for."""

    @staticmethod
    def forward(ctx, th, pos, pw, neg, nw, mu, cw, own, grad_mode):
        loss, m, far = registry.dispatch(
            "nomad_step_fwd", th, pos, pw, neg, nw, mu, cw, own,
            want_far=grad_mode and ctx.needs_input_grad[0],
        )
        ctx.save_for_backward(th, pos, pw, neg, nw, m, far)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        g_i, g_pos, g_neg = registry.dispatch(
            "nomad_step_bwd", *ctx.saved_tensors, gbar.float().contiguous()
        )
        return g_i, g_pos, None, g_neg, None, None, None, None, None


def nomad_step_fused(theta_i, theta_pos, pos_w, theta_neg, neg_w, means, cell_w, own_cell):
    """The fused per-head step loss (B,); inputs cast to fp32 (own to int32)
    and made contiguous, as the JAX op's ``_prep`` does."""
    f = lambda t: t.float().contiguous()  # noqa: E731
    return NomadStep.apply(
        f(theta_i), f(theta_pos), f(pos_w), f(theta_neg), f(neg_w),
        f(means.detach()), f(cell_w), own_cell.to(torch.int32).contiguous(),
        torch.is_grad_enabled(),
    )


FWD = registry.register(
    registry.Kernel(
        name="nomad_step_fwd",
        plain=nomad_step_fwd_plain,
        cuda=nomad_step_fwd_cuda,
        source="src/repro_torch/csrc/nomad_step.cu",
        replaces="src/repro/kernels/nomad_step/nomad_step.py:166",
    )
)
BWD = registry.register(
    registry.Kernel(
        name="nomad_step_bwd",
        plain=nomad_step_bwd_plain,
        cuda=nomad_step_bwd_cuda,
        source="src/repro_torch/csrc/nomad_step.cu",
        replaces="src/repro/kernels/nomad_step/nomad_step.py:201",
    )
)


# ---------------------------------------------------------------------------
# Registry specs: the JAX spec's shapes, tolerance and (forward) cost model.
# The plan is the walk's split of the means, from K alone: it fixes the
# order of each head's sums, so it is the only one offered.
# ---------------------------------------------------------------------------


def _sig(B, k, S, K, d, dt="float32"):
    return (((B, d), dt), ((B, k, d), dt), ((B, k), dt), ((B, S, d), dt), ((B, S), dt), ((K, d), dt),
            ((K,), dt), ((B,), "int32"))


CHECK_SHAPES = (_sig(512, 15, 16, 64, 2), _sig(100, 5, 4, 33, 2), _sig(64, 3, 8, 100, 3), _sig(777, 15, 16, 130, 2))
BENCH_SHAPE = _sig(2048, 15, 16, 1024, 2)


def _fwd_inputs(gen, sig):
    (ts, tdt), (ps, _), (ws, _), (ns, _), (nws, _), (ms, _), (cs, _), (os_, _) = sig
    n = lambda shape: registry.draw(gen, shape, tdt, scale=3.0)  # noqa: E731
    u = lambda shape: registry.draw(gen, shape, tdt, uniform=True)  # noqa: E731
    return n(ts), n(ps), u(ws), n(ns), u(nws), n(ms), u(cs), registry.draw(gen, os_, "int32", high=ms[0])


def _bwd_inputs(gen, sig):
    """The backward's arguments at a forward signature: the residuals m and
    far of the plain forward, ḡ = 1/B (the batch mean's cotangent)."""
    th, pos, pw, neg, nw, mu, cw, own = _fwd_inputs(gen, sig)
    _, m, far = nomad_step_fwd_plain(th, pos, pw, neg, nw, mu, cw, own, want_far=True)
    return th, pos, pw, neg, nw, m, far, torch.full((th.shape[0],), 1.0 / th.shape[0], device=th.device)


def _fwd_cost(sig):
    (B, d) = sig[0][0]
    k, S, K = sig[2][0][1], sig[4][0][1], sig[5][0][0]
    flops = float(B) * (K * (3 * d + 4) + (k + S) * (3 * d + 12))
    return {"flops": flops, "bytes": 4.0 * (B * d + B * k * d + B * k + B * S * d + B * S + K * d + K + B + 2 * B)}


def _bwd_cost(sig):
    (B, d) = sig[0][0]
    k, S = sig[2][0][1], sig[4][0][1]
    return {"flops": float(B) * (k + S) * (8 * d + 8),
            "bytes": 4.0 * (2 * (B * d + B * k * d + B * S * d) + B * k + B * S + B * (2 + d))}


def _walk_plan(sig) -> dict:
    chunks, chunk_len = plan(sig[5][0][0])
    return {"chunks": chunks, "chunk_len": chunk_len}


for _name, _plain, _cuda, _inputs, _cost, _default in (
    ("nomad_step_fwd", nomad_step_fwd_plain, nomad_step_fwd_cuda, _fwd_inputs, _fwd_cost, _walk_plan),
    ("nomad_step_bwd", nomad_step_bwd_plain, nomad_step_bwd_cuda, _bwd_inputs, _bwd_cost, None),
):
    _entry, _candidates, _default_plan = registry.fixed_plan(_cuda, _default)
    registry.register_spec(registry.KernelSpec(
        name=_name, reference="nomad_step", plain=_plain, cuda=_entry, plan_candidates=_candidates,
        default_plan=_default_plan, make_inputs=_inputs, check_shapes=CHECK_SHAPES, bench_shapes=BENCH_SHAPE,
        tol=TOL, cost_model=_cost,
    ))
