"""K1 ``nomad_step``: the fused per-head NOMAD loss and its gradient.

Replaces the TPU kernels ``src/repro/kernels/nomad_step/nomad_step.py``
(``nomad_step_fwd_pallas`` and ``nomad_step_bwd_pallas``) and their custom
VJP (``ops.py:_build_op``), hand-written for Hopper in
``csrc/nomad_step.cu``. Per head b, with q = 1/(1 + d²):

    m_b    = Σ_r cw_r·[r ≠ own_b]·q(θ_b, μ_r) + Σ_s nw_bs·q(θ_b, θneg_bs)
    loss_b = Σ_j pw_bj·(log(q_pj + m_b) + log1p(d²_pj))

The forward returns (loss, m); the backward takes m as its residual and
returns gradients to θ, θpos and θneg only. :class:`NomadStep` wraps the
pair as a ``torch.autograd.Function`` whose gradient to pw, nw, μ, cw and
own is None, as the JAX VJP's is.

Bound on the card: d = 2, so the work is B·K Cauchy terms (one reciprocal
each) on CUDA cores, instruction-bound, with only O(B·(k + S)·d + K·d)
words moved. One warp per head, the means staged in shared memory, warp
shuffles for every reduction; heads write only their own gradient slots,
so there are no atomics and the scatter into θ happens outside.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry

TOL = (2e-5, 2e-5)
MAX_D = 4  # out dims the CUDA kernel is instantiated for


def nomad_step_fwd_plain(th, pos, pw, neg, nw, mu, cw, own):
    """(loss (B,), m (B,)) in the JAX oracle's op sequence (``ref.py``)."""
    K = mu.shape[0]
    d2m = torch.sum(torch.square(th[:, None, :] - mu[None, :, :]), -1)  # (B, K)
    mask = own[:, None] != torch.arange(K, device=own.device, dtype=own.dtype)[None, :]
    m_tilde = torch.sum((1.0 / (1.0 + d2m)) * cw[None, :] * mask, -1)
    d2_pos = torch.sum(torch.square(th[:, None, :] - pos), -1)
    q_pos = 1.0 / (1.0 + d2_pos)  # (B, k)
    d2_neg = torch.sum(torch.square(th[:, None, :] - neg), -1)
    q_neg = 1.0 / (1.0 + d2_neg)  # (B, S)
    m = m_tilde + torch.sum(nw * q_neg, -1)
    per_edge = torch.log(q_pos) - torch.log(q_pos + m[:, None])
    return -torch.sum(pw * per_edge, -1), m


def nomad_step_bwd_plain(th, pos, pw, neg, nw, mu, cw, own, m, gbar):
    """(g_i (B, d), g_pos (B, k, d), g_neg (B, S, d)) for upstream ``gbar``."""
    K = mu.shape[0]
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
    diff_m = th[:, None, :] - mu[None, :, :]
    q = 1.0 / (1.0 + torch.sum(torch.square(diff_m), -1))
    mask = own[:, None] != torch.arange(K, device=own.device, dtype=own.dtype)[None, :]
    fm = cw[None, :] * mask * q * q
    near = torch.sum(f[..., None] * diff_p, 1) - torch.sum(coef[..., None] * diff_n, 1)
    far = torch.sum(fm[..., None] * diff_m, 1)
    g_i = g2[:, None] * near - (g2 * G)[:, None] * far
    return g_i, g_pos, g_neg


def _shapes(th, pos, pw, neg, nw, mu, cw, own):
    B, d = th.shape
    k, S, K = pw.shape[1], nw.shape[1], mu.shape[0]
    want = {
        "theta_i": (th, (B, d)), "theta_pos": (pos, (B, k, d)), "pos_w": (pw, (B, k)),
        "theta_neg": (neg, (B, S, d)), "neg_w": (nw, (B, S)), "means": (mu, (K, d)),
        "cell_w": (cw, (K,)), "own_cell": (own, (B,)),
    }
    for label, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"nomad_step: {label} has shape {tuple(t.shape)}, want {shape}")
    if B < 1 or K < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"nomad_step: B={B}, K={K}, d={d} outside the kernel (B, K ≥ 1, 1 ≤ d ≤ {MAX_D})")
    return B, k, S, K, d


def _check(name, th, pos, pw, neg, nw, mu, cw, own, **extra):
    device = registry.require_cuda(
        name, theta_i=th, theta_pos=pos, pos_w=pw, theta_neg=neg, neg_w=nw,
        means=mu, cell_w=cw, own_cell=own, **extra,
    )
    registry.require_dtype(
        name, torch.float32, theta_i=th, theta_pos=pos, pos_w=pw, theta_neg=neg,
        neg_w=nw, means=mu, cell_w=cw, **extra,
    )
    registry.require_dtype(name, torch.int32, own_cell=own)
    return device, _shapes(th, pos, pw, neg, nw, mu, cw, own)


def nomad_step_fwd_cuda(th, pos, pw, neg, nw, mu, cw, own):
    device, (B, k, S, K, d) = _check("nomad_step_fwd", th, pos, pw, neg, nw, mu, cw, own)
    loss = torch.empty((B,), dtype=torch.float32, device=device)
    m = torch.empty((B,), dtype=torch.float32, device=device)
    lib = _build.load("nomad_step")
    with torch.cuda.device(device):
        err = lib.nomad_step_fwd_f32(
            th.data_ptr(), pos.data_ptr(), pw.data_ptr(), neg.data_ptr(), nw.data_ptr(),
            mu.data_ptr(), cw.data_ptr(), own.data_ptr(), loss.data_ptr(), m.data_ptr(),
            B, k, S, K, d, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "nomad_step_fwd")
    FWD.launches += 1
    return loss, m


def nomad_step_bwd_cuda(th, pos, pw, neg, nw, mu, cw, own, m, gbar):
    device, (B, k, S, K, d) = _check(
        "nomad_step_bwd", th, pos, pw, neg, nw, mu, cw, own, m=m, gbar=gbar
    )
    if tuple(m.shape) != (B,) or tuple(gbar.shape) != (B,):
        raise ValueError(f"nomad_step_bwd: m and gbar must be ({B},)")
    g_i = torch.empty_like(th)
    g_pos = torch.empty_like(pos)
    g_neg = torch.empty_like(neg)
    lib = _build.load("nomad_step")
    with torch.cuda.device(device):
        err = lib.nomad_step_bwd_f32(
            th.data_ptr(), pos.data_ptr(), pw.data_ptr(), neg.data_ptr(), nw.data_ptr(),
            mu.data_ptr(), cw.data_ptr(), own.data_ptr(), m.data_ptr(), gbar.data_ptr(),
            g_i.data_ptr(), g_pos.data_ptr(), g_neg.data_ptr(),
            B, k, S, K, d, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "nomad_step_bwd")
    BWD.launches += 1
    return g_i, g_pos, g_neg


class NomadStep(torch.autograd.Function):
    """Per-head loss (B,); differentiable in (θ_i, θ_pos, θ_neg) only."""

    @staticmethod
    def forward(ctx, th, pos, pw, neg, nw, mu, cw, own):
        loss, m = registry.dispatch("nomad_step_fwd", th, pos, pw, neg, nw, mu, cw, own)
        ctx.save_for_backward(th, pos, pw, neg, nw, mu, cw, own, m)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        g_i, g_pos, g_neg = registry.dispatch(
            "nomad_step_bwd", *ctx.saved_tensors, gbar.float().contiguous()
        )
        return g_i, g_pos, None, g_neg, None, None, None, None


def nomad_step_fused(theta_i, theta_pos, pos_w, theta_neg, neg_w, means, cell_w, own_cell):
    """The fused per-head step loss (B,); inputs cast to fp32 (own to int32)
    and made contiguous, as the JAX op's ``_prep`` does."""
    f = lambda t: t.float().contiguous()  # noqa: E731
    return NomadStep.apply(
        f(theta_i), f(theta_pos), f(pos_w), f(theta_neg), f(neg_w),
        f(means.detach()), f(cell_w), own_cell.to(torch.int32).contiguous(),
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
