"""Mamba-2 (SSD — state-space duality) block (port of the JAX package's
``models/ssm.py``: the sequence forward and the O(1) decode step).

The sequence path uses the chunked SSD algorithm [arXiv:2405.21060]: within
a chunk the recurrence is a (Q×Q) masked, decay-weighted "attention"
(batched matmuls); across chunks a loop carries the (H, P, N) state. All
of it runs in float32, with the reference's ``clip(−60, 0)`` on each
exponent. Each of z/x/B/C/Δ has its own projection and the depthwise conv
runs per component, as in the reference. Decode is the recurrence
``h ← exp(Δ·A)·h + Δ·x⊗B``, ``y = h·C + D·x``, on a float32 state.

Layout: x_heads (B, S, H, P), B/C (B, S, N) (single group), state (B, H, P, N).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, frozen, gated_rms_norm, leaf_dtype, normal


class SSMParams(torch.nn.Module):
    """One Mamba-2 block's weights, the reference's fields by name:
    w_z/w_x (D, di), w_b/w_c (D, N), w_dt (D, H), conv_x (w, di),
    conv_b/conv_c (w, N), their biases, A_log/D/dt_bias (H,) fp32, norm_w
    (di,), w_out (di, D). :meth:`forward` is :func:`ssm_block`."""

    FIELDS = ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x", "conv_b", "conv_c", "conv_bias_x",
              "conv_bias_b", "conv_bias_c", "A_log", "D", "dt_bias", "norm_w", "w_out")

    def __init__(self, **weights):
        super().__init__()
        if set(weights) != set(self.FIELDS):
            raise ValueError(f"SSMParams takes exactly {self.FIELDS}")
        for name in self.FIELDS:
            setattr(self, name, frozen(weights[name]))

    def forward(self, x, cfg, state=None):
        return ssm_block(self, x, cfg, state)


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, P, N) fp32
    tail_x: torch.Tensor  # (B, w-1, di)
    tail_b: torch.Tensor  # (B, w-1, N)
    tail_c: torch.Tensor  # (B, w-1, N)


def init_ssm(gen: torch.Generator, cfg) -> SSMParams:
    dt_ = dtype_of(cfg.param_dtype)
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    s = 1.0 / np.sqrt(D)
    sw = 1.0 / np.sqrt(w)
    dev = gen.device

    def const(values, dtype):
        return torch.as_tensor(np.asarray(values, np.float32), device=dev).to(dtype)

    return SSMParams(
        w_z=normal(gen, (D, di), s, dt_),
        w_x=normal(gen, (D, di), s, dt_),
        w_b=normal(gen, (D, N), s, dt_),
        w_c=normal(gen, (D, N), s, dt_),
        w_dt=normal(gen, (D, H), s, dt_),
        conv_x=normal(gen, (w, di), sw, dt_),
        conv_b=normal(gen, (w, N), sw, dt_),
        conv_c=normal(gen, (w, N), sw, dt_),
        conv_bias_x=const(np.zeros(di), dt_),
        conv_bias_b=const(np.zeros(N), dt_),
        conv_bias_c=const(np.zeros(N), dt_),
        A_log=const(np.log(np.linspace(1.0, 16.0, H, dtype=np.float32)), leaf_dtype("A_log", cfg.param_dtype)),
        D=const(np.ones(H), leaf_dtype("D", cfg.param_dtype)),
        dt_bias=const(np.log(np.expm1(np.full(H, 1e-2, np.float32))),  # softplus⁻¹
                      leaf_dtype("dt_bias", cfg.param_dtype)),
        norm_w=const(np.ones(di), dt_),
        w_out=normal(gen, (di, D), 1.0 / np.sqrt(di), dt_),
    )


def init_ssm_state(cfg, batch: int, *, device=None) -> SSMState:
    """A zero decode state, float32 (the conv tails too)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SSMState(h=zeros(batch, H, P, N), tail_x=zeros(batch, w - 1, di), tail_b=zeros(batch, w - 1, N),
                    tail_c=zeros(batch, w - 1, N))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, tail: Optional[torch.Tensor]):
    """Depthwise causal conv width w over (B, S, C) with optional state tail.

    Returns (silu(conv(u)), new tail (B, w-1, C)); the taps are summed in
    the reference's order, each in u's dtype."""
    width = w.shape[0]
    B, S, C = u.shape
    if tail is None:
        tail = torch.zeros((B, width - 1, C), dtype=u.dtype, device=u.device)
    full = torch.cat([tail.to(u.dtype), u], dim=1)  # (B, S+w-1, C)
    out = full[:, 0:S, :] * w[0]
    for i in range(1, width):
        out = out + full[:, i : i + S, :] * w[i]
    out = out + bias
    return F.silu(out), full[:, -(width - 1) :, :]


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_scan(x_h, B_mat, C_mat, dt, A, h0, chunk: int):
    """Chunked SSD. x_h (B,S,H,P); B/C (B,S,N); dt (B,S,H) fp32; A (H,) fp32.

    Returns (y (B,S,H,P) fp32, h_final (B,H,P,N) fp32).
    """
    Bsz, S, H, P = x_h.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD chunk {chunk}")
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x_h.device))
    h = h0.float()
    ys = []
    for s0 in range(0, S, Q):
        xc = x_h[:, s0 : s0 + Q].float()  # (B,Q,H,P)
        Bc = B_mat[:, s0 : s0 + Q].float()  # (B,Q,N)
        Cc = C_mat[:, s0 : s0 + Q].float()
        dtc = dt[:, s0 : s0 + Q]  # (B,Q,H)
        dA = dtc * A  # ≤ 0
        cum = torch.cumsum(dA, dim=1)  # inclusive cumsum over the chunk
        # intra-chunk: scores[b,i,j,h] = (C_i·B_j)·exp(cum_i−cum_j)·dt_j, j≤i
        CB = torch.einsum("bin,bjn->bij", Cc, Bc)
        decay = _decay(cum[:, :, None, :] - cum[:, None, :, :])
        scores = CB[:, :, :, None] * decay * dtc[:, None, :, :]
        scores = torch.where(tri[None, :, :, None], scores, torch.zeros((), device=scores.device))
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xc)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, h) * _decay(cum)[:, :, :, None]
        # chunk state: S_c = Σ_j exp(cum_Q − cum_j)·dt_j·(x_j ⊗ B_j)
        wdt = (_decay(cum[:, -1:, :] - cum) * dtc)[..., None]  # (B,Q,H,1)
        S_c = torch.einsum("bjhp,bjn->bhpn", xc * wdt, Bc)
        h = h * _decay(cum[:, -1, :])[:, :, None, None] + S_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _project(p: SSMParams, x: torch.Tensor, cfg, state: Optional[SSMState]):
    """x (B,S,D) → (z, xs, B_mat, C_mat, dt, new tails) — conv'd/activated."""
    z = x @ p.w_z
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias)  # (B,S,H)
    xs, tx = _causal_conv(x @ p.w_x, p.conv_x, p.conv_bias_x, state.tail_x if state else None)
    Bm, tb = _causal_conv(x @ p.w_b, p.conv_b, p.conv_bias_b, state.tail_b if state else None)
    Cm, tc = _causal_conv(x @ p.w_c, p.conv_c, p.conv_bias_c, state.tail_c if state else None)
    return z, xs, Bm, Cm, dt, (tx, tb, tc)


def ssm_block(p: SSMParams, x: torch.Tensor, cfg, state: Optional[SSMState] = None):
    """Full-sequence Mamba-2 block. Returns (y (B,S,D), final SSMState)."""
    B, S, D = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt, (tx, tb, tc) = _project(p, x, cfg, state)
    xs = xs.reshape(B, S, H, P)
    A = -torch.exp(p.A_log)
    h0 = state.h if state is not None else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    y, h_final = ssd_scan(xs, Bm, Cm, dt, A, h0, cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = gated_rms_norm(y, z, p.norm_w)
    out = y @ p.w_out
    new_state = SSMState(h=h_final, tail_x=tx.float(), tail_b=tb.float(), tail_c=tc.float())
    return out, new_state


def ssm_decode_block(p: SSMParams, x: torch.Tensor, cfg, state: SSMState):
    """Single-token step. x: (B, 1, D) → (y (B,1,D), new state); the
    state passed in is left as it is."""
    B = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt, (tx, tb, tc) = _project(p, x, cfg, state)
    xs = xs[:, 0].reshape(B, H, P).float()
    B_vec = Bm[:, 0].float()
    C_vec = Cm[:, 0].float()
    dt0 = dt[:, 0, :]  # (B, H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt0 * A)  # (B, H)
    h = state.h * decay[:, :, None, None] + (xs * dt0[..., None])[..., None] * B_vec[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, C_vec) + p.D[None, :, None] * xs
    y = y.reshape(B, 1, di).to(x.dtype)
    y = gated_rms_norm(y, z, p.norm_w)
    new_state = SSMState(h=h, tail_x=tx.float(), tail_b=tb.float(), tail_c=tc.float())
    return y @ p.w_out, new_state
