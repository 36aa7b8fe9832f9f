"""Shared model layers: norms, RoPE, SwiGLU, initialisers (port of the JAX
package's ``models/layers.py``).

The functions take tensors and compute as the reference does: the norms and
RoPE in float32, cast back to the input's dtype. The ``init_*`` functions
draw from the reference's distributions (normal × ``1/√d_in``, 0.02 for the
embedding table) with an explicit ``torch.Generator`` on an explicit
device: the draws are PyTorch's, not JAX's, so the tests carry the JAX
package's weights across with :mod:`repro_torch.models.convert`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


# the leaves the reference keeps in float32 whatever the param dtype: the
# MoE router and the SSM's A_log, D and dt_bias
FP32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def leaf_dtype(name: str, param_dtype: str) -> torch.dtype:
    """The dtype of the weight leaf ``name``: float32 for
    :data:`FP32_LEAVES`, else ``param_dtype``."""
    return torch.float32 if name in FP32_LEAVES else dtype_of(param_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated RMSNorm: ``rmsnorm(x * silu(gate)) * w``."""
    dt = x.dtype
    x = x.float() * F.silu(gate.float())
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once: a host
    copy a call would wait for the card each layer (a blocking copy
    synchronises the stream). A normal tensor, whatever mode the first
    caller runs in; no caller writes it."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (B, S, ..., head_dim) by position-dependent angles.

    ``positions`` is (B, S); the angles broadcast over the head axes
    between S and head_dim.
    """
    hd = x.shape[-1]
    freqs = _rope_frequencies_on(hd, float(theta), x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    ang = ang.reshape(ang.shape[:-1] + (1,) * (x.dim() - ang.dim()) + ang.shape[-1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``(N(0, 1) * scale).astype(dtype)``, drawn in float32 on the
    generator's device, as the reference draws and casts. On the meta
    device (``lm.abstract_params``) nothing is drawn: an empty tensor of
    the shape and dtype."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> "SwiGLU":
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return SwiGLU(
        normal(gen, (d_model, d_ff), s_in, dtype),
        normal(gen, (d_model, d_ff), s_in, dtype),
        normal(gen, (d_ff, d_model), s_out, dtype),
    )


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / np.sqrt(d_in), dtype)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (vocab, d_model), 0.02, dtype)


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """A weight of the model zoo: it asks for no gradient until the train
    step asks (``lm.trainable``, for the span of its gradients), so the
    forward, prefill, decode and embedding record no graph."""
    return torch.nn.Parameter(t, requires_grad=False)


class SwiGLU(torch.nn.Module):
    """The SwiGLU MLP's weights, ``w_gate``/``w_up`` (D, F) and ``w_down``
    (F, D); :meth:`forward` is :func:`swiglu`."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = frozen(w_gate), frozen(w_up), frozen(w_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)
