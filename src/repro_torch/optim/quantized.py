"""Row-wise int8 quantisation for optimizer moments (port of the JAX
package's ``optim/quantized.py``).

The int8 payload keeps the **parameter's own shape** and the scales are
float32, one per row over the last axis (the parameter's shape without
it). The second moment is stored on a sqrt scale: strictly positive, half
the dynamic range in log space, and v's per-row spread is what per-row
scaling struggles with most.

The arithmetic is the reference's: float32 absmax / 127 floored at 1e-12,
``round`` half to even (``torch.round`` and ``jnp.round`` both do), clip to
±127, and a correctly rounded division and square root; so the payloads
and scales are the JAX package's bit for bit, on the card as on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor  # int8, same shape as the original tensor
    scale: torch.Tensor  # fp32, original shape minus the last axis
    sqrt_scaled: bool = False  # payload encodes sqrt(x) of an x ≥ 0 tensor


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root. The card's ``sqrt`` is
    (IEEE); the CPU's vectorised one is not (it misses by an ulp on ~0.7%
    of inputs), so on the CPU it is taken in float64 and rounded once,
    which is exact for a float32 input."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def quantize_int8(x: torch.Tensor, *, sqrt_scaled: bool = False) -> QTensor:
    x = x.float()
    if sqrt_scaled:
        x = _sqrt(torch.clamp_min(x, 0.0))
    absmax = torch.amax(torch.abs(x), dim=-1)
    # a 0-d tensor divisor: the card divides by a Python scalar as a product
    # with its reciprocal, which rounds otherwise than the division
    scale = torch.clamp_min(absmax / torch.full((), 127.0, device=x.device), 1e-12)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale, sqrt_scaled=sqrt_scaled)


def dequantize_int8(t: QTensor) -> torch.Tensor:
    x = t.q.float() * t.scale[..., None]
    if t.sqrt_scaled:
        x = torch.square(x)
    return x


def quantize_like(x: torch.Tensor, proto) -> "QTensor | torch.Tensor":
    """``x`` stored as ``proto`` is: int8 with ``proto``'s sqrt flag, or
    cast to ``proto``'s dtype."""
    if isinstance(proto, QTensor):
        return quantize_int8(x, sqrt_scaled=proto.sqrt_scaled)
    return x.to(proto.dtype)


def maybe_dequantize(x) -> torch.Tensor:
    return dequantize_int8(x) if isinstance(x, QTensor) else x.float()
