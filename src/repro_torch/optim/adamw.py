"""AdamW as the JAX package writes it (``repro/optim/adamw.py``), with
float32, bfloat16 or int8 moments.

Not ``torch.optim.AdamW``: the second-moment decay defaults to 0.95, eps
is added after ``sqrt(v / bc2)``, the decoupled weight decay reaches
matrices only (``p.ndim >= 2``, never a bias), and the schedule is read at
the incremented count, so the first update uses ``schedule(1)``.

The moments are updated in float32 and stored in ``moment_dtype``:
bfloat16 moments are cast after the float32 update; under ``"int8"`` a
leaf of at least ``QUANT_MIN_SIZE`` elements keeps ``m`` as symmetric int8
and ``v`` on the sqrt scale (:mod:`repro_torch.optim.quantized`), and a
smaller leaf (norm scales, per-head vectors: their scales matter more than
their bytes) keeps float32 moments.

State: ``{"mu": [{"m", "v"} a leaf], "count": int}``, the leaves in the
order of the parameter sequence. :meth:`update` returns new tensors;
:meth:`update_` writes each new value into its parameter one leaf at a
time, for a model whose weights would not fit twice (the LM's train step).
"""

from __future__ import annotations

from typing import Callable, List, MutableSequence, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.optim.quantized import QTensor, maybe_dequantize, quantize_int8

QUANT_MIN_SIZE = 65_536
MOMENT_DTYPES = ("float32", "bfloat16", "int8")


class AdamW(NamedTuple):
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        """State for ``params`` (a sequence of tensors): per tensor its m and
        v, zero, on the tensor's device; and the step count."""
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"AdamW moment_dtype={self.moment_dtype!r}, want one of {MOMENT_DTYPES}")

        def one(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if self.moment_dtype == "int8" and p.numel() >= QUANT_MIN_SIZE:
                return {"m": quantize_int8(z), "v": quantize_int8(z, sqrt_scaled=True)}
            dt = torch.bfloat16 if self.moment_dtype == "bfloat16" else torch.float32
            return {"m": z.to(dt), "v": z.to(dt)}

        with torch.no_grad():
            return {"mu": [one(p) for p in params], "count": 0}

    def hyper(self, count: int) -> tuple:
        """(lr, bc1, bc2) of update number ``count`` (1 for the first): the
        schedule at ``count`` and the bias corrections in float32, as the
        reference takes them."""
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        return self.schedule(count), bc1, bc2

    def leaf(self, p: torch.Tensor, g: torch.Tensor, mv: dict, hyper: tuple) -> tuple:
        """One leaf's update: (new p in p's dtype, new {"m", "v"} stored as
        ``mv``'s are)."""
        lr, bc1, bc2 = hyper
        b1, b2 = self.b1, self.b2
        g = g.float()
        m = b1 * maybe_dequantize(mv["m"]) + (1 - b1) * g
        v = b2 * maybe_dequantize(mv["v"]) + (1 - b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            upd = upd + self.weight_decay * p.float()
        new_p = (p.float() - lr * upd).to(p.dtype)
        if isinstance(mv["m"], QTensor):
            return new_p, {"m": quantize_int8(m), "v": quantize_int8(v, sqrt_scaled=True)}
        return new_p, {"m": m.to(mv["m"].dtype), "v": v.to(mv["v"].dtype)}

    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: dict) -> tuple:
        """One step: (new params, new state). Nothing is updated in place."""
        count = state["count"] + 1
        h = self.hyper(count)
        with torch.no_grad():
            out = [self.leaf(p, g, mv, h) for p, g, mv in zip(params, grads, state["mu"])]
        new_p: List[torch.Tensor] = [o[0] for o in out]
        return new_p, {"mu": [o[1] for o in out], "count": count}

    def update_(self, params: Sequence[torch.Tensor], grads: MutableSequence, state: dict) -> dict:
        """One step in place: each leaf's new value is written into its
        parameter as soon as it is computed, and its entry of ``grads`` is
        dropped (set to None), so the step holds one leaf's temporaries at a
        time. Returns the new state; the same values as :meth:`update`."""
        count = state["count"] + 1
        h = self.hyper(count)
        mu = []
        with torch.no_grad():
            for i, (p, mv) in enumerate(zip(params, state["mu"])):
                new_p, new_mv = self.leaf(p, grads[i], mv, h)
                grads[i] = None
                p.copy_(new_p)
                mu.append(new_mv)
        return {"mu": mu, "count": count}
