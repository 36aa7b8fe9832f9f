"""AdamW as the JAX package writes it (``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: the second-moment decay defaults to 0.95, eps
is added after ``sqrt(v / bc2)``, the decoupled weight decay reaches
matrices only (``p.ndim >= 2``, never a bias), and the schedule is read at
the incremented count, so the first update uses ``schedule(1)``.

Only float32 moments are ported (what the inverse head uses); the
reference's bfloat16 and int8 moments wait for the model zoo.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch


class AdamW(NamedTuple):
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        """State for ``params`` (a sequence of tensors): per tensor its m and
        v, zero, on the tensor's device; and the step count."""
        if self.moment_dtype != "float32":
            raise NotImplementedError(
                f"AdamW moment_dtype={self.moment_dtype!r} is not ported yet: only "
                "'float32' is (the bfloat16 and int8 moments come with the model "
                "zoo, ROADMAP queue 1 item 6)"
            )
        mu = [{"m": torch.zeros_like(p, dtype=torch.float32), "v": torch.zeros_like(p, dtype=torch.float32)}
              for p in params]
        return {"mu": mu, "count": 0}

    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: dict) -> tuple:
        """One step: (new params, new state). Nothing is updated in place."""
        count = state["count"] + 1
        lr = self.schedule(count)
        b1, b2 = self.b1, self.b2
        # the bias corrections in float32, as the reference takes them
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        new_p: List[torch.Tensor] = []
        new_mu: List[dict] = []
        for p, g, mv in zip(params, grads, state["mu"]):
            g = g.float()
            m = b1 * mv["m"] + (1 - b1) * g
            v = b2 * mv["v"] + (1 - b2) * torch.square(g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                upd = upd + self.weight_decay * p.float()
            new_p.append((p.float() - lr * upd).to(p.dtype))
            new_mu.append({"m": m, "v": v})
        return new_p, {"mu": new_mu, "count": count}
