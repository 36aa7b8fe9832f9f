"""SGD with optional momentum (port of the JAX package's ``optim/sgd.py``):
the paper's optimizer for NOMAD Projection.

The velocity is float32 whatever the parameter's dtype, and the schedule
is read at the incremented count, as in the reference. State:
``{"count": int}``, plus ``"velocity"`` (a list, the parameters' order)
with momentum. :meth:`update_` writes each leaf into its parameter in
place, as ``AdamW.update_`` does: the train step's way.
"""

from __future__ import annotations

from typing import Callable, MutableSequence, NamedTuple, Optional, Sequence

import torch


class SGD(NamedTuple):
    schedule: Callable
    momentum: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        state: dict = {"count": 0}
        if self.momentum:
            state["velocity"] = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        return state

    def leaf(self, p: torch.Tensor, g: torch.Tensor, vel: Optional[torch.Tensor], lr: float) -> tuple:
        """One leaf: (new p in p's dtype, new velocity or None)."""
        if self.momentum:
            vel = self.momentum * vel + g.float()
            return (p.float() - lr * vel).to(p.dtype), vel
        return (p.float() - lr * g.float()).to(p.dtype), None

    def _velocities(self, state: dict, n: int) -> list:
        return state["velocity"] if self.momentum else [None] * n

    def update_(self, params: Sequence[torch.Tensor], grads: MutableSequence, state: dict) -> dict:
        """One step in place, a leaf at a time; ``grads``' entries are
        dropped as they are used. Returns the new state."""
        count = state["count"] + 1
        lr = self.schedule(count)
        vels = []
        with torch.no_grad():
            for i, (p, v) in enumerate(zip(params, self._velocities(state, len(params)))):
                new_p, new_v = self.leaf(p, grads[i], v, lr)
                grads[i] = None
                p.copy_(new_p)
                vels.append(new_v)
        new_state: dict = {"count": count}
        if self.momentum:
            new_state["velocity"] = vels
        return new_state
