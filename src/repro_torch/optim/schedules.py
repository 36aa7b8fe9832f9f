"""Learning-rate schedules: plain functions of the step counter.

The JAX package's schedules (``repro/optim/schedules.py``), evaluated on
the host in float64 and rounded to float32 as the reference's are.
"""

from __future__ import annotations

import math

import numpy as np


def constant(lr: float):
    def schedule(step) -> float:
        return float(np.float32(lr))

    return schedule


def linear_decay(lr0: float, total_steps: int, floor: float = 0.0):
    """The paper's schedule: lr0 annealed linearly to ``floor`` (default 0)."""

    def schedule(step) -> float:
        frac = 1.0 - min(float(step), total_steps) / max(total_steps, 1)
        return float(np.float32(floor + (lr0 - floor) * frac))

    return schedule


def warmup_cosine(lr0: float, warmup: int, total_steps: int, floor_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from lr0 down to
    ``floor_frac``·lr0 at ``total_steps``."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup:
            return float(np.float32(lr0 * step / max(warmup, 1)))
        prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return float(np.float32(lr0 * (floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * prog)))))

    return schedule
