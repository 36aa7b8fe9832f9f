"""GPipe pipeline parallelism over a mesh axis (port of the JAX package's
``launch/pipeline.py``).

Layers are split into ``n_stages`` contiguous groups; stage s's group
lives on the slots at coordinate s of the axis, and microbatches move
through the stages by a shift along it, the SPMD GPipe schedule:

  step t ∈ [0, n_micro + n_stages − 1):
    stage 0 ingests microbatch t (while t < n_micro); every stage runs its
    group on the activation it holds, unless it is in its fill or drain
    bubble (then it passes the activation on untouched); the last stage
    emits microbatch t − (n_stages − 1); every activation moves to stage
    s + 1 (``Mesh.shift``).

Generic over ``stage_fn(stage_params, x)``. The port's stacked stage
params are a list of per-layer modules (or tensors) cut into ``n_stages``
contiguous groups (:func:`stack_stage_params`). Each stage's work on a
microbatch is the sequential composition's, on the same inputs, so the
result equals it bit for bit on one device.

Cost: bubble fraction = (S − 1) / (T + S − 1); wire = one microbatch's
activation a hop a step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def stack_stage_params(params: Sequence, n_stages: int) -> list:
    """``params`` (a per-layer list) cut into ``n_stages`` contiguous groups
    of ``len(params) / n_stages`` layers."""
    params = list(params)
    L = len(params)
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages
    return [params[s * per : (s + 1) * per] for s in range(n_stages)]


def gpipe(mesh, axis: str, stage_fn: Callable, n_micro: int):
    """Build ``run(stage_params, x_micro) -> y_micro``, both global view:
    ``stage_params`` one entry a stage (:func:`stack_stage_params`),
    ``x_micro`` (n_micro, B_m, …). The result, all stages applied in
    order, is replicated to every slot, as the reference's masked ``psum``
    replicates it. ``run.steps`` is the schedule's length after a call."""
    n_stages = mesh.shape[axis]

    def run(stage_params, x_micro):
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} stage groups for {n_stages} stages")
        ids = mesh.local_indices()
        stage = [int(mesh.coords(i)[axis]) for i in ids]
        T = n_micro + n_stages - 1
        buf = [torch.zeros_like(x_micro[0]) for _ in ids]  # the activation each slot holds
        outs = [torch.zeros_like(x_micro) for _ in ids]
        for t in range(T):
            ys = []
            for j, s in enumerate(stage):
                x_in = x_micro[t] if (s == 0 and t < n_micro) else buf[j]
                active = 0 <= t - s < n_micro
                y = stage_fn(stage_params[s], x_in) if active else x_in
                if active and s == n_stages - 1:  # the last stage emits microbatch t − s
                    outs[j][t - s] = y
                ys.append(y)
            buf = mesh.shift(ys, axis, 1)
        run.steps = T
        # the outputs live on the last stage: replicate them by a sum of
        # zeros elsewhere (exact), as the reference's masked psum
        masked = [o if s == n_stages - 1 else torch.zeros_like(o) for o, s in zip(outs, stage)]
        return mesh.psum(masked, axis)[0].to(x_micro.device)

    run.steps = 0
    return run
