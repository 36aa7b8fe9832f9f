"""Pipeline-parallelism selftest (port of the JAX package's
``launch/selftest_pipeline.py``), on 4 shard slots of one device:

    python -m repro_torch.launch.selftest_pipeline              # on the card
    python -m repro_torch.launch.selftest_pipeline --device cpu

Checks the GPipe schedule against sequential layer application:
  1. an MLP stack, 4 stages × 2 layers, 6 microbatches (the reference's
     bound 1e-5);
  2. reduced Qwen3 transformer layers through the same harness (2e-4);
  3. the schedule runs T = n_micro + n_stages − 1 steps.
Each stage runs the sequential composition's arithmetic on the same
inputs, so on one device the port expects bit-equality and prints the max
|Δ| beside the bound. Prints ``PIPELINE SELFTEST PASS``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

STAGES = 4


def run(device=None) -> dict:
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.runtime import resolve_device
    from repro_torch.launch.mesh import local_slot_count, make_mesh, set_local_slots
    from repro_torch.launch.pipeline import gpipe, stack_stage_params
    from repro_torch.models import lm

    device = resolve_device(device)
    slots_before = local_slot_count()
    set_local_slots(STAGES)
    out: dict = {}
    try:
        mesh = make_mesh((STAGES,), ("stage",), device=device)
        gen = torch.Generator(device=device).manual_seed(0)

        # 1. MLP stack
        L, D, n_micro, Bm = 8, 64, 6, 16
        ws = [torch.randn((D, D), generator=gen, device=device) / np.sqrt(D) for _ in range(L)]

        def stage_fn(sp, x):  # sp: this stage's (D, D) weights
            for w in sp:
                x = torch.tanh(x @ w)
            return x

        x = torch.randn((n_micro, Bm, D), generator=gen, device=device)
        run_mlp = gpipe(mesh, "stage", stage_fn, n_micro)
        got = run_mlp(stack_stage_params(ws, STAGES), x)
        want = torch.stack([stage_fn(ws, x[i]) for i in range(n_micro)])
        err = float(torch.max(torch.abs(got - want)))
        print("MLP gpipe max err:", err, "(bound 1e-5)", flush=True)
        assert err < 1e-5, err
        out["mlp_err"] = err

        # 3. the schedule's length
        assert run_mlp.steps == n_micro + STAGES - 1, run_mlp.steps
        print(f"schedule: T = {run_mlp.steps} = n_micro {n_micro} + stages {STAGES} - 1", flush=True)
        out["steps"] = run_mlp.steps

        # 2. transformer stages
        cfg = reduced(ARCHS["qwen3-14b"], n_layers=8)
        model = lm.init_params(cfg, generator=torch.Generator(device=device).manual_seed(2))
        pos = torch.arange(32, dtype=torch.int32, device=device)

        def tf_stage(layers, xh):
            B, S, _ = xh.shape
            aux = torch.zeros((), dtype=torch.float32, device=device)
            p = pos[None, :S].expand(B, S)
            for layer in layers:
                xh, aux, _ = layer(xh, aux, p, cfg, True)
            return xh

        xh = torch.randn((n_micro, 2, 32, cfg.d_model), generator=gen, device=device)
        with torch.no_grad():
            run_tf = gpipe(mesh, "stage", tf_stage, n_micro)
            got_tf = run_tf(stack_stage_params(list(model.layers), STAGES), xh)
            want_tf = torch.stack([tf_stage(list(model.layers), xh[i]) for i in range(n_micro)])
        err = float(torch.max(torch.abs(got_tf - want_tf)))
        print("transformer gpipe max err:", err, "(bound 2e-4)", flush=True)
        assert err < 2e-4, err
        out["transformer_err"] = err
    finally:
        set_local_slots(slots_before)
    print("PIPELINE SELFTEST PASS", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device of the slots (default: the card)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
