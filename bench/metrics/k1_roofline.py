"""k1_roofline: K1 (``nomad_step`` forward and backward) in the profiled
epochs: the sum of each launch's bound (``bench/yardstick.py``: k1_fwd,
k1_bwd at the step's shapes) over the kernels' device time."""

from bench import yardstick as ys


def _kernels(trace, part):
    return [v for n, v in trace["kernels"].items() if part in n]


def read(ctx):
    t, cfg = ctx["trace"], ctx["cfg"]
    if not t:
        return None
    fwd, bwd = _kernels(t, "nomad_fwd_kernel"), _kernels(t, "nomad_bwd_kernel")
    if not fwd or not bwd:
        return None
    shape = (cfg["batch_size"], cfg["n_neighbors"], cfg["n_exact_negatives"], cfg["n_clusters"], cfg["out_dim"])
    bound = (sum(c for c, _ in fwd) * ys.k1_fwd(*shape).bound_s()
             + sum(c for c, _ in bwd) * ys.k1_bwd(*shape).bound_s())
    return ys.share_pct(bound, sum(s for _, s in fwd + bwd))
