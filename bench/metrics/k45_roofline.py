"""k45_roofline: K4 (``cauchy_mean``) and K5 (``frozen_attract``),
forward and backward, in the profiled requests: the sum of each launch's
bound at a batch of ``serve_microbatch`` rows over the kernels' device
time."""

from bench import yardstick as ys


def read(ctx):
    t, cfg = ctx["trace"], ctx["cfg"]
    if not t or ctx["traffic"]["kind"] != "queries":
        return None
    B, K, k, d = cfg["serve_microbatch"], cfg["n_clusters"], cfg["n_neighbors"], cfg["out_dim"]
    per_call = {
        "k4f": ys.k4_fwd(B, K, d).bound_s(), "k4b": ys.k4_bwd(B, K, d).bound_s(),
        "k5f": ys.k5_fwd(B, k, d).bound_s(), "k5b": ys.k5_bwd(B, k, d).bound_s(),
    }
    bound = dev = 0.0
    seen = set()
    for name, (count, secs) in t["kernels"].items():
        if "cauchy_kernel" in name:
            which = "k4b" if "true" in name else "k4f"
        elif "attract_fwd_kernel" in name:
            which = "k5f"
        elif "attract_bwd_kernel" in name:
            which = "k5b"
        else:
            continue
        seen.add(which)
        bound += count * per_call[which]
        dev += secs
    if seen != set(per_call):
        return None
    return ys.share_pct(bound, dev)
