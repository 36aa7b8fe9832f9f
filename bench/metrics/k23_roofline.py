"""k23_roofline: K2 (``kmeans_assign``) and K3 (``pairwise``) in the
profiled builds: the sum of each launch's bound over the kernels' device
time. K2 runs the k-means E-steps a row block at a time (the E-steps are
counted from its launches); K3 the candidate pass by the same blocks and
the in-cell kNN 256 cells a launch, on the tile route (3xTF32)."""

from bench import yardstick as ys

KNN_CELLS = 256


def _kernels(trace, *parts):
    return [v for n, v in trace["kernels"].items() if any(p in n for p in parts)]


def read(ctx):
    t, cfg = ctx["trace"], ctx["cfg"]
    if not t or ctx["traffic"]["kind"] != "builds":
        return None
    k2 = _kernels(t, "kmeans_assign_kernel")
    k2_all = _kernels(t, "kmeans_assign_kernel", "reduce_chunks_kernel")
    k3 = _kernels(t, "pairwise_tile_kernel", "pairwise_rows_kernel")
    if not k2 or not k3:
        return None
    N, D, K, blk = cfg["n_points"], cfg["dim"], cfg["n_clusters"], cfg["build_block_rows"]
    C = ys.capacity(cfg)
    blocks = [min(blk, N - s) for s in range(0, N, blk)]
    e_step = sum(ys.k2(b, K, D).bound_s() for b in blocks)
    cand = sum(ys.k3(1, b, K, D).bound_s() for b in blocks)
    knn = sum(ys.k3(min(KNN_CELLS, K - a), C, C, D).bound_s() for a in range(0, K, KNN_CELLS))
    e_steps = sum(c for c, _ in k2) / len(blocks)
    bound = e_steps * e_step + t["units"] * (cand + knn)
    return ys.share_pct(bound, sum(s for _, s in k2_all + k3))
