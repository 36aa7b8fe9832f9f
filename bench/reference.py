"""The plain reference of the three paths the benchmark times, in plain
PyTorch at a chosen precision.

It follows the paper's equations and the port's documented conventions,
not the port's code, and imports nothing of the program:

* the training step (Eq. 3 with R̃ every cell but the head's own): rows
  drawn as the port draws them (step t of epoch e from a generator seeded
  by (seed + 1, e, t): heads uniform over the points, S negatives uniform
  in the head's cell), the loss, its gradient by autograd (the cell means
  are data), and the sparse SGD update;
* the index build (§3.2): LSH-initialised k-means, the capacity-bounded
  assignment by bidding, the cluster-major permutation, the in-cell kNN
  and the inverse-rank weights of Eq. 6;
* the out-of-sample placement: nearest centroid, kNN in its cell, the
  Cauchy-weighted start, and the frozen steps with the port's per-row
  counter-hash draws.

``dtype`` is float64 where the benchmark judges the program, and
bfloat16 for the control that the judge has to refuse.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e30


# ---------------------------------------------------------------------------
# Shared conventions
# ---------------------------------------------------------------------------


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator seeded from a tuple of integers, as the port keys its
    k-means and its steps."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(seed[0]) << 31) ^ int(seed[1]))


def capacity(cfg: dict) -> int:
    return max(int(cfg["capacity_slack"] * cfg["n_points"] / cfg["n_clusters"]), cfg["n_neighbors"] + 2)


def normalizer(k: int) -> float:
    """Z of Eq. 6: Σ_{j=1}^{k+1} e^{1/j}."""
    return float(np.exp(1.0 / np.arange(1, k + 2)).sum())


def cauchy_q(d2: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + d2)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., n, m) by the product expansion, in a's dtype."""
    d2 = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))
    return torch.clamp_min(d2, 0.0)


def local_means(theta: torch.Tensor, counts: torch.Tensor, cap: int) -> torch.Tensor:
    """Each cell's mean position over its real rows: (K·C, d) → (K, d)."""
    K = counts.shape[0]
    th = theta.reshape(K, cap, -1)
    valid = torch.arange(cap, device=counts.device)[None, :] < counts[:, None]
    sums = (th * valid[:, :, None].to(th.dtype)).sum(1)
    return sums / torch.clamp_min(counts.to(th.dtype), 1.0)[:, None]


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------


def sample_step_rows(gen, counts, cum_counts, total: int, B: int, cap: int, S: int):
    """Heads uniform over the points, S negatives uniform in each head's
    cell: (rows (B,), cells (B,), negatives (B, S)) as row ids."""
    u = torch.randint(0, total, (B,), generator=gen, device=counts.device, dtype=torch.int64)
    cell = torch.searchsorted(cum_counts, u, right=True)
    start = torch.where(cell > 0, cum_counts[(cell - 1).clamp_min(0)], 0)
    rows = cell * cap + (u - start)
    c = counts[cell]
    r = torch.rand((B, S), generator=gen, device=counts.device)
    slot = torch.minimum(torch.floor(r * c[:, None]).to(torch.int64), (c - 1)[:, None])
    return rows, cell, cell[:, None] * cap + slot


def step_loss(th_i, th_pos, pos_w, means, cell_w, own, th_neg, neg_w):
    """Eq. 3, mean over the B heads: −Σ_s w_s [log q_s − log(q_s + M̃ + M)],
    M̃ over every cell but the head's own, M over the in-cell samples."""
    K = means.shape[0]
    q_m = cauchy_q(((th_i[:, None, :] - means[None, :, :]) ** 2).sum(-1))
    not_own = own[:, None] != torch.arange(K, device=own.device)[None, :]
    m_tilde = (q_m * cell_w[None, :] * not_own.to(q_m.dtype)).sum(-1)
    q_pos = cauchy_q(((th_i[:, None, :] - th_pos) ** 2).sum(-1))
    q_neg = cauchy_q(((th_i[:, None, :] - th_neg) ** 2).sum(-1))
    m = m_tilde + (neg_w * q_neg).sum(-1)
    per_edge = torch.log(q_pos) - torch.log(q_pos + m[:, None])
    return (-(pos_w * per_edge).sum(-1)).mean()


class TrainState:
    """θ and the index arrays one training run reads, at ``dtype``."""

    def __init__(self, cfg: dict, theta_rows, knn_idx, knn_w, counts, device, dtype):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.cap = capacity(cfg)
        self.theta = torch.as_tensor(np.asarray(theta_rows), device=device).to(dtype).clone()
        self.knn_idx = torch.as_tensor(np.asarray(knn_idx), dtype=torch.int64, device=device)
        self.knn_w = torch.as_tensor(np.asarray(knn_w), device=device).to(dtype)
        self.counts = torch.as_tensor(np.asarray(counts), dtype=torch.int64, device=device)
        self.cum_counts = torch.cumsum(self.counts, 0)
        self.total = int(self.counts.sum())

    def steps_per_epoch(self) -> int:
        cfg = self.cfg
        return cfg["steps_per_epoch"] or max(1, -(-cfg["n_points"] // cfg["batch_size"]))

    def step(self, gen, means, lr: float) -> float:
        cfg, th = self.cfg, self.theta
        B, S, n_noise = cfg["batch_size"], cfg["n_exact_negatives"], float(cfg["n_noise"])
        rows, cell, neg = sample_step_rows(gen, self.counts, self.cum_counts, self.total, B, self.cap, S)
        pos = self.knn_idx[rows]
        p_cell = self.counts.to(self.dtype) / float(cfg["n_points"])
        cell_w = n_noise * p_cell
        neg_w = (n_noise * p_cell[cell] / S)[:, None].expand(-1, S)
        th_i = th[rows].requires_grad_()
        th_pos = th[pos].requires_grad_()
        th_neg = th[neg].requires_grad_()
        with torch.enable_grad():
            loss = step_loss(th_i, th_pos, self.knn_w[rows], means, cell_w, cell, th_neg, neg_w)
            g_i, g_pos, g_neg = torch.autograd.grad(loss, (th_i, th_pos, th_neg))
        d = th.shape[1]
        th.index_add_(0, rows, g_i * -lr)
        th.index_add_(0, pos.reshape(-1), g_pos.reshape(-1, d) * -lr)
        th.index_add_(0, neg.reshape(-1), g_neg.reshape(-1, d) * -lr)
        return float(loss.detach())

    def epoch(self, seed: int, epoch: int, lr0: float, lr1: float, n_steps=None, on_step=None):
        """Steps of one epoch of the schedule (the first ``n_steps`` of
        them): means refreshed every ``mean_refresh_steps`` (default once,
        at the start), lr annealed linearly from lr0 towards lr1.
        ``on_step(t, loss, theta)`` sees each step's loss and θ after it."""
        steps = self.steps_per_epoch()
        refresh = self.cfg["mean_refresh_steps"] or steps
        means, losses = None, []
        for t in range(steps if n_steps is None else n_steps):
            if t % refresh == 0:
                means = local_means(self.theta, self.counts, self.cap).detach()
            lr = lr0 + (lr1 - lr0) * (t / steps)
            losses.append(self.step(seeded_generator(self.device, seed + 1, epoch, t), means, lr))
            if on_step is not None:
                on_step(t, losses[-1], self.theta)
        return losses


def epoch_lrs(cfg: dict, epoch: int):
    """(lr at the epoch's first step, lr its anneal heads for): lr0 = N/10
    unless set, annealed linearly to 0 over the fit's epochs."""
    lr0 = cfg["lr0"] if cfg["lr0"] > 0 else cfg["n_points"] / 10.0
    n = cfg["n_epochs"]
    return lr0 * (1.0 - epoch / n), lr0 * (1.0 - (epoch + 1) / n)


def epoch_from(cfg: dict, theta_rows, index: dict, seed: int, epoch: int, device, dtype, n_steps=None):
    """Epoch ``epoch`` of the schedule from ``theta_rows``: (its mean loss,
    θ after it as a float64 host array)."""
    st = TrainState(cfg, theta_rows, index["knn_idx"], index["knn_w"], index["counts"], device, dtype)
    losses = st.epoch(seed, epoch, *epoch_lrs(cfg, epoch), n_steps=n_steps)
    return float(np.mean(losses)), st.theta.detach().double().cpu().numpy()


# ---------------------------------------------------------------------------
# Index build (the control's)
# ---------------------------------------------------------------------------


def nearest(x, cents, block: int = 16384):
    """(argmin (N,), min d² (N,)) of each row over the centroids."""
    idx, dmin = [], []
    for s in range(0, x.shape[0], block):
        d2 = sq_dist(x[s : s + block], cents)
        v, i = d2.min(-1)
        idx.append(i)
        dmin.append(v)
    return torch.cat(idx), torch.cat(dmin)


def objective(x, cents, block: int = 16384) -> float:
    """k-means' objective at float64: the mean over the rows of the squared
    distance to the nearest centroid."""
    c = cents.double()
    total = 0.0
    for s in range(0, x.shape[0], block):
        total += float(sq_dist(x[s : s + block].double(), c).min(-1).values.sum())
    return total / x.shape[0]


def kmeans(x, K: int, n_iters: int, tol: float, gen, stats=None):
    """LSH-initialised Lloyd's EM; stops once the largest centroid shift
    falls under ``tol``, keeping the centroids from before that step.
    ``n_iters`` 0 returns the LSH seeding; ``stats["e_steps"]`` gets the
    number of E-steps run."""
    n, d = x.shape
    b = max(1, int(np.ceil(np.log2(K))))
    planes = torch.randn((d, b), generator=gen, device=x.device).to(x.dtype)
    codes = (((x @ planes) > 0).long() * (2 ** torch.arange(b, device=x.device))[None, :]).sum(1)
    nb = 2**b
    sums = torch.zeros((nb, d), dtype=x.dtype, device=x.device).index_add_(0, codes, x)
    cnts = torch.zeros((nb,), dtype=x.dtype, device=x.device).index_add_(0, codes, torch.ones_like(x[:, 0]))
    fallback = x[torch.randint(0, n, (K,), generator=gen, device=x.device)]
    top = torch.argsort(-cnts.float(), stable=True)[:K]
    cents = torch.where((cnts[top] > 0)[:, None], sums[top] / torch.clamp_min(cnts[top], 1.0)[:, None], fallback)
    for it in range(n_iters):
        if stats is not None:
            stats["e_steps"] = it + 1
        a, _ = nearest(x, cents)
        c = torch.zeros((K,), dtype=x.dtype, device=x.device).index_add_(0, a, torch.ones_like(x[:, 0]))
        new = torch.zeros_like(cents).index_add_(0, a, x) / torch.clamp_min(c, 1.0)[:, None]
        new = torch.where((c > 0)[:, None], new, cents)
        if float(((new - cents) ** 2).sum(-1).max()) < tol:
            break
        cents = new
    return cents


def admit(pick, d2, bidding, free):
    """Each centroid admits its ``free`` closest bidders (ties to the
    lower row)."""
    n = pick.shape[0]
    rows = torch.arange(n, device=pick.device)
    cand = rows[bidding]
    order = torch.argsort(d2[cand].float(), stable=True)
    cand = cand[order]
    cand = cand[torch.argsort(pick[cand], stable=True)]
    p = pick[cand]
    first = torch.searchsorted(p, p, right=False)
    rank = torch.arange(cand.shape[0], device=pick.device) - first
    ok = torch.zeros(n, dtype=torch.bool, device=pick.device)
    ok[cand[rank < free[p]]] = True
    return ok


def capacity_assign(x, cents, cap: int, n_cand: int, max_rounds: int, block: int = 16384):
    """Bidding over each row's ``n_cand`` nearest centroids for
    ``max_rounds`` rounds, then over all centroids until every row has a
    cell: each row ends in its nearest centroid that had room."""
    K = cents.shape[0]
    n = x.shape[0]
    R = min(n_cand, K)
    ci, cd = [], []
    for s in range(0, n, block):
        v, i = torch.topk(sq_dist(x[s : s + block], cents).float(), R, largest=False, sorted=True)
        ci.append(i)
        cd.append(v)
    cand_idx, cand_d2 = torch.cat(ci), torch.cat(cd)
    assign = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    free = torch.full((K,), cap, dtype=torch.int64, device=x.device)

    def rounds(idx, dd, rows, limit):
        for _ in range(limit):
            todo = assign[rows] < 0
            if not bool(todo.any()):
                return
            ok = free[idx] > 0
            has = ok.any(1)
            j = torch.argmax(ok.to(torch.uint8), 1)
            r = torch.arange(idx.shape[0], device=x.device)
            pick, d2 = idx[r, j], dd[r, j]
            bidding = todo & has
            if not bool(bidding.any()):
                return
            won = admit(pick, d2, bidding, free)
            assign[rows[won]] = pick[won]
            free.sub_(torch.bincount(pick[won], minlength=K))

    rounds(cand_idx, cand_d2, torch.arange(n, device=x.device), max_rounds)
    left = torch.nonzero(assign < 0).flatten()
    while left.numel():
        dd, idx = torch.sort(sq_dist(x[left], cents).float(), dim=-1, stable=True)
        rounds(idx, dd, left, 1 << 30)
        left = torch.nonzero(assign < 0).flatten()
    return assign


def rank_weights(d2, knn, k: int, valid):
    """Eq. 6: p(j|i) = e^{1/r}/Z with r the rank of i in j's ascending
    order (j itself rank 0), 0 past rank k or on padding."""
    order = torch.argsort(d2, dim=-2, stable=True)
    C = d2.shape[-1]
    ranks = torch.empty_like(order).scatter_(-2, order, torch.arange(C, device=d2.device)[:, None].expand(order.shape).contiguous())
    r = torch.gather(ranks, -1, knn)
    w = torch.exp(1.0 / torch.clamp_min(r.double(), 1.0)) / normalizer(k)
    w = torch.where((r >= 1) & (r <= k), w, 0.0)
    vj = torch.gather(valid, -1, knn.flatten(-2)).view(knn.shape)
    return torch.where(valid[..., :, None] & vj, w, 0.0)


def cells_per_block(cap: int, itemsize: int = 8, budget: float = 2e9) -> int:
    """How many cells' (cap, cap) distance blocks of ``itemsize`` bytes fit
    in ``budget`` bytes (at least one, at most 256)."""
    return int(max(1, min(256, budget // (cap * cap * itemsize))))


def cell_knn(x_rows, counts, cap: int, k: int):
    """Exact in-cell kNN (self and padding never chosen) and the Eq. 6
    weights; dead edges point at the row itself."""
    cells_per_chunk = cells_per_block(cap)
    K = counts.shape[0]
    D = x_rows.shape[1]
    xb = x_rows.view(K, cap, D)
    slots = torch.arange(cap, device=x_rows.device)
    idx_out, w_out = [], []
    for a in range(0, K, cells_per_chunk):
        blk = xb[a : a + cells_per_chunk]
        valid = slots[None, :] < counts[a : a + cells_per_chunk, None]
        d2 = sq_dist(blk, blk).float()
        pad = ~(valid[:, :, None] & valid[:, None, :])
        eye = torch.eye(cap, dtype=torch.bool, device=x_rows.device)[None]
        knn = torch.topk(torch.where(pad | eye, BIG, d2), k, largest=False, sorted=True).indices
        w = rank_weights(torch.where(pad, BIG, torch.where(eye, 0.0, d2)), knn, k, valid)
        base = (torch.arange(a, a + blk.shape[0], device=x_rows.device) * cap)[:, None, None]
        rows = (knn + base).reshape(-1, k)
        self_rows = (base + slots[None, :, None]).expand(-1, -1, k).reshape(-1, k)
        w = w.reshape(-1, k)
        idx_out.append(torch.where(w > 0, rows, self_rows))
        w_out.append(w)
    return torch.cat(idx_out), torch.cat(w_out)


def build(x: torch.Tensor, cfg: dict, seed: int, dtype) -> dict:
    """The whole index of ``x`` at ``dtype``; the arrays on the host."""
    K, cap, k = cfg["n_clusters"], capacity(cfg), cfg["n_neighbors"]
    xd = x.to(dtype)
    cents = kmeans(xd, K, cfg["kmeans_iters"], cfg["kmeans_tol"], seeded_generator(x.device, seed))
    assign = capacity_assign(xd, cents, cap, cfg["build_candidates"], cfg["build_max_rounds"])
    counts = torch.bincount(assign, minlength=K)
    order = torch.argsort(assign, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(x.shape[0], device=x.device) - starts[assign[order]]
    perm = torch.empty_like(assign)
    perm[order] = assign[order] * cap + slot
    x_rows = torch.zeros((K * cap, x.shape[1]), dtype=dtype, device=x.device)
    x_rows[perm] = xd
    knn_idx, knn_w = cell_knn(x_rows, counts, cap, k)
    return {
        "x_rows": x_rows.float().cpu().numpy(),
        "knn_idx": knn_idx.cpu().numpy(),
        "knn_w": knn_w.float().cpu().numpy(),
        "counts": counts.cpu().numpy(),
        "centroids": cents.float().cpu().numpy(),
        "perm": perm.cpu().numpy(),
    }


# ---------------------------------------------------------------------------
# Out-of-sample placement
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B
_SALT = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def _mix32(x):
    x = ((x >> 16) ^ x) * _MUL & _M32
    x = ((x >> 16) ^ x) * _MUL & _M32
    return (x >> 16) ^ x


def counter_hash(seed, row, t: int, s):
    """The port's per-row 32-bit hash of (seed, row, step, sample)."""
    h = _mix32((seed & _M32) ^ _SALT[0])
    h = _mix32(h ^ (row & _M32) ^ _SALT[1])
    h = _mix32(h ^ (int(t) & _M32) ^ _SALT[2])
    return _mix32(h ^ (s & _M32) ^ _SALT[3])


def negative_slots(seeds, rows, t: int, cnt, S: int):
    """Step t's S in-cell slots of each query: floor(u · count), u the top
    24 bits of the hash over 2^24."""
    s = torch.arange(S, device=seeds.device, dtype=torch.int64)
    h = counter_hash(seeds[:, None], rows[:, None], t, s[None, :]) >> 8
    return (h * cnt[:, None]) >> 24


def transform_lr(cfg: dict) -> float:
    if cfg["transform_lr"] > 0:
        return cfg["transform_lr"]
    lr0 = cfg["lr0"] if cfg["lr0"] > 0 else cfg["n_points"] / 10.0
    return lr0 / cfg["batch_size"] / max(cfg["n_epochs"], 1)


def annealed(lr0: float, t: int, steps: int) -> float:
    one = np.float32(1.0)
    return float(np.float32(lr0) * (one - np.float32(t) / np.float32(max(steps, 1))))


def place(cfg: dict, theta_rows, x_rows, counts, means, q, own, nb_rows, nb_valid, seeds, rows, dtype):
    """Placements (B, d) of queries ``q`` in cells ``own`` with neighbour
    rows ``nb_rows`` (B, k) (``nb_valid`` marks real ones): the
    Cauchy-weighted start, then ``transform_steps`` frozen steps."""
    cap = capacity(cfg)
    k, S, T, n_noise = cfg["n_neighbors"], cfg["n_exact_negatives"], cfg["transform_steps"], float(cfg["n_noise"])
    qd = q.to(dtype)
    nb = torch.where(nb_valid, nb_rows, 0)
    nb_x = x_rows[nb].to(dtype)
    nb_d2 = ((qd[:, None, :] - nb_x) ** 2).sum(-1)
    nb_theta = theta_rows[nb].to(dtype)
    w_rank = torch.exp(1.0 / torch.arange(1, k + 1, device=q.device, dtype=torch.float64)) / normalizer(k)
    nb_w = torch.where(nb_valid, w_rank[None, :].to(dtype), 0.0)
    w_init = torch.where(nb_valid, 1.0 / (1.0 + nb_d2), 0.0)
    w_init = w_init / torch.clamp_min(w_init.sum(-1, keepdim=True), 1e-12)
    theta = (w_init[:, :, None] * nb_theta).sum(1)
    p_cell = counts.to(dtype) / float(cfg["n_points"])
    cell_w = n_noise * p_cell
    cnt = torch.clamp_min(counts[own], 1)
    K = counts.shape[0]
    not_own = (own[:, None] != torch.arange(K, device=q.device)[None, :]).to(dtype)
    mu = means.to(dtype)
    th_all = theta_rows.to(dtype)
    lr0 = transform_lr(cfg)
    for t in range(T):
        slots = negative_slots(seeds, rows, t, cnt, S)
        th_neg = th_all[own[:, None] * cap + slots]
        th = theta.detach().requires_grad_()
        with torch.enable_grad():
            m_tilde = (cell_w[None, :] * not_own * cauchy_q(((th[:, None, :] - mu[None]) ** 2).sum(-1))).sum(-1)
            m_exact = (n_noise * p_cell[own] / S) * cauchy_q(((th[:, None, :] - th_neg) ** 2).sum(-1)).sum(-1)
            m = m_tilde + m_exact
            q_nb = cauchy_q(((th[:, None, :] - nb_theta) ** 2).sum(-1))
            loss = (nb_w * (torch.log(q_nb + m[:, None]) - torch.log(q_nb))).sum()
            (g,) = torch.autograd.grad(loss, th)
        theta = (theta - annealed(lr0, t, T) * g).detach()
    return theta


def cell_neighbors(x_rows, counts, cap: int, q, own, k: int, dtype):
    """Each query's k nearest rows of its cell: (rows (B, k), valid)."""
    D = x_rows.shape[1]
    blocks = x_rows.view(-1, cap, D)[own].to(dtype)
    d2 = ((q.to(dtype)[:, None, :] - blocks) ** 2).sum(-1).float()
    invalid = torch.arange(cap, device=q.device)[None, :] >= counts[own][:, None]
    slot = torch.topk(torch.where(invalid, BIG, d2), k, largest=False, sorted=True).indices
    valid = slot < counts[own][:, None]
    return own[:, None] * cap + slot, valid


def transform(cfg: dict, fz: dict, q, seeds, rows, dtype):
    """The whole placement at ``dtype`` (the control's): nearest centroid,
    kNN in its cell, then :func:`place`. ``fz`` holds the map's tensors
    (theta_rows, x_rows, counts, centroids, means) on the device."""
    own, _ = nearest(q.to(dtype), fz["centroids"].to(dtype))
    nb_rows, nb_valid = cell_neighbors(fz["x_rows"], fz["counts"], capacity(cfg), q, own, cfg["n_neighbors"], dtype)
    theta = place(cfg, fz["theta_rows"], fz["x_rows"], fz["counts"], fz["means"], q, own, nb_rows, nb_valid,
                  seeds, rows, dtype)
    return theta, own, nb_rows, nb_valid
