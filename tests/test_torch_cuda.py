"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (decided in a
fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import NomadConfig  # noqa: E402
from repro_torch.core.nomad import NomadProjection  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.serve import transform as serve_transform  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.cauchy_mean import ops as cauchy_ops  # noqa: E402
from repro_torch.kernels.frozen_attract import ops as attract_ops  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops  # noqa: E402
from repro_torch.kernels.nomad_step import ops as nomad_ops  # noqa: E402
from repro_torch.kernels.pairwise import ops as pairwise_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _randn(g, *shape, device, scale=1.0):
    return torch.randn(shape, generator=g, device=device) * scale


@pytest.mark.parametrize("shape", [(100, 60, 33), (8, 257, 128), (16, 1, 70, 33)])
def test_pairwise_kernel_matches_plain(card, shape):
    """Unbatched, and batched with x and y apart (serving's query kNN)."""
    *lead, n, m, d = shape
    g = torch.Generator(device=card).manual_seed(0)
    x, y = _randn(g, *lead, n, d, device=card), _randn(g, *lead, m, d, device=card)
    before = registry.get("pairwise").launches
    got = pairwise_ops.pairwise_dist2_cuda(x, y)
    assert registry.get("pairwise").launches == before + 1
    torch.testing.assert_close(got, pairwise_ops.pairwise_dist2_plain(x, y),
                               rtol=pairwise_ops.SPEC_TOL[0], atol=pairwise_ops.SPEC_TOL[1])


@pytest.mark.parametrize("shape", [(1000, 17, 32), (513, 255, 48)])
def test_kmeans_assign_kernel_matches_plain(card, shape):
    n, k, d = shape
    g = torch.Generator(device=card).manual_seed(1)
    x, c = _randn(g, n, d, device=card), _randn(g, k, d, device=card)
    kmeans_ops.oracle_check(x, c, kmeans_ops.assign_nearest_cuda(x, c), kmeans_ops.assign_nearest_plain(x, c))


def test_kmeans_assign_rows_do_not_depend_on_the_call(card):
    """1024 rows (centroids split into chunks) give, for their first 512,
    the bits that 512 rows alone give (another chunk count)."""
    g = torch.Generator(device=card).manual_seed(5)
    x, c = _randn(g, 1024, 768, device=card), _randn(g, 4096, 768, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert kmeans_ops.plan(512, 4096, sms) != kmeans_ops.plan(1024, 4096, sms)
    arg, mind = kmeans_ops.assign_nearest_cuda(x, c)
    arg_h, mind_h = kmeans_ops.assign_nearest_cuda(x[:512].contiguous(), c)
    assert torch.equal(arg[:512], arg_h) and torch.equal(mind[:512], mind_h)


@pytest.mark.parametrize("n", [1024, 16384])
def test_kmeans_assign_ties_keep_the_lower_index(card, n):
    """Centroids duplicated across chunk boundaries: rows at or next to
    them get the lower index, as torch.argmin does."""
    g = torch.Generator(device=card).manual_seed(6)
    c = _randn(g, 4096, 64, device=card)
    c[2053] = c[5]
    c[4095] = c[0]
    lower = torch.tensor([5, 0], device=card).repeat(n // 2)
    x = c[lower] + 1e-3 * (torch.arange(n, device=card) % 4 >= 2).float()[:, None] * _randn(g, n, 64, device=card)
    arg, _ = kmeans_ops.assign_nearest_cuda(x, c)
    assert torch.equal(arg.long(), lower)


def test_pairwise_row_route_matches_plain(card):
    """Serving's query shape, x ≠ y, takes the row route and holds K3's
    bound at D = 768."""
    g = torch.Generator(device=card).manual_seed(7)
    x, y = _randn(g, 64, 1, 768, device=card), _randn(g, 64, 305, 768, device=card)
    assert pairwise_ops.route(64, 1, 305, 768) == "row"
    got = pairwise_ops.pairwise_dist2_cuda(x, y)
    assert bool(torch.all((got - pairwise_ops.pairwise_dist2_plain(x, y)).abs() <= pairwise_ops.allowed_error(x, y)))


@pytest.mark.parametrize("d,offset", [(33, 33), (64, 1)])
def test_kernels_take_unaligned_rows(card, d, offset):
    """Inputs whose base pointer is not 16-byte aligned (offset by one
    d = 33 row, or by one float at d = 64) take the 4-byte cp.async copies
    of the tile and the scalar walk of the row route."""
    g = torch.Generator(device=card).manual_seed(8)

    def shifted(*shape):
        flat = _randn(g, int(np.prod(shape)) + offset, device=card)
        return flat[offset:].view(*shape)

    x, c = shifted(300, d), shifted(200, d)
    assert x.data_ptr() % 16 != 0
    kmeans_ops.oracle_check(x, c, kmeans_ops.assign_nearest_cuda(x, c), kmeans_ops.assign_nearest_plain(x, c))
    for xs, ys in ((x[:100], c[:60]), (shifted(4, 2, d), shifted(4, 70, d))):
        torch.testing.assert_close(pairwise_ops.pairwise_dist2_cuda(xs, ys), pairwise_ops.pairwise_dist2_plain(xs, ys),
                                   rtol=pairwise_ops.SPEC_TOL[0], atol=pairwise_ops.SPEC_TOL[1])


def _nomad_args(g, B, k, S, K, d, device):
    """θ, θpos, pw, θneg, nw, μ, cw and own as the JAX spec draws them."""
    return (
        _randn(g, B, d, device=device, scale=3.0), _randn(g, B, k, d, device=device, scale=3.0),
        torch.rand((B, k), generator=g, device=device), _randn(g, B, S, d, device=device, scale=3.0),
        torch.rand((B, S), generator=g, device=device), _randn(g, K, d, device=device, scale=3.0),
        torch.rand((K,), generator=g, device=device),
        torch.randint(0, K, (B,), generator=g, device=device, dtype=torch.int32),
    )


@pytest.mark.parametrize("shape", [(100, 5, 4, 33, 2), (64, 3, 8, 100, 3), (512, 15, 16, 64, 2),
                                   (777, 15, 16, 130, 2), (8192, 15, 16, 4096, 2),
                                   (33, 2, 3, 40, 1), (64, 5, 4, 50, 4)])
def test_nomad_step_kernels_match_plain(card, shape):
    """The spec's four shapes (one chunk), the fit's step (two chunks,
    one cluster) and d = 1 and 4 (a record of two float4s), forward with
    far and backward from it. At K = 4096 atol
    is scaled by the output's largest magnitude, as chip_smoke.py holds the
    main shape: a sum over 4096 signed terms rounds with their magnitudes."""
    B, k, S, K, d = shape
    g = torch.Generator(device=card).manual_seed(2)
    args = _nomad_args(g, B, k, S, K, d, card)
    gbar = torch.full((B,), 1.0 / B, device=card)
    loss, m, far = nomad_ops.nomad_step_fwd_cuda(*args, want_far=True)
    loss_p, m_p, far_p = nomad_ops.nomad_step_fwd_plain(*args, want_far=True)
    got = (loss, m, far, *nomad_ops.nomad_step_bwd_cuda(*args[:5], m, far, gbar))
    want = (loss_p, m_p, far_p, *nomad_ops.nomad_step_bwd_plain(*args[:5], m_p, far_p, gbar))
    for label, a, w in zip(("loss", "m", "far", "g_i", "g_pos", "g_neg"), got, want):
        atol = nomad_ops.TOL[1] * (float(w.abs().max()) if K > 130 else 1.0)
        torch.testing.assert_close(a, w, rtol=nomad_ops.TOL[0], atol=atol, msg=label)
    loss_n, m_n, far_n = nomad_ops.nomad_step_fwd_cuda(*args)  # no gradient wanted
    assert far_n is None and torch.equal(loss_n, loss) and torch.equal(m_n, m)


def test_nomad_step_rows_do_not_depend_on_the_batch(card):
    """Rows [0, 4096) of an 8192-head call are the bits of a 4096-head
    call, forward and backward: the K split follows K alone."""
    g = torch.Generator(device=card).manual_seed(11)
    args = _nomad_args(g, 8192, 15, 16, 4096, 2, card)
    gbar = torch.rand((8192,), generator=g, device=card)
    half = [a[:4096].contiguous() if i in (0, 1, 2, 3, 4, 7) else a for i, a in enumerate(args)]
    full_f = nomad_ops.nomad_step_fwd_cuda(*args, want_far=True)
    half_f = nomad_ops.nomad_step_fwd_cuda(*half, want_far=True)
    full_b = nomad_ops.nomad_step_bwd_cuda(*args[:5], *full_f[1:], gbar)
    half_b = nomad_ops.nomad_step_bwd_cuda(*half[:5], *half_f[1:], gbar[:4096].contiguous())
    for a, b in zip((*full_f, *full_b), (*half_f, *half_b)):
        assert torch.equal(a[:4096], b)


def test_fit_on_card_is_deterministic_and_uses_the_kernels(card):
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    cfg = NomadConfig(n_points=2000, dim=16, n_clusters=4, n_neighbors=15, n_noise=32,
                      n_exact_negatives=8, batch_size=512, n_epochs=3)
    registry.reset_launch_counts()
    r1 = NomadProjection(cfg, device=card).fit(x)
    counts = registry.launch_counts()
    assert all(counts[n] > 0 for n in ("nomad_step_fwd", "nomad_step_bwd", "kmeans_assign", "pairwise"))
    r2 = NomadProjection(cfg, device=card).fit(x)
    np.testing.assert_array_equal(r1.embedding, r2.embedding)


# ---------------------------------------------------------------------------
# The epoch's step replayed as a CUDA graph (core/nomad.py:StepGraph)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pubmed_widths():
    """An index of ~60k rows at PubMed's step widths (k 15, S 16, B 1024,
    K 64) built on the card, and a θ start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.index.build import IndexBuilder

    cfg = NomadConfig(n_points=60000, dim=32, n_clusters=64, n_neighbors=15, n_noise=128,
                      n_exact_negatives=16, batch_size=1024, n_epochs=2)
    x, _ = gaussian_mixture(cfg.n_points, cfg.dim, n_components=64, seed=5)
    index = IndexBuilder(cfg, device=torch.device("cuda", 0)).build(x)
    theta0 = np.random.default_rng(0).normal(size=(index.n_clusters * index.capacity, 2)).astype(np.float32)
    return cfg, index, theta0


def _epochs(card, cfg, index, theta0, make, method, graphed, replace_at=None):
    """Per epoch of the schedule: (θ, mean loss, the launch counts' growth,
    the step counters), through ``make()``'s strategy, its graph dropped
    when not ``graphed``; θ's storage replaced before epoch ``replace_at``."""
    from repro_torch.core import trace

    s = make()
    theta = s.prepare(cfg, method, index, theta0, card)
    if not graphed:
        s.graph = None
    lr0, out = cfg.resolved_lr0(), []
    for e in range(cfg.n_epochs):
        if e == replace_at:
            theta = theta.clone()
        before = registry.launch_counts()
        trace.reset()
        theta, loss = s.run_epoch(theta, e, lr0 * (1 - e / cfg.n_epochs), lr0 * (1 - (e + 1) / cfg.n_epochs))
        torch.cuda.synchronize()
        grew = {n: c - before[n] for n, c in registry.launch_counts().items()}
        out.append((theta.clone(), loss, grew, trace.counts(), s))
    return out


def _steps_counted(counts):
    return counts.get("nomad.step.eager", 0), counts.get("nomad.step.graphed", 0)


@pytest.mark.parametrize("strategy,method,refresh", [("local", "nomad", 0), ("local", "infonc", 0),
                                                     ("partial", "nomad", 0), ("local", "nomad", 5)])
def test_graphed_epochs_equal_eager_epochs_bit_for_bit(card, pubmed_widths, strategy, method, refresh):
    """The first epoch (warm-up, capture, replays) and the second (replays
    only) give the eager epochs' θ and mean loss bit for bit, and count
    the eager epochs' launches."""
    from repro_torch.core.strategy import LocalStrategy, PartialRefineStrategy

    cfg, index, theta0 = pubmed_widths
    cfg = cfg.replace(mean_refresh_steps=refresh)
    make = LocalStrategy if strategy == "local" else lambda: PartialRefineStrategy(np.arange(0, 64, 8))
    eager = _epochs(card, cfg, index, theta0, make, method, graphed=False)
    graphed = _epochs(card, cfg, index, theta0, make, method, graphed=True)
    steps = graphed[0][4].steps
    assert steps > graphed[0][4].graph.WARMUP
    assert not torch.equal(eager[-1][0].cpu(), torch.from_numpy(theta0))
    for e, ((th_e, loss_e, grew_e, _, _), (th_g, loss_g, grew_g, _, _)) in enumerate(zip(eager, graphed)):
        assert torch.equal(th_e, th_g), e
        assert loss_e == loss_g, e
        assert grew_e == grew_g, e
        assert grew_g["nomad_step_fwd"] == (steps if method == "nomad" else 0)
    warm = graphed[0][4].graph.WARMUP
    assert [_steps_counted(g[3]) for g in graphed] == [(warm, steps - warm), (0, steps)]
    assert [_steps_counted(e[3]) for e in eager] == [(steps, 0), (steps, 0)]


def test_the_step_is_captured_again_after_theta_is_replaced(card, pubmed_widths):
    from repro_torch.core.strategy import LocalStrategy

    cfg, index, theta0 = pubmed_widths
    eager = _epochs(card, cfg, index, theta0, LocalStrategy, "nomad", graphed=False, replace_at=1)
    graphed = _epochs(card, cfg, index, theta0, LocalStrategy, "nomad", graphed=True, replace_at=1)
    for (th_e, loss_e, _, _, _), (th_g, loss_g, _, _, _) in zip(eager, graphed):
        assert torch.equal(th_e, th_g) and loss_e == loss_g
    s = graphed[-1][4]
    warm = s.graph.WARMUP
    assert [_steps_counted(g[3]) for g in graphed] == [(warm, s.steps - warm)] * 2


def _cauchy_args(g, B, K, d, device):
    """θ, μ, w, own and ḡ as the JAX spec draws them."""
    return (_randn(g, B, d, device=device, scale=3.0), _randn(g, K, d, device=device, scale=3.0),
            torch.rand((K,), generator=g, device=device),
            torch.randint(0, K, (B,), generator=g, device=device, dtype=torch.int32),
            torch.rand((B,), generator=g, device=device))


def _assert_cauchy_close(got, want, K):
    """The spec's (1e-5, 1e-6). Past the spec's largest K (1024), atol is
    scaled by the output's largest magnitude, as chip_smoke.py holds the
    serving shape: a sum over K = 4096 signed terms rounds with the summed
    magnitudes, not with the cancelled result."""
    atol = cauchy_ops.TOL[1] * (float(want.abs().max()) if K > 1024 else 1.0)
    torch.testing.assert_close(got, want, rtol=cauchy_ops.TOL[0], atol=atol)


@pytest.mark.parametrize("shape", [(100, 64, 2), (64, 100, 3), (777, 333, 2), (1024, 4096, 2)])
def test_cauchy_mean_kernels_match_plain(card, shape):
    """The spec's ragged shapes (one chunk) and serving's (8 chunks, one
    cluster)."""
    K = shape[1]
    g = torch.Generator(device=card).manual_seed(3)
    *args, gbar = _cauchy_args(g, *shape, card)
    _assert_cauchy_close(cauchy_ops.cauchy_mean_fwd_cuda(*args), cauchy_ops.cauchy_mean_fwd_plain(*args), K)
    _assert_cauchy_close(cauchy_ops.cauchy_mean_bwd_cuda(*args, gbar), cauchy_ops.cauchy_mean_bwd_plain(*args, gbar), K)


def test_cauchy_mean_rows_do_not_depend_on_the_batch(card):
    """Rows [0, 512) of a 1024-head call are the bits of a 512-head call,
    forward and backward: the K split follows K alone."""
    g = torch.Generator(device=card).manual_seed(9)
    th, mu, w, own, gbar = _cauchy_args(g, 1024, 4096, 2, card)
    half = (th[:512].contiguous(), mu, w, own[:512].contiguous())
    assert torch.equal(cauchy_ops.cauchy_mean_fwd_cuda(th, mu, w, own)[:512], cauchy_ops.cauchy_mean_fwd_cuda(*half))
    assert torch.equal(cauchy_ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar)[:512],
                       cauchy_ops.cauchy_mean_bwd_cuda(*half, gbar[:512].contiguous()))


def test_cauchy_mean_own_at_chunk_boundaries(card):
    """Heads whose own cell is the first or last mean of a chunk, or of K,
    drop exactly that term. Each head sits 0.1 from its own mean, so a term
    kept or dropped in error (q ≈ 1) would be far outside the tolerance."""
    K = 4096
    _, chunk_len = cauchy_ops.plan(K)
    g = torch.Generator(device=card).manual_seed(10)
    _, mu, w, _, gbar = _cauchy_args(g, 1024, K, 2, card)
    edges = torch.tensor([0, chunk_len - 1, chunk_len, K - 1], device=card, dtype=torch.int32)
    own = edges.repeat(1024 // 4)
    th = mu[own.long()] + _randn(g, 1024, 2, device=card, scale=0.1)
    _assert_cauchy_close(cauchy_ops.cauchy_mean_fwd_cuda(th, mu, w, own), cauchy_ops.cauchy_mean_fwd_plain(th, mu, w, own), K)
    _assert_cauchy_close(cauchy_ops.cauchy_mean_bwd_cuda(th, mu, w, own, gbar),
                         cauchy_ops.cauchy_mean_bwd_plain(th, mu, w, own, gbar), K)


def _attract_args(g, B, k, d, device):
    """θ, nb, w, m and ḡ as the JAX spec draws them."""
    return (_randn(g, B, d, device=device, scale=3.0), _randn(g, B, k, d, device=device, scale=3.0),
            torch.rand((B, k), generator=g, device=device), torch.rand((B,), generator=g, device=device) * 5.0,
            torch.rand((B,), generator=g, device=device))


@pytest.mark.parametrize("shape", [(64, 8, 2), (100, 5, 3), (512, 15, 2), (777, 15, 2), (1024, 15, 2),
                                   (32, 1, 2), (64, 40, 4), (50, 15, 1), (60, 15, 4)])
def test_frozen_attract_kernels_match_plain(card, shape):
    """The spec's four shapes, serving's (16 lanes a query), k = 1 (one
    lane), k = 40 (two neighbours a lane past the warp's 32), and d = 1
    and 4, within the spec's (1e-5, 1e-6)."""
    B, k, d = shape
    g = torch.Generator(device=card).manual_seed(4)
    *args, gbar = _attract_args(g, B, k, d, card)
    tol = dict(rtol=attract_ops.TOL[0], atol=attract_ops.TOL[1])
    before = registry.get("frozen_attract_fwd").launches
    torch.testing.assert_close(attract_ops.frozen_attract_fwd_cuda(*args), attract_ops.frozen_attract_fwd_plain(*args), **tol)
    assert registry.get("frozen_attract_fwd").launches == before + 1
    for got, want in zip(attract_ops.frozen_attract_bwd_cuda(*args, gbar),
                         attract_ops.frozen_attract_bwd_plain(*args, gbar)):
        torch.testing.assert_close(got, want, **tol)


def test_frozen_attract_rows_do_not_depend_on_the_batch(card):
    """Rows [0, 512) of a 1024-query call are the bits of a 512-query call,
    forward and backward: the lanes a query follow k alone."""
    g = torch.Generator(device=card).manual_seed(12)
    th, nb, w, m, gbar = _attract_args(g, 1024, 15, 2, card)
    half = (th[:512].contiguous(), nb[:512].contiguous(), w[:512].contiguous(), m[:512].contiguous())
    assert torch.equal(attract_ops.frozen_attract_fwd_cuda(th, nb, w, m)[:512],
                       attract_ops.frozen_attract_fwd_cuda(*half))
    for full, part in zip(attract_ops.frozen_attract_bwd_cuda(th, nb, w, m, gbar),
                          attract_ops.frozen_attract_bwd_cuda(*half, gbar[:512].contiguous())):
        assert torch.equal(full[:512], part)


def _tied_rows(g, n, dim, device, levels=3):
    """Integer-valued rows, each drawn row duplicated once: their
    distances are exact on the card (K3's split keeps small integers
    whole) and on the CPU, so they tie alike."""
    half = torch.randint(0, levels, (n - n // 2, dim), generator=g, device=device).float()
    rows = torch.cat([half, half[: n // 2]])
    return rows[torch.randperm(n, generator=g, device=device)].contiguous()


@pytest.mark.parametrize("way", ["smallest_k_by_sort", "smallest_k_by_topk"])
def test_smallest_k_on_card_is_the_cpu_order(card, way):
    """Both ways of ``jax.lax.top_k``'s order on 64 × 300 integer-valued
    distances with signed zeros: the CPU's order (``jax.lax.top_k``'s,
    ``tests/test_torch_index.py``), whatever CUDA's sort and ``torch.topk``
    do with ties."""
    from repro_torch.index import knn

    g = torch.Generator().manual_seed(0)
    d = torch.randint(0, 4, (64, 300), generator=g).float()
    d[(d == 0) & (torch.rand(d.shape, generator=g) < 0.5)] = -0.0
    want_v, want_i = getattr(knn, way)(d, 15)
    got_v, got_i = getattr(knn, way)(d.to(card), 15)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu().view(torch.int32), want_v.view(torch.int32))


def test_top_k_sites_on_card_keep_the_cpu_ties(card):
    """In-cell kNN, serving's query kNN and the candidate pass on data with
    duplicated integer rows: the card gives the CPU's indices in the CPU's
    order (which are the JAX package's, ``tests/test_torch_index.py``)."""
    from repro_torch.index import build
    from repro_torch.index.knn import batched_cluster_knn, query_cluster_knn

    g = torch.Generator().manual_seed(1)
    blocks = torch.stack([_tied_rows(g, 48, 5, "cpu") for _ in range(4)])
    valid = torch.arange(48)[None, :] < torch.tensor([48, 40, 25, 11])[:, None]
    want = batched_cluster_knn(blocks, valid, 10)
    got = batched_cluster_knn(blocks.to(card), valid.to(card), 10)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-6, atol=0)

    counts = torch.tensor([48, 33, 9], dtype=torch.int32)
    own = torch.randint(0, 3, (90,), generator=g, dtype=torch.int32)
    q = blocks[own.long(), torch.randint(0, 9, (90,), generator=g)]
    q[1::3] = torch.randint(0, 3, (30, 5), generator=g).float()
    want = query_cluster_knn(q, own, blocks[:3], counts, 15, block=32)
    got = query_cluster_knn(q.to(card), own.to(card), blocks[:3].to(card), counts.to(card), 15, block=32)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)

    cents = _tied_rows(g, 64, 6, "cpu")
    x = torch.cat([cents[torch.randint(0, 64, (150,), generator=g)],
                   torch.randint(0, 3, (150, 6), generator=g).float()])
    want = build.candidate_pass(x, cents, 12, 128)
    got = build.candidate_pass(x.to(card), cents.to(card), 12, 128)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_negative_slots_same_on_card_and_cpu(card):
    seeds = torch.tensor([0, 5, 2**32 - 1], dtype=torch.int64)
    rows = torch.tensor([0, 7, 2**31], dtype=torch.int64)
    cnt = torch.tensor([1, 300, 17], dtype=torch.int64)
    cpu = serve_transform.sample_negative_slots(seeds, rows, 3, cnt, 16)
    gpu = serve_transform.sample_negative_slots(seeds.to(card), rows.to(card), 3, cnt.to(card), 16)
    assert torch.equal(gpu.cpu(), cpu)


def test_serving_on_card_is_batch_invariant_and_uses_the_kernels(card):
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    q, _ = gaussian_mixture(300, 16, n_components=4, seed=7)
    cfg = NomadConfig(n_points=2000, dim=16, n_clusters=4, n_neighbors=10, n_noise=16,
                      n_exact_negatives=4, batch_size=256, n_epochs=3, serve_microbatch=128,
                      transform_steps=6)
    est = NomadProjection(cfg, device=card)
    est.fit(x)
    registry.reset_launch_counts()
    a = est.map_server(microbatch=64).transform(q, seed=0)
    counts = registry.launch_counts()
    for name in ("kmeans_assign", "cauchy_mean_fwd", "cauchy_mean_bwd", "frozen_attract_fwd", "frozen_attract_bwd"):
        assert counts[name] > 0, name
    b = est.map_server(microbatch=256).transform(q, seed=0)
    np.testing.assert_array_equal(a.embedding, b.embedding)
