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
from repro_torch.kernels import registry  # noqa: E402
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


@pytest.mark.parametrize("shape", [(100, 60, 33), (8, 257, 128)])
def test_pairwise_kernel_matches_plain(card, shape):
    n, m, d = shape
    g = torch.Generator(device=card).manual_seed(0)
    x, y = _randn(g, n, d, device=card), _randn(g, m, d, device=card)
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


@pytest.mark.parametrize("shape", [(100, 5, 4, 33, 2), (64, 3, 8, 100, 3)])
def test_nomad_step_kernels_match_plain(card, shape):
    B, k, S, K, d = shape
    g = torch.Generator(device=card).manual_seed(2)
    args = (
        _randn(g, B, d, device=card, scale=3.0), _randn(g, B, k, d, device=card, scale=3.0),
        torch.rand((B, k), generator=g, device=card), _randn(g, B, S, d, device=card, scale=3.0),
        torch.rand((B, S), generator=g, device=card), _randn(g, K, d, device=card, scale=3.0),
        torch.rand((K,), generator=g, device=card),
        torch.randint(0, K, (B,), generator=g, device=card, dtype=torch.int32),
    )
    gbar = torch.full((B,), 1.0 / B, device=card)
    loss, m = nomad_ops.nomad_step_fwd_cuda(*args)
    loss_p, m_p = nomad_ops.nomad_step_fwd_plain(*args)
    torch.testing.assert_close(loss, loss_p, rtol=nomad_ops.TOL[0], atol=nomad_ops.TOL[1])
    torch.testing.assert_close(m, m_p, rtol=nomad_ops.TOL[0], atol=nomad_ops.TOL[1])
    for got, want in zip(nomad_ops.nomad_step_bwd_cuda(*args, m, gbar),
                         nomad_ops.nomad_step_bwd_plain(*args, m_p, gbar)):
        torch.testing.assert_close(got, want, rtol=nomad_ops.TOL[0], atol=nomad_ops.TOL[1])


def test_fit_on_card_is_deterministic_and_uses_the_kernels(card):
    x, _ = gaussian_mixture(2000, 16, n_components=4, seed=1)
    cfg = NomadConfig(n_points=2000, dim=16, n_clusters=4, n_neighbors=15, n_noise=32,
                      n_exact_negatives=8, batch_size=512, n_epochs=3)
    registry.reset_launch_counts()
    r1 = NomadProjection(cfg, device=card).fit(x)
    assert all(c > 0 for c in registry.launch_counts().values())
    r2 = NomadProjection(cfg, device=card).fit(x)
    np.testing.assert_array_equal(r1.embedding, r2.embedding)
