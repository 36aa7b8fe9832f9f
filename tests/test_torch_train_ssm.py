"""The port's training step against the JAX package's for the two SSM
architectures, Mamba-2 and Jamba (Mamba-2 + attention + MoE), at
``reduced(...)`` size: ``make_loss_fn``'s loss, ce and aux, then the
gradients and an SGD step of ``make_train_step`` with one and two
microbatches. The helpers, tolerances and their reasons are
``tests/test_torch_train.py``'s; the SSD scan's ``clip(−60, 0)`` meets its
upper bound exactly on the diagonal (cum_i − cum_i), where JAX splits a
tie's gradient and ``torch.clamp`` passes it whole, but the two
contributions to cum_i cancel either way.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_train import SSM_ARCHS, check_loss_fn_against_reference, check_step_against_reference  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than a pool, and
    keeps the module from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_loss_fn_matches_jax(name):
    check_loss_fn_against_reference(name)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_train_step_matches_jax(name, accum):
    check_step_against_reference(name, accum)
