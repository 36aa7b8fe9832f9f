"""K5 ``frozen_attract``: a query's attraction to its k frozen neighbours.

Replaces the TPU kernels ``src/repro/kernels/frozen_attract/frozen_attract.py``
(``frozen_attract_fwd_pallas`` and ``frozen_attract_bwd_pallas``) and their
custom VJP (``ops.py:_build_op``), hand-written for Hopper in
``csrc/frozen_attract.cu``. Per query b, with d² = ‖θ_b − nb_bs‖² and
q = 1/(1 + d²):

    loss_b = Σ_s w_bs·(log(q + m_b) + log1p(d²))
    gθ_b   = 2·ḡ_b·Σ_s w_bs·(q − q²/(q + m_b))·(θ_b − nb_bs)
    gm_b   = ḡ_b·Σ_s w_bs/(q + m_b)

:class:`FrozenAttract` wraps the pair as a ``torch.autograd.Function``
whose gradients reach θ and m only: the neighbours and their weights are
the frozen map, so a query can never move it.

Bound on the card: bytes, about 200 KB a launch at the serving shape
(B 1024, k 15, d 2), 0.06 µs at the card's memory rate and far below the
~0.85 µs an empty launch of the kernel takes, so a launch gains only by
cutting its threads' latency. The kernel spreads a query's k neighbours over
:func:`plan`'s lanes of one warp (16 at k = 15): one pass of coalesced
loads covers a query, each lane sums its neighbours s ≡ lane (mod lanes)
in order and the group's xor butterfly adds the lanes. The lanes follow
k alone, so a query's bits do not depend on B.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry

TOL = (1e-5, 1e-6)  # the JAX spec's (rtol, atol)
MAX_D = 4  # out dims the CUDA kernel is instantiated for
# csrc/frozen_attract.cu's constants
THREADS = 256
MAX_LANES = 32  # a query's lanes lie in one warp


def plan(k: int) -> int:
    """Lanes a query: the least power of two ≥ k, at most MAX_LANES (16 at
    k = 15; past 32 neighbours a lane takes several). It fixes the order of
    each query's sums, so it takes k alone, never B or the card."""
    if k < 1:
        raise ValueError(f"plan: k={k} < 1")
    return min(MAX_LANES, 1 << (k - 1).bit_length())


def frozen_attract_fwd_plain(th, nb, w, m):
    """loss (B,) in the JAX oracle's op sequence (``ref.py``)."""
    d2 = torch.sum(torch.square(th[:, None, :] - nb), -1)  # (B, k)
    q = 1.0 / (1.0 + d2)
    return torch.sum(w * (torch.log(q + m[:, None]) + torch.log1p(d2)), -1)


def frozen_attract_bwd_plain(th, nb, w, m, gbar):
    """(gθ (B, d), gm (B,)) for upstream ``gbar`` (the oracle's ``vjp_ref``)."""
    diff = th[:, None, :] - nb  # (B, k, d)
    q = 1.0 / (1.0 + torch.sum(torch.square(diff), -1))
    qm = q + m[:, None]
    factor = w * (q - q * q / qm)
    g_theta = 2.0 * gbar[:, None] * torch.einsum("bk,bkd->bd", factor, diff)
    return g_theta, gbar * torch.sum(w / qm, -1)


def _check(name, th, nb, w, m, **extra):
    device = registry.require_cuda(name, theta=th, nbrs=nb, w=w, m=m, **extra)
    registry.require_dtype(name, torch.float32, theta=th, nbrs=nb, w=w, m=m, **extra)
    if th.dim() != 2 or nb.dim() != 3:
        raise ValueError(f"{name}: want θ (B, d) and nbrs (B, k, d), got {tuple(th.shape)}, {tuple(nb.shape)}")
    B, d = th.shape
    k = nb.shape[1]
    if tuple(nb.shape) != (B, k, d) or tuple(w.shape) != (B, k) or tuple(m.shape) != (B,):
        raise ValueError(
            f"{name}: want nbrs ({B}, k, {d}), w ({B}, k), m ({B},), got "
            f"{tuple(nb.shape)}, {tuple(w.shape)}, {tuple(m.shape)}"
        )
    for label, t in extra.items():
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name}: {label} must be ({B},)")
    if B < 1 or k < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: B={B}, k={k}, d={d} outside the kernel (B, k ≥ 1, 1 ≤ d ≤ {MAX_D})")
    return device, (B, k, d)


def frozen_attract_fwd_cuda(th, nb, w, m):
    device, (B, k, d) = _check("frozen_attract_fwd", th, nb, w, m)
    loss = torch.empty((B,), dtype=torch.float32, device=device)
    lib = _build.load("frozen_attract")
    with torch.cuda.device(device):
        err = lib.frozen_attract_fwd_f32(
            th.data_ptr(), nb.data_ptr(), w.data_ptr(), m.data_ptr(), loss.data_ptr(),
            B, k, d, plan(k), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "frozen_attract_fwd")
    registry.count_launch(FWD)
    return loss


def frozen_attract_bwd_cuda(th, nb, w, m, gbar):
    device, (B, k, d) = _check("frozen_attract_bwd", th, nb, w, m, gbar=gbar)
    gth = torch.empty_like(th)
    gm = torch.empty_like(m)
    lib = _build.load("frozen_attract")
    with torch.cuda.device(device):
        err = lib.frozen_attract_bwd_f32(
            th.data_ptr(), nb.data_ptr(), w.data_ptr(), m.data_ptr(), gbar.data_ptr(),
            gth.data_ptr(), gm.data_ptr(), B, k, d, plan(k),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "frozen_attract_bwd")
    registry.count_launch(BWD)
    return gth, gm


class FrozenAttract(torch.autograd.Function):
    """loss (B,); differentiable in θ and m only."""

    @staticmethod
    def forward(ctx, th, nb, w, m):
        ctx.save_for_backward(th, nb, w, m)
        return registry.dispatch("frozen_attract_fwd", th, nb, w, m)

    @staticmethod
    def backward(ctx, gbar):
        gth, gm = registry.dispatch("frozen_attract_bwd", *ctx.saved_tensors, gbar.float().contiguous())
        return gth, None, None, gm


def frozen_attract(theta_q, nbrs, w, m):
    """Per-query loss (B,) over the frozen kNN; inputs cast to fp32 and made
    contiguous, as the JAX op's ``_prep`` does."""
    f = lambda t: t.float().contiguous()  # noqa: E731
    return FrozenAttract.apply(f(theta_q), f(nbrs.detach()), f(w.detach()), f(m))


FWD = registry.register(
    registry.Kernel(
        name="frozen_attract_fwd",
        plain=frozen_attract_fwd_plain,
        cuda=frozen_attract_fwd_cuda,
        source="src/repro_torch/csrc/frozen_attract.cu",
        replaces="src/repro/kernels/frozen_attract/frozen_attract.py:71",
    )
)
BWD = registry.register(
    registry.Kernel(
        name="frozen_attract_bwd",
        plain=frozen_attract_bwd_plain,
        cuda=frozen_attract_bwd_cuda,
        source="src/repro_torch/csrc/frozen_attract.cu",
        replaces="src/repro/kernels/frozen_attract/frozen_attract.py:92",
    )
)


# ---------------------------------------------------------------------------
# Registry specs: the JAX spec's shapes, tolerance and (forward) cost model.
# The plan is :func:`plan`'s lanes a query, from k alone: it fixes the
# order of each query's sums, so it is the only one offered.
# ---------------------------------------------------------------------------


def _sig(B, k, d, dt="float32"):
    return (((B, d), dt), ((B, k, d), dt), ((B, k), dt), ((B,), dt))


CHECK_SHAPES = (_sig(512, 15, 2), _sig(64, 8, 2), _sig(100, 5, 3), _sig(777, 15, 2))
BENCH_SHAPE = _sig(2048, 15, 2)


def _fwd_inputs(gen, sig):
    (ts, tdt), (ns, _), (ws, _), (ms, _) = sig
    return (registry.draw(gen, ts, tdt, scale=3.0), registry.draw(gen, ns, tdt, scale=3.0),
            registry.draw(gen, ws, tdt, uniform=True), registry.draw(gen, ms, tdt, uniform=True) * 5.0)


def _bwd_inputs(gen, sig):
    th, nb, w, m = _fwd_inputs(gen, sig)
    return th, nb, w, m, registry.draw(gen, (th.shape[0],), "float32")


def _fwd_cost(sig):
    (B, d) = sig[0][0]
    k = sig[2][0][1]
    return {"flops": float(B) * k * (3 * d + 12), "bytes": 4.0 * (B * d + B * k * d + B * k + 2 * B)}


def _bwd_cost(sig):
    (B, d) = sig[0][0]
    k = sig[2][0][1]
    return {"flops": float(B) * k * (5 * d + 14), "bytes": 4.0 * (2 * B * d + B * k * d + B * k + 4 * B)}


for _name, _plain, _cuda, _inputs, _cost in (
    ("frozen_attract_fwd", frozen_attract_fwd_plain, frozen_attract_fwd_cuda, _fwd_inputs, _fwd_cost),
    ("frozen_attract_bwd", frozen_attract_bwd_plain, frozen_attract_bwd_cuda, _bwd_inputs, _bwd_cost),
):
    _entry, _candidates, _default_plan = registry.fixed_plan(_cuda, lambda sig: {"lanes": plan(sig[1][0][1])})
    registry.register_spec(registry.KernelSpec(
        name=_name, reference="frozen_attract", plain=_plain, cuda=_entry, plan_candidates=_candidates,
        default_plan=_default_plan, make_inputs=_inputs, check_shapes=CHECK_SHAPES, bench_shapes=BENCH_SHAPE,
        tol=TOL, cost_model=_cost,
    ))
