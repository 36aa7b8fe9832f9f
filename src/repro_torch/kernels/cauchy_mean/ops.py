"""K4 ``cauchy_mean``: the Cauchy-weighted sum over the K cluster means.

Replaces the TPU kernels ``src/repro/kernels/cauchy_mean/cauchy_mean.py``
(``cauchy_mean_fwd_pallas`` and ``cauchy_mean_bwd_pallas``) and their
custom VJP (``ops.py:_build_op``), hand-written for Hopper in
``csrc/cauchy_mean.cu`` over the walk of ``csrc/cauchy_walk.cuh``
(shared with K1's forward). Per head b, with q = 1/(1 + ‖θ_b − μ_r‖²):

    s_b  = Σ_r w_r·[r ≠ own_b]·q
    gθ_b = −2·ḡ_b·Σ_r w_r·[r ≠ own_b]·q²·(θ_b − μ_r)

:class:`CauchyMean` wraps the pair as a ``torch.autograd.Function`` whose
gradient reaches θ only, as the JAX VJP's does (the means are refreshed,
never learned). The serving step's M̃ term runs through it.

Bound on the card: d = 2, so B·K Cauchy terms: about 42 MFLOP on the CUDA
cores and B·K reciprocals on the SFU at the serving shape (B 1024, K 4096),
a microsecond of the card's rates. The kernel's grid is (head tile, K
chunk): :func:`plan` cuts the K means into at most ``MAX_CLUSTER``
contiguous chunks, from K alone, and the chunks of one head tile form a
thread-block cluster whose rank 0 sums their partials in ascending order.
So every head's sum is taken in one order whatever B is, and a head gives
the same bits in a batch of 512 as in one of 1024.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry

TOL = (1e-5, 1e-6)  # the JAX spec's (rtol, atol)
MAX_D = 4  # out dims the CUDA kernel is instantiated for
# csrc/cauchy_mean.cu's constants
TILE = 512  # means of a chunk, up to K = TILE·MAX_CLUSTER; staged at a time
MAX_CLUSTER = 8  # chunks of one head tile: the portable cluster size
HEADS = 16  # heads of one block
THREADS = 128


def split_means(K: int, chunk: int) -> tuple[int, int]:
    """(chunks, chunk_len): the K means cut into ``chunks`` contiguous
    chunks of ``chunk_len`` (a multiple of 32; the last chunk may be short,
    none is empty) for the walk of ``csrc/cauchy_walk.cuh``: one chunk of up
    to ``chunk`` means per block, up to MAX_CLUSTER chunks, longer chunks
    beyond. It takes no B and no card, because the chunks fix the order of
    each head's sum."""
    if K < 1:
        raise ValueError(f"plan: K={K} < 1")
    chunks = min(MAX_CLUSTER, -(-K // chunk))
    chunk_len = 32 * -(-K // (32 * chunks))
    return -(-K // chunk_len), chunk_len


def plan(K: int) -> tuple[int, int]:
    """K4's chunks: one TILE a block (8 chunks of 512 at K 4096). It
    depends on K alone, never on B or on the card."""
    return split_means(K, TILE)


def cauchy_mean_fwd_plain(th, mu, w, own):
    """s (B,) in the JAX oracle's op sequence (``ref.py``)."""
    d2 = torch.sum(torch.square(th[:, None, :] - mu[None, :, :]), -1)  # (B, K)
    q = 1.0 / (1.0 + d2)
    K = mu.shape[0]
    mask = own[:, None] != torch.arange(K, device=own.device, dtype=own.dtype)[None, :]
    return torch.sum(q * w[None, :] * mask, -1)


def cauchy_mean_bwd_plain(th, mu, w, own, gbar):
    """gθ (B, d) for upstream ``gbar`` (the oracle's ``vjp_ref``)."""
    diff = th[:, None, :] - mu[None, :, :]  # (B, K, d)
    q = 1.0 / (1.0 + torch.sum(torch.square(diff), -1))
    K = mu.shape[0]
    mask = own[:, None] != torch.arange(K, device=own.device, dtype=own.dtype)[None, :]
    factor = w[None, :] * mask * q * q
    return gbar[:, None] * (-2.0) * torch.einsum("bk,bkd->bd", factor, diff)


def _check(name, th, mu, w, own, **extra):
    device = registry.require_cuda(name, theta=th, means=mu, cell_w=w, own_cell=own, **extra)
    registry.require_dtype(name, torch.float32, theta=th, means=mu, cell_w=w, **extra)
    registry.require_dtype(name, torch.int32, own_cell=own)
    if th.dim() != 2 or mu.dim() != 2 or th.shape[1] != mu.shape[1]:
        raise ValueError(f"{name}: want θ (B, d) and μ (K, d), got {tuple(th.shape)}, {tuple(mu.shape)}")
    B, d = th.shape
    K = mu.shape[0]
    if tuple(w.shape) != (K,) or tuple(own.shape) != (B,):
        raise ValueError(f"{name}: cell_w must be ({K},) and own_cell ({B},)")
    for label, t in extra.items():
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name}: {label} must be ({B},)")
    if B < 1 or K < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: B={B}, K={K}, d={d} outside the kernel (B, K ≥ 1, 1 ≤ d ≤ {MAX_D})")
    return device, (B, K, d)


def cauchy_mean_fwd_cuda(th, mu, w, own):
    device, (B, K, d) = _check("cauchy_mean_fwd", th, mu, w, own)
    out = torch.empty((B,), dtype=torch.float32, device=device)
    lib = _build.load("cauchy_mean")
    with torch.cuda.device(device):
        err = lib.cauchy_mean_fwd_f32(
            th.data_ptr(), mu.data_ptr(), w.data_ptr(), own.data_ptr(), out.data_ptr(),
            B, K, d, *plan(K), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "cauchy_mean_fwd")
    registry.count_launch(FWD)
    return out


def cauchy_mean_bwd_cuda(th, mu, w, own, gbar):
    device, (B, K, d) = _check("cauchy_mean_bwd", th, mu, w, own, gbar=gbar)
    gth = torch.empty_like(th)
    lib = _build.load("cauchy_mean")
    with torch.cuda.device(device):
        err = lib.cauchy_mean_bwd_f32(
            th.data_ptr(), mu.data_ptr(), w.data_ptr(), own.data_ptr(), gbar.data_ptr(),
            gth.data_ptr(), B, K, d, *plan(K), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "cauchy_mean_bwd")
    registry.count_launch(BWD)
    return gth


class CauchyMean(torch.autograd.Function):
    """s (B,); differentiable in θ only."""

    @staticmethod
    def forward(ctx, th, mu, w, own):
        ctx.save_for_backward(th, mu, w, own)
        return registry.dispatch("cauchy_mean_fwd", th, mu, w, own)

    @staticmethod
    def backward(ctx, gbar):
        gth = registry.dispatch("cauchy_mean_bwd", *ctx.saved_tensors, gbar.float().contiguous())
        return gth, None, None, None


def cauchy_weighted_sum(theta_i, means, cell_w, own_cell):
    """s_b = Σ_r cell_w[r]·[own_cell[b] ≠ r]·q(θ_b, μ_r); inputs cast to
    fp32 (own to int32) and made contiguous, as the JAX op's ``_prep`` does."""
    f = lambda t: t.float().contiguous()  # noqa: E731
    return CauchyMean.apply(
        f(theta_i), f(means.detach()), f(cell_w.detach()), own_cell.to(torch.int32).contiguous()
    )


FWD = registry.register(
    registry.Kernel(
        name="cauchy_mean_fwd",
        plain=cauchy_mean_fwd_plain,
        cuda=cauchy_mean_fwd_cuda,
        source="src/repro_torch/csrc/cauchy_mean.cu",
        replaces="src/repro/kernels/cauchy_mean/cauchy_mean.py:83",
    )
)
BWD = registry.register(
    registry.Kernel(
        name="cauchy_mean_bwd",
        plain=cauchy_mean_bwd_plain,
        cuda=cauchy_mean_bwd_cuda,
        source="src/repro_torch/csrc/cauchy_mean.cu",
        replaces="src/repro/kernels/cauchy_mean/cauchy_mean.py:104",
    )
)


# ---------------------------------------------------------------------------
# Registry specs: the JAX spec's shapes, tolerance and (forward) cost model.
# The plan is :func:`plan`'s split of the means, from K alone: it fixes the
# order of each head's sum, so it is the only one offered.
# ---------------------------------------------------------------------------


def _sig(B, K, d, dt="float32"):
    return (((B, d), dt), ((K, d), dt), ((K,), dt), ((B,), "int32"))


CHECK_SHAPES = (_sig(512, 1024, 2), _sig(100, 64, 2), _sig(64, 100, 3), _sig(777, 333, 2))
BENCH_SHAPE = _sig(2048, 2048, 2)


def _fwd_inputs(gen, sig):
    (ts, tdt), (ms, _), (ws, _), (os_, _) = sig
    return (registry.draw(gen, ts, tdt, scale=3.0), registry.draw(gen, ms, tdt, scale=3.0),
            registry.draw(gen, ws, tdt, uniform=True), registry.draw(gen, os_, "int32", high=ms[0]))


def _bwd_inputs(gen, sig):
    th, mu, w, own = _fwd_inputs(gen, sig)
    return th, mu, w, own, registry.draw(gen, (th.shape[0],), "float32")


def _fwd_cost(sig):
    (B, d) = sig[0][0]
    K = sig[1][0][0]
    return {"flops": float(B) * K * (3 * d + 4), "bytes": 4.0 * (B * d + K * d + K + 2 * B)}


def _bwd_cost(sig):
    (B, d) = sig[0][0]
    K = sig[1][0][0]
    return {"flops": float(B) * K * (5 * d + 6), "bytes": 4.0 * (2 * B * d + K * d + K + 2 * B)}


def _walk_plan(sig) -> dict:
    chunks, chunk_len = plan(sig[1][0][0])
    return {"chunks": chunks, "chunk_len": chunk_len}


for _name, _plain, _cuda, _inputs, _cost in (
    ("cauchy_mean_fwd", cauchy_mean_fwd_plain, cauchy_mean_fwd_cuda, _fwd_inputs, _fwd_cost),
    ("cauchy_mean_bwd", cauchy_mean_bwd_plain, cauchy_mean_bwd_cuda, _bwd_inputs, _bwd_cost),
):
    _entry, _candidates, _default_plan = registry.fixed_plan(_cuda, _walk_plan)
    registry.register_spec(registry.KernelSpec(
        name=_name, reference="cauchy_mean", plain=_plain, cuda=_entry, plan_candidates=_candidates,
        default_plan=_default_plan, make_inputs=_inputs, check_shapes=CHECK_SHAPES, bench_shapes=BENCH_SHAPE,
        tol=TOL, cost_model=_cost,
    ))
