"""K2 ``kmeans_assign``: the fused k-means E-step (distance + running argmin).

Replaces the TPU kernel ``src/repro/kernels/kmeans_assign/kmeans_assign.py``
(``assign_nearest_pallas``), hand-written for Hopper in
``csrc/kmeans_assign.cu`` over the 3xTF32 tensor-core tile of
``csrc/tf32x3_tile.cuh``.

Bound on the card: 2·N·K·D flops against (N + K)·D words in and 2·N out,
so the tensor cores bound it at the main-path shape (16384-row blocks
against 4096 centroids, D = 768). Each block owns 128 rows and walks a
contiguous chunk of the centroids, keeping the running (min, argmin) in
registers: the (N, K) distance matrix is never written, which is the point
of the fusion. Where ``ceil(N/128)`` blocks cannot fill the card (serving's
1024-row batches), :func:`plan` splits the centroids into chunks and a
second kernel reduces the per-chunk partials in ascending order; the split
never crosses D, so the result is the unsplit one bit for bit. The 3xTF32
product is fp32-accurate (``tests/test_torch_tf32x3.py`` emulates it);
ties keep the lowest centroid index. The oracle check
(:func:`oracle_check`, the JAX spec's rule) accepts any
distance-equivalent choice within 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, registry

TOL = (1e-4, 1e-4)


def assign_nearest_plain(x: torch.Tensor, cents: torch.Tensor):
    """x (N, D), cents (K, D) → (assign (N,) int32, min_d2 (N,) fp32)."""
    d2 = (
        torch.sum(torch.square(x), -1)[:, None]
        + torch.sum(torch.square(cents), -1)[None, :]
        - 2.0 * (x @ cents.T)
    )
    d2 = torch.clamp_min(d2, 0.0)
    return torch.argmin(d2, -1).to(torch.int32), torch.amin(d2, -1)


TILE = 128  # rows and centroids of one block tile (csrc/kmeans_assign.cu)


def plan(n: int, k: int, sms: int) -> tuple[int, int]:
    """(chunks, chunk_cols): split the K centroids into ``chunks``
    contiguous chunks of ``chunk_cols`` (a multiple of TILE; the last may
    be short) so that ceil(n/TILE) × chunks blocks, one an SM, finish
    soonest. Minimises waves × tiles walked per block, then the chunk
    count, so a call that already fills the card is not split."""
    row_blocks = -(-n // TILE)
    col_tiles = -(-k // TILE)
    best = None
    for c in range(1, col_tiles + 1):
        per_block = -(-col_tiles // c)
        chunks = -(-col_tiles // per_block)  # no empty chunk
        cost = -(-row_blocks * chunks // sms) * per_block
        if best is None or cost < best[0]:
            best = (cost, chunks, per_block * TILE)
    return best[1], best[2]


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_plan(k: int, chunks: int) -> tuple[int, int]:
    """(chunks, chunk_cols) for a request of ``chunks`` chunks: whole tiles
    a chunk, none empty. For :func:`plan`'s own chunk count it gives back
    :func:`plan`'s split."""
    col_tiles = -(-k // TILE)
    per_block = -(-col_tiles // max(1, min(chunks, col_tiles)))
    return -(-col_tiles // per_block), per_block * TILE


def assign_nearest_cuda(x: torch.Tensor, cents: torch.Tensor, plan: dict | None = None):
    """The kernel; ``plan`` ``{"chunks": c}`` splits the centroids into c
    chunks, by default the autotuner's
    (:func:`repro_torch.kernels.autotune.plan_for`: a cached winner, else
    :func:`plan`'s for this card). Min and argmin are exact and the
    partials reduce in chunk order, so every plan gives the same bits."""
    device = registry.require_cuda("kmeans_assign", x=x, cents=cents)
    registry.require_dtype("kmeans_assign", torch.float32, x=x, cents=cents)
    if x.dim() != 2 or cents.dim() != 2 or x.shape[1] != cents.shape[1]:
        raise ValueError(f"kmeans_assign: want (N, D) × (K, D), got {tuple(x.shape)} × {tuple(cents.shape)}")
    n, d = x.shape
    k = cents.shape[0]
    if min(n, k, d) < 1:
        raise ValueError(f"kmeans_assign: empty input {tuple(x.shape)} × {tuple(cents.shape)}")
    if plan is None:
        from repro_torch.kernels import autotune

        plan = autotune.plan_for(SPEC, registry.shape_sig((x, cents)), device=device)
    chunks, chunk_cols = chunk_plan(k, plan["chunks"])
    arg = torch.empty((n,), dtype=torch.int32, device=device)
    mind = torch.empty((n,), dtype=torch.float32, device=device)
    # per-(chunk, row) partials, only when the centroids are split
    part_arg = torch.empty((chunks * n if chunks > 1 else 0,), dtype=torch.int32, device=device)
    part_min = torch.empty((chunks * n if chunks > 1 else 0,), dtype=torch.float32, device=device)
    lib = _build.load("kmeans_assign")
    with torch.cuda.device(device):
        err = lib.kmeans_assign_f32(
            x.data_ptr(), cents.data_ptr(), part_arg.data_ptr(), part_min.data_ptr(),
            arg.data_ptr(), mind.data_ptr(), n, k, d, chunks, chunk_cols,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "kmeans_assign")
    registry.count_launch(KERNEL)
    return arg, mind


def assign_nearest(x: torch.Tensor, cents: torch.Tensor):
    """Nearest centroid per row through the registry (inputs cast to fp32)."""
    return registry.dispatch(
        "kmeans_assign", x.float().contiguous(), cents.float().contiguous()
    )


def oracle_check(x, cents, got, want, tol=TOL) -> None:
    """Argmin ties may break differently: the minimum distances must agree
    and the chosen centroid must be distance-equivalent (the JAX spec's
    ``_oracle_check``). Arguments may be tensors or arrays."""
    a_got, d_got = (np.asarray(_host(got[0])), np.asarray(_host(got[1])))
    a_want, d_want = (np.asarray(_host(want[0])), np.asarray(_host(want[1])))
    np.testing.assert_allclose(d_got, d_want, rtol=tol[0], atol=tol[1])
    xf = np.asarray(_host(x), np.float32)
    cf = np.asarray(_host(cents), np.float32)
    d_of_got = np.sum(np.square(xf - cf[a_got]), axis=-1)
    d_of_want = np.sum(np.square(xf - cf[a_want]), axis=-1)
    np.testing.assert_allclose(d_of_got, d_of_want, rtol=tol[0], atol=tol[1])


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


KERNEL = registry.register(
    registry.Kernel(
        name="kmeans_assign",
        plain=assign_nearest_plain,
        cuda=assign_nearest_cuda,
        source="src/repro_torch/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign/kmeans_assign.py:53",
    )
)


# ---------------------------------------------------------------------------
# Registry spec (the JAX spec's shapes, tolerance and cost model)
# ---------------------------------------------------------------------------


def _sig(n, k, d, dt="float32"):
    return (((n, d), dt), ((k, d), dt))


def plan_candidates(sig) -> tuple:
    """Chunk counts 1, 2, 4, … up to one tile a chunk (at most 64), as
    :func:`chunk_plan` makes them."""
    k = sig[1][0][0]
    col_tiles = -(-k // TILE)
    counts = sorted({chunk_plan(k, 1 << i)[0] for i in range(7) if (1 << i) <= col_tiles})
    return tuple({"chunks": c} for c in counts)


def default_plan(sig, device=None) -> dict:
    n, k = sig[0][0][0], sig[1][0][0]
    # off the card (the CPU tests), an H100's 132 SMs stand in for the count
    sms = _sm_count(device) if device is not None and torch.device(device).type == "cuda" else 132
    return {"chunks": plan(n, k, sms)[0]}


def _make_inputs(gen, sig):
    (xs, xdt), (cs, cdt) = sig
    return registry.draw(gen, xs, xdt), registry.draw(gen, cs, cdt)


def _cost_model(sig):
    (n, d) = sig[0][0]
    k = sig[1][0][0]
    return {"flops": 2.0 * n * k * d + 2.0 * n * k, "bytes": 4.0 * (n * d + k * d + 2 * n)}


SPEC = registry.register_spec(
    registry.KernelSpec(
        name="kmeans_assign",
        reference="kmeans_assign",
        plain=assign_nearest_plain,
        cuda=assign_nearest_cuda,
        plan_candidates=plan_candidates,
        default_plan=default_plan,
        make_inputs=_make_inputs,
        check_shapes=(_sig(512, 256, 64), _sig(1000, 17, 32), _sig(64, 512, 128), _sig(513, 255, 48)),
        bench_shapes=_sig(4096, 256, 128),
        tol=TOL,
        oracle_check=lambda args, got, want: oracle_check(*args, got, want),
        cost_model=_cost_model,
    )
)
