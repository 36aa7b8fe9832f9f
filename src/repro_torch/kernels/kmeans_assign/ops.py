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


def assign_nearest_cuda(x: torch.Tensor, cents: torch.Tensor):
    device = registry.require_cuda("kmeans_assign", x=x, cents=cents)
    registry.require_dtype("kmeans_assign", torch.float32, x=x, cents=cents)
    if x.dim() != 2 or cents.dim() != 2 or x.shape[1] != cents.shape[1]:
        raise ValueError(f"kmeans_assign: want (N, D) × (K, D), got {tuple(x.shape)} × {tuple(cents.shape)}")
    n, d = x.shape
    k = cents.shape[0]
    if min(n, k, d) < 1:
        raise ValueError(f"kmeans_assign: empty input {tuple(x.shape)} × {tuple(cents.shape)}")
    chunks, chunk_cols = plan(n, k, _sm_count(device))
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
