"""PCA initialisation (paper §3.4), rescaled so each output dim has std
``scale``.

Exact eigendecomposition of the D×D covariance for D ≤ ``max_exact_dim``;
beyond it the JAX package's randomized range-finder (4 power iterations,
each re-orthonormalised by QR, then the SVD of ``xc @ q``). Its start
matrix is drawn from a CPU ``torch.Generator`` seeded 17 and then moved to
the device, so the card and the CPU start from the same matrix.
:func:`pca_init_streamed` runs both branches over an on-disk store one
chunk at a time. The fp32 products run in full fp32 (PyTorch's default,
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import numpy as np
import torch

RANGE_SEED = 17  # the JAX package's jax.random.key(17)
POWER_ITERS = 4
OVERSAMPLE = 8


def range_start(D: int, out_dim: int, device) -> torch.Tensor:
    """The randomized branch's (D, out_dim + 8) start matrix."""
    gen = torch.Generator().manual_seed(RANGE_SEED)
    return torch.randn((D, out_dim + OVERSAMPLE), generator=gen).to(device)


def _top_components(evecs: torch.Tensor, out_dim: int) -> torch.Tensor:
    return torch.flip(evecs, dims=(1,))[:, :out_dim]  # eigh is ascending


def _rescale(proj: torch.Tensor, scale: float) -> torch.Tensor:
    std = torch.std(proj, 0, keepdim=True, correction=0)
    return proj / torch.clamp_min(std, 1e-12) * scale


def pca_init(x: torch.Tensor, out_dim: int = 2, scale: float = 1e-4, max_exact_dim: int = 2048):
    x = x.float()
    D = x.shape[1]
    xc = x - torch.mean(x, 0, keepdim=True)
    if D <= max_exact_dim:
        cov = (xc.T @ xc) / x.shape[0]
        _evals, evecs = torch.linalg.eigh(cov)
        comps = _top_components(evecs, out_dim)
    else:  # randomized power iteration
        q = range_start(D, out_dim, x.device)
        for _ in range(POWER_ITERS):
            q, _ = torch.linalg.qr(xc.T @ (xc @ q))
        _, _, vt = torch.linalg.svd(xc @ q, full_matrices=False)
        comps = (q @ vt.T)[:, :out_dim]
    return _rescale(xc @ comps, scale)


def pca_init_streamed(store, out_dim: int = 2, scale: float = 1e-4, chunk_rows: int = 0,
                      max_exact_dim: int = 2048, *, device=None) -> np.ndarray:
    """:func:`pca_init` over a :class:`repro_torch.data.store.EmbeddingStore`,
    on ``device`` (default: the card).

    Never materialises the corpus: a streamed pass sums the mean, a second
    the D×D covariance (or, beyond ``max_exact_dim``, one streamed pass per
    power iteration and one for ``xc @ q``), and a last one projects; only
    the (N, out_dim) projection lives on the host. Chunk boundaries depend
    only on (N, chunk_rows), so two stores holding the same rows give
    bit-identical inits. Returns the (N, out_dim) float32 init.
    """
    from repro_torch.data.store import DEFAULT_CHUNK_ROWS
    from repro_torch.index.build import resolve_device
    from repro_torch.index.kmeans import device_chunks

    device = resolve_device(device)
    n, D = store.shape
    chunk_rows = max(1, min(chunk_rows or DEFAULT_CHUNK_ROWS, n))

    def chunks():
        return device_chunks(store, chunk_rows, device)

    acc = torch.zeros((D,), dtype=torch.float32, device=device)
    for _s, xb, w in chunks():
        acc += torch.sum(xb * w[:, None], 0)
    mu = acc[None, :] / n

    if D <= max_exact_dim:
        cov = torch.zeros((D, D), dtype=torch.float32, device=device)
        for _s, xb, w in chunks():
            xc = (xb - mu) * w[:, None]
            cov += xc.T @ xc
        _evals, evecs = torch.linalg.eigh(cov / n)
        comps = _top_components(evecs, out_dim)
    else:  # randomized power iteration, one streamed pass per iteration
        q = range_start(D, out_dim, device)
        for _ in range(POWER_ITERS):
            acc_q = torch.zeros_like(q)
            for _s, xb, w in chunks():
                xc = (xb - mu) * w[:, None]
                acc_q += xc.T @ (xc @ q)
            q, _ = torch.linalg.qr(acc_q)
        b = torch.empty((n, q.shape[1]), dtype=torch.float32, device=device)
        for s, xb, w in chunks():
            rows = min(chunk_rows, n - s)
            b[s : s + rows] = ((xb - mu) @ q)[:rows]
        _, _, vt = torch.linalg.svd(b, full_matrices=False)
        del b
        comps = (q @ vt.T)[:, :out_dim]

    proj = torch.empty((n, out_dim), dtype=torch.float32, device=device)
    for s, xb, _w in chunks():
        rows = min(chunk_rows, n - s)
        proj[s : s + rows] = ((xb - mu) @ comps)[:rows]
    return _rescale(proj, scale).cpu().numpy()
