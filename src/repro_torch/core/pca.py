"""PCA initialisation (paper §3.4): exact eigendecomposition of the D×D
covariance, rescaled so each output dim has std ``scale``.

Only the exact branch (D ≤ ``max_exact_dim``) is ported; the paper's
corpora are 768–1024-d. The fp32 products run in full fp32 (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import torch


def pca_init(x: torch.Tensor, out_dim: int = 2, scale: float = 1e-4, max_exact_dim: int = 2048):
    x = x.float()
    D = x.shape[1]
    if D > max_exact_dim:
        raise NotImplementedError(
            f"pca_init: D={D} > {max_exact_dim} needs the randomized branch, not ported yet"
        )
    xc = x - torch.mean(x, 0, keepdim=True)
    cov = (xc.T @ xc) / x.shape[0]
    _evals, evecs = torch.linalg.eigh(cov)
    comps = torch.flip(evecs, dims=(1,))[:, :out_dim]  # eigh is ascending
    proj = xc @ comps
    std = torch.std(proj, 0, keepdim=True, correction=0)
    return proj / torch.clamp_min(std, 1e-12) * scale
