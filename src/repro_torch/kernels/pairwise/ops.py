"""K3 ``pairwise``: blocked squared distances ‖x‖² + ‖y‖² − 2·x·yᵀ, clamped ≥ 0.

Replaces the TPU kernel ``src/repro/kernels/pairwise/pairwise.py``
(``pairwise_dist2_pallas``), hand-written for Hopper in
``csrc/pairwise.cu``. Two routes, picked by :func:`route` from the shape:

* ``tile`` (N ≥ 16: a 16384-row block against 4096 centroids, 305-row
  cells against themselves, D = 768): 2·N·M·D flops on far fewer words,
  so the tensor cores bound it. The 3xTF32 tile of ``csrc/tf32x3_tile.cuh``
  (fp32-accurate, see ``tests/test_torch_tf32x3.py``) with a 128×128 or
  64×64 block tile (:func:`tile_for`, the one that pads less), the row
  norms summed in the same pass, each output written once; the optional
  leading batch dimension runs all cells of a kNN chunk in one launch.
* ``row`` (N < 16: serving's query kNN, one query against its cell): bound
  by reading y once. One warp per y row, IEEE fp32 in a fixed order, so a
  query's distances depend on that query and its cell alone.

Tolerance: the kernel and the plain version add the D products in
different orders (and the tile route in three TF32 parts). At the JAX
spec's check shapes the spec's ``(rtol, atol) = (2e-5, 2e-5)`` holds. At
D = 768 the rounding error of the expansion scales with the magnitudes
summed, ‖x‖² + ‖y‖², not with the result, which for near neighbours on the
unit sphere is far smaller than either; :func:`allowed_error` states that
bound.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry

SPEC_TOL = (2e-5, 2e-5)
SCALED_RTOL = 2e-5  # × (‖x‖² + ‖y‖²), see the module docstring


def pairwise_dist2_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(…, N, D) × (…, M, D) → (…, N, M) fp32, the JAX oracle's op sequence."""
    x2 = torch.sum(torch.square(x), -1)
    y2 = torch.sum(torch.square(y), -1)
    d2 = x2[..., :, None] + y2[..., None, :] - 2.0 * (x @ y.transpose(-1, -2))
    return torch.clamp_min(d2, 0.0)


ROW_MAX = 15  # the row route takes up to this many x rows (csrc/pairwise.cu)
GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def route(batch: int, n: int, m: int, d: int) -> str:
    """``"row"`` for a few x rows a batch (serving's query kNN), else
    ``"tile"``."""
    return "row" if n <= ROW_MAX else "tile"


def tile_for(n: int, m: int) -> int:
    """The tile route's block tile, 128 or 64 square: 128 unless its
    padding costs more than an eighth over 64's (a 305-row cell pads to
    384² at 128 but 320² at 64)."""
    padded = lambda t: -(-n // t) * t * (-(-m // t) * t)  # noqa: E731
    return 128 if padded(128) <= 1.125 * padded(64) else 64


def pairwise_dist2_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    device = registry.require_cuda("pairwise", x=x, y=y)
    registry.require_dtype("pairwise", torch.float32, x=x, y=y)
    if x.dim() != y.dim() or x.dim() not in (2, 3):
        raise ValueError(f"pairwise: want (N, D) × (M, D) or (B, N, D) × (B, M, D), got {tuple(x.shape)} × {tuple(y.shape)}")
    xb = x if x.dim() == 3 else x[None]
    yb = y if y.dim() == 3 else y[None]
    bsz, n, d = xb.shape
    m = yb.shape[1]
    if yb.shape[0] != bsz or yb.shape[2] != d:
        raise ValueError(f"pairwise: mismatched shapes {tuple(x.shape)} × {tuple(y.shape)}")
    way = route(bsz, n, m, d)
    tile = tile_for(n, m) if way == "tile" else 0
    if min(bsz, n, m, d) < 1 or bsz > GRID_YZ or (way == "tile" and -(-m // tile) > GRID_YZ):
        raise ValueError(f"pairwise: shape {tuple(x.shape)} × {tuple(y.shape)} outside the kernel's grid")
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=device)
    lib = _build.load("pairwise")
    with torch.cuda.device(device):
        err = lib.pairwise_dist2_f32(
            xb.data_ptr(), yb.data_ptr(), out.data_ptr(), bsz, n, m, d,
            0 if way == "tile" else 1, tile, torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "pairwise")
    registry.count_launch(KERNEL)
    return out if x.dim() == 3 else out[0]


def pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances, fp32, through the registry (inputs cast to fp32)."""
    return registry.dispatch(
        "pairwise", x.float().contiguous(), y.float().contiguous()
    )


def allowed_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel − plain| at any depth: SCALED_RTOL ×
    (‖x‖² + ‖y‖²) plus the spec's atol."""
    x2 = torch.sum(torch.square(x.float()), -1)
    y2 = torch.sum(torch.square(y.float()), -1)
    return SCALED_RTOL * (x2[..., :, None] + y2[..., None, :]) + SPEC_TOL[1]


KERNEL = registry.register(
    registry.Kernel(
        name="pairwise",
        plain=pairwise_dist2_plain,
        cuda=pairwise_dist2_cuda,
        source="src/repro_torch/csrc/pairwise.cu",
        replaces="src/repro/kernels/pairwise/pairwise.py:59",
    )
)
