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


def pairwise_dist2_cuda(x: torch.Tensor, y: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """The kernel. The route is the shape's (:func:`route`); on the tile
    route ``plan`` ``{"tile": 64 | 128}`` picks the block tile, by default
    the autotuner's (:func:`repro_torch.kernels.autotune.plan_for`: a
    cached winner, else :func:`tile_for`'s). Each output's sum over D runs
    in the same order under both tiles, so the plan never changes a bit."""
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
    if plan is None and way == "tile":
        from repro_torch.kernels import autotune

        plan = autotune.plan_for(SPEC, registry.shape_sig((x, y)), device=device)
    if plan and plan.get("tile") not in (64, 128):
        raise ValueError(f"pairwise: plan {plan}, want {{}} or a tile of 64 or 128")
    tile = ((plan or {}).get("tile") or tile_for(n, m)) if way == "tile" else 0
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


# ---------------------------------------------------------------------------
# Registry spec (the JAX spec's shapes, tolerance and cost model)
# ---------------------------------------------------------------------------


def _sig(n, m, d, dt="float32"):
    return (((n, d), dt), ((m, d), dt))


def _dims(sig):
    (xs, _), (ys, _) = sig
    return (1,) * (3 - len(xs)) + tuple(xs[:-2]) + (xs[-2], ys[-2], xs[-1])  # (batch, n, m, d)


def plan_candidates(sig) -> tuple:
    """The tile route's two block tiles; the row route has one plan (it and
    the tile route add in different orders, so they are not swept)."""
    b, n, m, d = _dims(sig)
    return ({},) if route(b, n, m, d) == "row" else ({"tile": 64}, {"tile": 128})


def default_plan(sig, device=None) -> dict:
    b, n, m, d = _dims(sig)
    return {} if route(b, n, m, d) == "row" else {"tile": tile_for(n, m)}


def _make_inputs(gen, sig):
    (xs, xdt), (ys, ydt) = sig
    return registry.draw(gen, xs, xdt), registry.draw(gen, ys, ydt)


def _oracle_check(args, got, want):
    """The spec's (rtol, atol); at D ≥ 768 :func:`allowed_error` as well."""
    x, y = args
    bound = SPEC_TOL[1] + SPEC_TOL[0] * want.abs()
    if x.shape[-1] >= 768:
        bound = torch.maximum(bound, allowed_error(x, y))
    err = (got - want).abs()
    if not bool(torch.all(err <= bound)):
        raise AssertionError(f"pairwise: max |Δ| {float(err.max())} past the bound")


def _cost_model(sig):
    _b, n, m, d = _dims(sig)
    return {"flops": 2.0 * n * m * d + 4.0 * n * m, "bytes": 4.0 * (n * d + m * d + n * m)}


SPEC = registry.register_spec(
    registry.KernelSpec(
        name="pairwise",
        reference="pairwise",
        plain=pairwise_dist2_plain,
        cuda=pairwise_dist2_cuda,
        plan_candidates=plan_candidates,
        default_plan=default_plan,
        make_inputs=_make_inputs,
        check_shapes=(_sig(96, 128, 64), _sig(100, 60, 33), _sig(8, 257, 128), _sig(64, 64, 16, "bfloat16")),
        bench_shapes=_sig(1024, 1024, 256),
        tol=SPEC_TOL,
        oracle_check=_oracle_check,
        cost_model=_cost_model,
    )
)
