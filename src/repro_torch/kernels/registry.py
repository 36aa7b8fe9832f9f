"""Kernel registry: one seam between the port's callers and its kernels.

Every hand-written kernel registers a :class:`Kernel` holding its plain
PyTorch version and its CUDA wrapper. :func:`dispatch` picks by the device
of the tensors it is given, and by nothing else:

* CPU tensors run the plain version (the CPU tests' path);
* CUDA tensors launch the kernel, or raise. No flag, environment variable
  or ``impl=`` argument sends a CUDA tensor to the plain version.

Each CUDA wrapper adds one to its kernel's ``launches`` right after the
kernel launched, and nowhere else, so a run can show which kernels its
path went through (:func:`launch_counts`, :func:`reset_launch_counts`).
The count goes through :func:`count_launch`, under a lock: the service
launches from several worker threads at once, and a bare ``+= 1`` there
could lose counts. A CUDA graph's capture records its launches instead
(:func:`recorded_launches`), and each replay adds them
(:func:`add_launches`).
Kernel names follow the JAX package's registry; the nomad_step,
cauchy_mean and frozen_attract pairs are two entries each, one per
direction.

Each entry also registers a :class:`KernelSpec` (the reference's registry
spec): its plain version, its CUDA entry with the launch plan as an
argument, the plans an autotuner may sweep and the default one, inputs
for any shape signature, the reference's check and bench shapes,
tolerance and cost model. :func:`validate` holds the CUDA entry to the
plain version at a signature's inputs; ``kernels/autotune.py`` sweeps the
plans, and K2's and K3's CUDA entries, called without a plan, take the
tuner's cached winner (else the default plan). ``capacity_admit`` registers a plain-only spec (``cuda=None``), as
the reference's is jnp-only. The reference's ``impl=``, its
``REPRO_KERNELS``/``REPRO_KERNEL_<NAME>`` overrides and interpret mode are
not ported: :func:`dispatch` picks the plain version or the kernel by
the tensors' device alone. Launches of
:func:`validate` and of a sweep are not counted (:func:`uncounted`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Kernel:
    name: str
    plain: Callable  # the plain PyTorch version (any device)
    cuda: Callable  # the CUDA wrapper: checks, launches, counts
    source: str  # the kernel's source file, from the root of the repo
    replaces: str  # file:line of the TPU kernel's pl.pallas_call
    launches: int = 0


_KERNELS: dict[str, Kernel] = {}
_COUNT_LOCK = threading.Lock()


def register(kernel: Kernel) -> Kernel:
    if kernel.name in _KERNELS:
        raise ValueError(f"kernel {kernel.name!r} already registered")
    _KERNELS[kernel.name] = kernel
    return kernel


def _load() -> None:
    import repro_torch.kernels.capacity_admit.ops  # noqa: F401
    import repro_torch.kernels.cauchy_mean.ops  # noqa: F401
    import repro_torch.kernels.frozen_attract.ops  # noqa: F401
    import repro_torch.kernels.kmeans_assign.ops  # noqa: F401
    import repro_torch.kernels.nomad_step.ops  # noqa: F401
    import repro_torch.kernels.pairwise.ops  # noqa: F401


def get(name: str) -> Kernel:
    _load()
    try:
        return _KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: {names()}") from None


def names() -> list[str]:
    _load()
    return sorted(_KERNELS)


def dispatch(name: str, *tensors, **options):
    """Run kernel ``name``: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors. Mixed or other devices raise. A ``None`` in
    ``tensors`` (an input the call does without) is passed on as it is,
    and so are the keyword ``options``."""
    kernel = get(name)
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return kernel.plain(*tensors, **options)
    if device.type == "cuda":
        return kernel.cuda(*tensors, **options)
    raise ValueError(f"{name}: no kernel for device {device}")


_UNCOUNTED = threading.local()  # depth of uncounted() on this thread


@contextlib.contextmanager
def uncounted():
    """Inside the block, this thread's launches are not counted: a check
    or a sweep launches the kernel beside a path, not on it."""
    depth = getattr(_UNCOUNTED, "depth", 0)
    _UNCOUNTED.depth = depth + 1
    try:
        yield
    finally:
        _UNCOUNTED.depth = depth


_RECORDING: list = []  # the launches of the open recorded_launches() block, if one is open


@contextlib.contextmanager
def recorded_launches():
    """Inside the block, launches from every thread are recorded in the
    dict it yields ({kernel name: launches}) and not counted: a CUDA
    graph's capture launches nothing, and each replay adds what its
    capture recorded (:func:`add_launches`). A capture's backward counts
    on autograd's device thread, hence not thread-local."""
    got: dict = {}
    with _COUNT_LOCK:
        _RECORDING.append(got)
    try:
        yield got
    finally:
        with _COUNT_LOCK:
            _RECORDING.remove(got)


def count_launch(kernel: Kernel) -> None:
    """Add one to ``kernel``'s launches; a CUDA wrapper calls this right
    after its kernel launched, and nowhere else."""
    if getattr(_UNCOUNTED, "depth", 0):
        return
    with _COUNT_LOCK:
        if _RECORDING:
            _RECORDING[-1][kernel.name] = _RECORDING[-1].get(kernel.name, 0) + 1
        else:
            kernel.launches += 1


def add_launches(launches: dict) -> None:
    """Add ``{kernel name: launches}`` to the counts: a CUDA graph's replay
    runs the launches its capture recorded."""
    with _COUNT_LOCK:
        for name, n in launches.items():
            _KERNELS[name].launches += n


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return {n: get(n).launches for n in names()}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for n in names():
            get(n).launches = 0


def require_cuda(kernel: str, **tensors: torch.Tensor) -> torch.device:
    """The common checks of every CUDA wrapper: each tensor on one CUDA
    device and contiguous. Returns that device."""
    device = None
    for label, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {label} is on {t.device}, not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {label} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{kernel}: {label} is on {t.device}, others on {device}")
    return device


def require_dtype(kernel: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for label, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {label} must be {dtype}, got {t.dtype}")


# ---------------------------------------------------------------------------
# Specs: the reference's registry contract for each kernel
# ---------------------------------------------------------------------------

# (shape, dtype name) per argument: the unit the autotune cache is keyed on
# and ``make_inputs`` draws from
ShapeSig = Tuple[Tuple[Tuple[int, ...], str], ...]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32, "bool": torch.bool}


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """What the checks, the benchmarks and the autotuner need of a kernel.

    ``cuda(*args, plan=...)`` launches the kernel with a launch plan (a
    dict; ``plan_candidates(sig)`` lists the ones a sweep may time and
    ``default_plan(sig, device)`` is the one the wrappers pick by
    themselves); None for a plain-only kernel. ``make_inputs(generator,
    sig)`` draws the arguments of a signature on the generator's device
    (values rounded to the signature's dtype, held in ``dtype_grid``'s,
    the dtypes the CUDA entry takes, as the callers cast them).
    ``check_shapes`` and ``bench_shapes`` are the reference spec's (the
    backward entries take the forward's signature), ``tol`` its (rtol,
    atol), ``oracle_check(args, got, want)`` a rule in place of it (raising
    on a mismatch), ``cost_model(sig)`` one call's ``{"flops", "bytes"}``
    (the reference's at the same signature for a forward)."""

    name: str
    reference: str  # the JAX package's registry name
    plain: Callable[..., Any]
    cuda: Optional[Callable[..., Any]]
    plan_candidates: Callable[[ShapeSig], tuple]
    default_plan: Callable[[ShapeSig, torch.device], dict]
    make_inputs: Callable[[torch.Generator, ShapeSig], tuple]
    check_shapes: Tuple[ShapeSig, ...]
    bench_shapes: ShapeSig
    tol: Tuple[float, float] = (1e-5, 1e-5)
    oracle_check: Optional[Callable[[tuple, Any, Any], None]] = None
    cost_model: Optional[Callable[[ShapeSig], dict]] = None
    dtype_grid: Tuple[str, ...] = ("float32",)


_SPECS: dict[str, KernelSpec] = {}


def register_spec(spec: KernelSpec) -> KernelSpec:
    if spec.name in _SPECS:
        raise ValueError(f"spec {spec.name!r} already registered")
    _SPECS[spec.name] = spec
    return spec


def spec(name: str) -> KernelSpec:
    _load()
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"no spec {name!r}; registered: {spec_names()}") from None


def spec_names() -> list[str]:
    """Every spec: each kernel's, and the plain-only ``capacity_admit``."""
    _load()
    return sorted(_SPECS)


def shape_sig(args: Sequence[Any]) -> ShapeSig:
    """Static (shape, dtype name) signature of the tensor arguments."""
    return tuple((tuple(a.shape), str(a.dtype).removeprefix("torch.")) for a in args)


def fixed_plan(fn: Callable, default: Optional[Callable] = None) -> tuple:
    """(cuda entry, plan_candidates, default_plan) of a kernel whose plan is
    its own (it fixes the order of its sums, so no other is offered): the
    entry takes ``plan`` and refuses any but ``default(sig)``'s."""

    def plan_of(sig, device=None) -> dict:
        return {} if default is None else default(sig)

    def call(*args, plan=None):
        if plan is not None and plan != plan_of(shape_sig(a for a in args if isinstance(a, torch.Tensor))):
            raise ValueError(f"{fn.__name__}: the plan is fixed by the shapes, got {plan}")
        return fn(*args)

    return call, (lambda sig: (plan_of(sig),)), plan_of


def draw(gen: torch.Generator, shape, dtype: str, *, scale: float = 1.0, uniform: bool = False,
         high: Optional[int] = None) -> torch.Tensor:
    """One argument of ``make_inputs``: normal (× scale) or uniform [0, 1)
    floats rounded to ``dtype`` and held in float32, or int32 in [0, high)."""
    dev = gen.device
    if dtype == "int32":
        return torch.randint(0, high, tuple(shape), generator=gen, device=dev, dtype=torch.int32)
    t = torch.rand(tuple(shape), generator=gen, device=dev) if uniform else torch.randn(
        tuple(shape), generator=gen, device=dev) * scale
    return t.to(DTYPES[dtype]).float()


def output_leaves(out) -> list:
    """A kernel's outputs as a flat list of tensors (tuples flattened, a
    None output left out)."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in output_leaves(o)]
    return [] if out is None else [out]


def validate(name: str, args: tuple, *, plan: Optional[dict] = None):
    """Run kernel ``name``'s CUDA entry (``plan``, default the spec's
    default plan) against its plain version on ``args``; raise on a
    mismatch (the spec's ``oracle_check``, else every output allclose
    within ``tol``). The launch is not counted. Raises for a plain-only
    kernel and for CPU tensors: no kernel runs there."""
    sp = spec(name)
    if sp.cuda is None:
        raise ValueError(f"kernel {name!r} is plain-only (cuda=None): no kernel to validate")
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: validate launches the CUDA kernel, and the inputs are on "
                         f"{sorted(map(str, devices))}: no kernel runs on the CPU")
    (device,) = devices
    if plan is None:
        plan = sp.default_plan(shape_sig([a for a in args if isinstance(a, torch.Tensor)]), device)
    with uncounted():
        got = sp.cuda(*args, plan=plan)
    want = sp.plain(*args)
    if sp.oracle_check is not None:
        sp.oracle_check(args, got, want)
        return got, want
    g_leaves, w_leaves = output_leaves(got), output_leaves(want)
    if len(g_leaves) != len(w_leaves):
        raise AssertionError(f"{name}: {len(g_leaves)} outputs against {len(w_leaves)}")
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(), w.detach().float().cpu().numpy(),
                                   rtol=sp.tol[0], atol=sp.tol[1])
    return got, want
