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
could lose counts.
Kernel names follow the JAX package's registry; the nomad_step,
cauchy_mean and frozen_attract pairs are two entries each, one per
direction.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

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


def count_launch(kernel: Kernel) -> None:
    """Add one to ``kernel``'s launches; a CUDA wrapper calls this right
    after its kernel launched, and nowhere else."""
    with _COUNT_LOCK:
        kernel.launches += 1


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
