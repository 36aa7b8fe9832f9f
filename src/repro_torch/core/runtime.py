"""What a process knows of its run: its device, its rank among the
processes of a ``torch.distributed`` group, and a barrier across them.

The fit, the index build, serving and the launchers all ask these
questions, so the answers live here, below every other module of the
port: this module imports only ``torch``. Without an initialised process
group a run is one process of rank 0, and :func:`barrier` does nothing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the first CUDA device; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def process_group():
    """``torch.distributed`` when a process group is initialised, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """Processes of the run: the process group's world size, else 1."""
    dist = process_group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    """This process's rank, else 0."""
    dist = process_group()
    return dist.get_rank() if dist is not None else 0


def barrier(tag: str = "barrier") -> None:
    """Every process waits here for the others (nothing in one process).
    ``tag`` names the point for a reader of the code."""
    dist = process_group()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()
