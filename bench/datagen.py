"""The benchmark's inputs, made on the device from ``--seed``.

A configuration's ``data`` block names the generator and its parameters.
The one generator, ``hierarchical_mixture``, draws the two-level corpus
the port's ``data.synthetic.hierarchical_mixture`` describes: ``n_groups``
unit-norm group centres, ``per_group`` components around each (offsets of
total norm ``group_spread``), each row a component plus isotropic noise of
total norm ``spread``. It draws with ``torch.Generator``s on the card, in
row chunks, so a few million rows take a fraction of a second instead of
the minutes numpy takes on the host. With more components than cells and
overlapping groups, k-means runs many E-steps, as on a real corpus.
Separate streams of one seed give the training rows and the query rows,
from the same components.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ROWS = 131_072
TRAIN_STREAM, QUERY_STREAM, CENTRE_STREAM = 1, 2, 0


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, *[int(s) for s in stream]]).generate_state(2, np.uint32)
    return ((int(state[0]) << 31) ^ int(state[1])) & (2**63 - 1)


def generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


def mixture_centres(data: dict, dim: int, seed: int, device) -> torch.Tensor:
    """The components (n_groups · per_group, dim): unit-norm group centres,
    each with ``per_group`` offsets of N(0, group_spread² / dim) a coordinate."""
    if data.get("kind") != "hierarchical_mixture":
        raise ValueError(f"unknown data kind {data.get('kind')!r}")
    g = generator(device, seed, CENTRE_STREAM)
    groups = torch.randn((data["n_groups"], dim), generator=g, device=device)
    groups = groups / torch.linalg.vector_norm(groups, dim=1, keepdim=True)
    offsets = torch.randn((data["n_groups"], data["per_group"], dim), generator=g, device=device)
    comps = groups[:, None, :] + float(data["group_spread"]) / float(np.sqrt(dim)) * offsets
    return comps.reshape(-1, dim)


def mixture_rows(data: dict, centres: torch.Tensor, n: int, seed: int, *stream: int) -> torch.Tensor:
    """``n`` rows (n, dim) float32 on the centres' device: a component drawn
    uniformly for each, plus N(0, spread² / dim) noise in each coordinate."""
    device, dim = centres.device, centres.shape[1]
    g = generator(device, seed, *stream)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    sigma = float(data["spread"]) / float(np.sqrt(dim))
    for s in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - s)
        lab = torch.randint(0, centres.shape[0], (m,), generator=g, device=device)
        out[s : s + m] = centres[lab] + sigma * torch.randn((m, dim), generator=g, device=device)
    return out


def pca_init(x: torch.Tensor, out_dim: int, scale: float) -> torch.Tensor:
    """θ's start (N, out_dim): the rows projected on their top principal
    directions (float64 covariance), each coordinate scaled to std
    ``scale``, the sign of each direction fixed by its largest entry."""
    n, dim = x.shape
    mu = torch.zeros(dim, dtype=torch.float64, device=x.device)
    for s in range(0, n, CHUNK_ROWS):
        mu += x[s : s + CHUNK_ROWS].double().sum(0)
    mu /= n
    cov = torch.zeros((dim, dim), dtype=torch.float64, device=x.device)
    for s in range(0, n, CHUNK_ROWS):
        xc = x[s : s + CHUNK_ROWS].double() - mu
        cov += xc.T @ xc
    _, vecs = torch.linalg.eigh(cov / n)
    top = vecs[:, -out_dim:].flip(1)
    top = top * torch.sign(top.gather(0, top.abs().argmax(0, keepdim=True)))
    proj = torch.empty((n, out_dim), dtype=torch.float64, device=x.device)
    for s in range(0, n, CHUNK_ROWS):
        proj[s : s + CHUNK_ROWS] = (x[s : s + CHUNK_ROWS].double() - mu) @ top
    proj = proj / proj.std(0, keepdim=True) * scale
    return proj.float()


def to_host(x: torch.Tensor) -> np.ndarray:
    """A device tensor's host copy through a pinned buffer, in chunks."""
    out = np.empty(tuple(x.shape), dtype=np.float32)
    if x.device.type != "cuda":
        out[...] = x.numpy()
        return out
    flat = out.reshape(x.shape[0], -1)
    buf = torch.empty((CHUNK_ROWS, flat.shape[1]), dtype=torch.float32, pin_memory=True)
    for s in range(0, x.shape[0], CHUNK_ROWS):
        m = min(CHUNK_ROWS, x.shape[0] - s)
        buf[:m].copy_(x[s : s + m].reshape(m, -1))
        flat[s : s + m] = buf[:m].numpy()
    return out
