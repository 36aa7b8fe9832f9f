"""The parametric inverse projection (2D → embedding) the service's
``explore`` decodes with.

A served map answers "where does this vector live?" (``MapServer.
transform``); ``explore`` answers the other direction, "what lives at
this spot?": a small MLP decodes a 2D coordinate into an embedding-space
vector, and the frozen index returns the corpus rows nearest to it. The
head trains on (θ, x) pairs of the fitted map itself and is saved beside
the map's checkpoint as ``inverse.npz``, in the JAX package's format
(``repro/pipeline/inverse.py``), readable both ways.

The head is bit-equal across reruns of one seed on one device: its
initial weights and every minibatch's indices come from one
``torch.Generator`` on the CPU seeded by ``seed``, so the card and the
CPU train from the same draws. Across frameworks it is not (threefry
against Philox). Matrix products run in full float32 on the card under
PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``, which
the head reads and never writes (``chip_smoke.py`` holds the card's
decode to the CPU's, and reads how far a TF32 decode strays).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

INVERSE_FILE = "inverse.npz"

@dataclasses.dataclass
class InverseProjection:
    """A trained 2D → embedding decoder head.

    ``layers`` is a list of ``(w, b)`` float32 numpy pairs; inputs are
    standardised by ``(mu_in, sd_in)``, stored with the head so a loaded
    head needs nothing else. The weights live on the host; :meth:`decode`
    copies them to the device it is asked for (~0.1 MB at 2→128→128→768).
    """

    layers: List[Tuple[np.ndarray, np.ndarray]]
    mu_in: np.ndarray  # (in_dim,) input standardiser
    sd_in: np.ndarray  # (in_dim,)
    seed: int = 0
    train_steps: int = 0
    train_loss: float = float("nan")  # final-step batch MSE

    @property
    def in_dim(self) -> int:
        return int(self.layers[0][0].shape[0])

    @property
    def out_dim(self) -> int:
        return int(self.layers[-1][0].shape[1])

    @property
    def hidden(self) -> Tuple[int, ...]:
        return tuple(int(w.shape[1]) for w, _ in self.layers[:-1])

    def params(self, device) -> tuple:
        """(weights, biases, mu, sd) as float32 tensors on ``device``."""
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        return [up(w) for w, _ in self.layers], [up(b) for _, b in self.layers], up(self.mu_in), up(self.sd_in)

    def decode(self, theta, *, device=None) -> np.ndarray:
        """Map 2D coordinates ``(B, in_dim)`` to embedding vectors
        ``(B, out_dim)``: float32, on the host, computed on ``device``
        (default: the card; pass ``"cpu"`` for the CPU)."""
        from repro_torch.index.build import resolve_device

        q = np.asarray(theta, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.in_dim:
            raise ValueError(
                f"decode: expected (n, {self.in_dim}) coordinates, "
                f"got shape {q.shape}"
            )
        if not np.isfinite(q).all():
            raise ValueError("decode: coordinates contain NaN/Inf")
        device = resolve_device(device)
        ws, bs, mu, sd = self.params(device)
        with torch.no_grad():
            out = mlp_apply(ws, bs, mu, sd, torch.from_numpy(np.ascontiguousarray(q)).to(device))
        return out.cpu().numpy()


# -- the MLP ------------------------------------------------------------------


def mlp_apply(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], mu: torch.Tensor,
              sd: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Standardise, then ``h @ w + b`` a layer with the tanh GELU between
    layers (``jax.nn.gelu``'s default, not the exact GELU)."""
    h = (q - mu) / sd
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w + b
        if i < len(ws) - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def init_params(gen: torch.Generator, dims: List[int]) -> List[torch.Tensor]:
    """[w0, b0, w1, b1, ...] on the CPU: He-normal weights (the last layer
    scaled by 0.1, to start near the mean target), zero biases."""
    params = []
    for i in range(len(dims) - 1):
        scale = float(np.sqrt(2.0 / dims[i]))
        if i == len(dims) - 2:
            scale *= 0.1
        params.append(torch.randn((dims[i], dims[i + 1]), generator=gen, dtype=torch.float32) * scale)
        params.append(torch.zeros((dims[i + 1],), dtype=torch.float32))
    return params


def train_step(params: List[torch.Tensor], opt_state: dict, opt, thb: torch.Tensor,
               xb: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor):
    """One minibatch step: the MSE of the decode of ``thb`` against ``xb``,
    its gradient, one AdamW update. Returns (params, state, loss)."""
    ps = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        pred = mlp_apply(ps[0::2], ps[1::2], mu, sd, thb)
        loss = torch.mean(torch.square(pred - xb))
        grads = torch.autograd.grad(loss, ps)
    with torch.no_grad():
        new, opt_state = opt.update(params, grads, opt_state)
    return new, opt_state, loss.detach()


# -- training -----------------------------------------------------------------


def _fit_head(th: np.ndarray, gather_x: Callable[[torch.Tensor], torch.Tensor], out_dim: int, device, *,
              hidden, steps, batch, lr, weight_decay, seed) -> InverseProjection:
    """The training loop of :func:`train_inverse`: θ on the host in corpus
    order, ``gather_x(idx)`` the matching x rows on ``device``."""
    from repro_torch.optim import AdamW, warmup_cosine

    n = th.shape[0]
    batch = min(batch, n)
    mu = th.mean(0)
    sd = np.maximum(th.std(0), 1e-6)
    dims = [th.shape[1], *hidden, out_dim]
    gen = torch.Generator().manual_seed(int(seed))
    params = [p.to(device) for p in init_params(gen, dims)]
    idx_all = torch.randint(0, n, (steps, batch), generator=gen).to(device)
    opt = AdamW(
        schedule=warmup_cosine(lr, min(100, max(1, steps // 10)), steps),
        weight_decay=weight_decay,
        moment_dtype="float32",
    )
    state = opt.init(params)
    thd = torch.from_numpy(np.ascontiguousarray(th)).to(device)
    mud = torch.from_numpy(mu.astype(np.float32)).to(device)
    sdd = torch.from_numpy(sd.astype(np.float32)).to(device)
    loss = torch.full((), float("nan"))
    for t in range(steps):
        idx = idx_all[t]
        params, state, loss = train_step(params, state, opt, thd[idx], gather_x(idx), mud, sdd)
    layers = [(params[2 * i].cpu().numpy(), params[2 * i + 1].cpu().numpy()) for i in range(len(dims) - 1)]
    return InverseProjection(
        layers=layers,
        mu_in=mu.astype(np.float32),
        sd_in=sd.astype(np.float32),
        seed=seed,
        train_steps=steps,
        train_loss=float(loss),
    )


def train_inverse(
    theta,
    x,
    *,
    hidden: Tuple[int, ...] = (128, 128),
    steps: int = 1_500,
    batch: int = 512,
    lr: float = 3e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    device=None,
) -> InverseProjection:
    """Fit the decoder on (θ, x) pairs of a trained map on ``device``
    (default: the card).

    ``theta`` is the fitted ``(N, out_dim)`` embedding, ``x`` the matching
    ``(N, D)`` input vectors. Inputs are standardised
    by θ's mean and ``max(std, 1e-6)`` in numpy float32; each step draws
    ``batch`` rows, takes the MSE, its gradient and one AdamW update under
    ``warmup_cosine``.
    """
    from repro_torch.index.build import resolve_device

    th = np.asarray(theta, np.float32)
    xs = np.asarray(x, np.float32)
    if th.ndim != 2 or xs.ndim != 2 or th.shape[0] != xs.shape[0]:
        raise ValueError(
            f"train_inverse: want matched (N, in_dim)/(N, D) pairs, got "
            f"{th.shape} / {xs.shape}"
        )
    if th.shape[0] < 2:
        raise ValueError("train_inverse: need at least 2 (θ, x) pairs")
    device = resolve_device(device)
    xd = torch.from_numpy(np.ascontiguousarray(xs)).to(device)
    return _fit_head(th, lambda idx: xd[idx], xd.shape[1], device, hidden=hidden, steps=steps,
                     batch=batch, lr=lr, weight_decay=weight_decay, seed=seed)


def inverse_from_frozen(frozen, *, hidden: Tuple[int, ...] = (128, 128), steps: int = 1_500,
                        batch: int = 512, lr: float = 3e-3, weight_decay: float = 1e-4,
                        seed: int = 0) -> InverseProjection:
    """Train the head from a :class:`repro_torch.serve.frozen.FrozenMap`, on
    the map's device: the (θ, x) pairs are the map's valid rows in original
    corpus order, as :func:`train_inverse` of the unpermuted arrays takes
    them. θ (N × out_dim) comes to the host for the standardiser; x stays
    in the frozen ``x_rows``, and each minibatch gathers its rows there."""
    with torch.no_grad():
        valid = frozen.inv_perm >= 0
        rows = torch.nonzero(valid).squeeze(1)
        row_of = torch.empty_like(rows)
        row_of[frozen.inv_perm[rows]] = rows  # corpus id → frozen row
        theta = frozen.theta_rows[row_of].cpu().numpy()
    x_rows = frozen.x_rows
    return _fit_head(theta, lambda idx: x_rows[row_of[idx]], frozen.dim, frozen.device, hidden=hidden,
                     steps=steps, batch=batch, lr=lr, weight_decay=weight_decay, seed=seed)


def roundtrip_score(inv: InverseProjection, theta, x, *, device=None) -> float:
    """Fraction of embedding-space variance the inverse recovers:
    ``1 − ‖decode(θ) − x‖² / ‖x − x̄‖²`` (R²; 1 = perfect, ≤ 0 = no better
    than predicting the mean)."""
    xs = np.asarray(x, np.float32)
    pred = inv.decode(theta, device=device)
    mse = float(np.mean(np.square(pred - xs)))
    var = float(np.mean(np.square(xs - xs.mean(0))))
    return 1.0 - mse / max(var, 1e-12)


# -- persistence --------------------------------------------------------------


def inverse_path(checkpoint_dir: str) -> str:
    """Where the head lives inside a map's checkpoint directory: beside
    ``index.npz``, so every lineage version directory stays self-contained
    and a hot swap carries the head with the map."""
    return os.path.join(checkpoint_dir, INVERSE_FILE)


def save_inverse(checkpoint_dir: str, inv: InverseProjection) -> str:
    """Atomic (tmp + replace) write of ``inverse.npz``. Returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = inverse_path(checkpoint_dir)
    payload = {"mu_in": inv.mu_in, "sd_in": inv.sd_in}
    for i, (w, b) in enumerate(inv.layers):
        payload[f"w{i}"] = w
        payload[f"b{i}"] = b
    payload["meta"] = np.frombuffer(
        json.dumps(
            {
                "n_layers": len(inv.layers),
                "seed": inv.seed,
                "train_steps": inv.train_steps,
                "train_loss": inv.train_loss,
            }
        ).encode(),
        dtype=np.uint8,
    )
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_inverse(checkpoint_dir: str, *, missing_ok: bool = False) -> Optional[InverseProjection]:
    """Load ``inverse.npz`` from a checkpoint dir. With ``missing_ok`` a map
    without a trained head returns ``None`` (the registry's probe);
    otherwise a missing file raises with the training hint."""
    path = inverse_path(checkpoint_dir)
    if not os.path.exists(path):
        if missing_ok:
            return None
        raise FileNotFoundError(
            f"no inverse head at {path} — train one with "
            "repro_torch.pipeline.inverse.train_inverse (or inverse_from_frozen) "
            "and save_inverse() it beside the map's checkpoint"
        )
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        layers = [
            (np.asarray(z[f"w{i}"], np.float32), np.asarray(z[f"b{i}"], np.float32))
            for i in range(int(meta["n_layers"]))
        ]
        return InverseProjection(
            layers=layers,
            mu_in=np.asarray(z["mu_in"], np.float32),
            sd_in=np.asarray(z["sd_in"], np.float32),
            seed=int(meta["seed"]),
            train_steps=int(meta["train_steps"]),
            train_loss=float(meta["train_loss"]),
        )
