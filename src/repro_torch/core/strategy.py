"""Execution strategies: where and how one NOMAD epoch runs.

This slice ports :class:`LocalStrategy`, the single-device loop; the
sharded and hierarchical strategies come with the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import NomadConfig


class LocalStrategy:
    """Single-device loop (``core/nomad.py:run_epoch``). ``prepare`` moves
    θ and the index arrays to the device; ``run_epoch`` steps θ in place."""

    def prepare(self, cfg: NomadConfig, method: str, index, theta0, device) -> torch.Tensor:
        self.cfg, self.method = cfg, method
        self.steps = cfg.resolved_steps_per_epoch()
        counts = np.asarray(index.counts)
        self.idx = {
            "knn_idx": torch.as_tensor(np.asarray(index.knn_idx), dtype=torch.int64, device=device),
            "knn_w": torch.as_tensor(np.asarray(index.knn_w), dtype=torch.float32, device=device),
            "counts": torch.as_tensor(counts, dtype=torch.int64, device=device),
            "cum_counts": torch.as_tensor(np.cumsum(counts), dtype=torch.int64, device=device),
            "total": int(counts.sum()),
        }
        # a private copy: the epochs update it in place
        return torch.tensor(np.asarray(theta0), dtype=torch.float32, device=device)

    def run_epoch(self, theta, epoch: int, lr0: float, lr1: float):
        from repro_torch.core.nomad import run_epoch

        theta, loss = run_epoch(theta, self.idx, self.cfg, self.method, self.steps, lr0, lr1, epoch)
        return theta, float(loss)

    def fetch(self, theta: torch.Tensor) -> np.ndarray:
        return theta.cpu().numpy()
