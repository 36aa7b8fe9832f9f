"""The benchmark's frozen arithmetic: the H100's published peaks, each
kernel's operations, SFU operations and bytes for one call, and the
necessary work of a training epoch, an index build and a served batch.

Copied from the counts that measured the port's kernels on the card
(``chip_smoke.py``: ``bound_ms``, ``sfu_rate`` and the per-kernel counts
beside each check), and kept here so that a later change to the program
cannot move the yardstick. Nothing here imports the program.

A *bound* is the least time the work can take on the card: the largest of
its matrix products at three TF32 passes on the tensor cores (the 3xTF32
tile, fp32-accurate), its other operations at the fp32 rate of the CUDA
cores, its reciprocals and logs on the special-function units, and its
bytes at the memory rate. Each term alone is a lower bound on the time, so
the largest is too, and a share of it never passes 100% when the work is
counted right.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM 80GB, dense rates without sparsity, at the 700 W limit
PEAK_FP32_FLOPS = 67e12  # CUDA cores
PEAK_TF32_FLOPS = 495e12  # tensor cores
TF32X3_PASSES = 3  # the 3xTF32 tile runs three TF32 products
PEAK_BYTES_PER_S = 3.35e12  # HBM3
SMS = 132
SFU_PER_CLOCK = 16  # reciprocals (and logs) an SM issues a clock
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_SFU_OPS = SMS * SFU_PER_CLOCK * MAX_SM_CLOCK_HZ  # 4.18e12 a second


class Work:
    """Operations and bytes of some work, by the unit that runs them."""

    def __init__(self, tensor_flops=0.0, fp32_flops=0.0, sfu_ops=0.0, nbytes=0.0):
        self.tensor_flops = float(tensor_flops)
        self.fp32_flops = float(fp32_flops)
        self.sfu_ops = float(sfu_ops)
        self.nbytes = float(nbytes)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.tensor_flops + other.tensor_flops, self.fp32_flops + other.fp32_flops,
                    self.sfu_ops + other.sfu_ops, self.nbytes + other.nbytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.tensor_flops * n, self.fp32_flops * n, self.sfu_ops * n, self.nbytes * n)

    __rmul__ = __mul__

    def terms_s(self) -> dict:
        return {
            "tensor": TF32X3_PASSES * self.tensor_flops / PEAK_TF32_FLOPS,
            "fp32": self.fp32_flops / PEAK_FP32_FLOPS,
            "sfu": self.sfu_ops / PEAK_SFU_OPS,
            "bytes": self.nbytes / PEAK_BYTES_PER_S,
        }

    def bound_s(self) -> float:
        """The least time on the card: the largest of the four terms."""
        return max(self.terms_s().values())

    def bound_by(self) -> str:
        terms = self.terms_s()
        return max(terms, key=terms.get)


# ---------------------------------------------------------------------------
# One call of each kernel (PERF.md's kernel table)
# ---------------------------------------------------------------------------


def k1_fwd(B: int, k: int, S: int, K: int, d: int) -> Work:
    """K1 ``nomad_step`` forward: the walk over the K means and the k + S
    terms of each head."""
    per_head_in = B * d + B * k * d + B * k + B * S * d + B * S
    return Work(
        fp32_flops=B * (K * (5 * d + 4) + (k + S) * (3 * d + 12)),
        sfu_ops=B * K + B * S + 3 * B * k,
        nbytes=4.0 * (per_head_in + K * d + K + B + B * (2 + d)),
    )


def k1_bwd(B: int, k: int, S: int, K: int, d: int) -> Work:
    """K1 ``nomad_step`` backward: the k + S terms only."""
    per_head_in = B * d + B * k * d + B * k + B * S * d + B * S
    return Work(
        fp32_flops=B * (k + S) * (8 * d + 8),
        sfu_ops=B * S + 3 * B * k,
        nbytes=4.0 * (per_head_in + B * (2 + d) + B * d + B * k * d + B * S * d),
    )


def k2(n: int, K: int, D: int) -> Work:
    """K2 ``kmeans_assign``: n rows against K centroids, argmin and min."""
    return Work(tensor_flops=2.0 * n * K * D + 2.0 * n * K, nbytes=4.0 * (n * D + K * D + 2 * n))


def k3(b: int, n: int, m: int, D: int, tensor: bool = True) -> Work:
    """K3 ``pairwise``: b batches of (n, D) against (m, D), the (n, m)
    squared distances written. ``tensor``: the tile route (3xTF32);
    otherwise the row route on the CUDA cores."""
    flops = b * (2.0 * n * m * D + 4.0 * n * m)
    nbytes = 4.0 * b * (n * D + m * D + n * m)
    return Work(tensor_flops=flops, nbytes=nbytes) if tensor else Work(fp32_flops=flops, nbytes=nbytes)


def k4_fwd(B: int, K: int, d: int) -> Work:
    """K4 ``cauchy_mean`` forward: M̃ of B heads over K means."""
    return Work(fp32_flops=B * K * (3.0 * d + 4), sfu_ops=B * K,
                nbytes=4.0 * (B * d + K * d + K + B) + 4.0 * B)


def k4_bwd(B: int, K: int, d: int) -> Work:
    return Work(fp32_flops=B * K * (5.0 * d + 4), sfu_ops=B * K,
                nbytes=4.0 * (B * d + K * d + K + B) + 4.0 * B * (1 + d))


def k5_fwd(B: int, k: int, d: int) -> Work:
    """K5 ``frozen_attract`` forward: the k attraction terms of B queries."""
    return Work(fp32_flops=B * k * (3.0 * d + 12), sfu_ops=3 * B * k,
                nbytes=4.0 * (B * d + B * k * d + B * k + B) + 4.0 * B)


def k5_bwd(B: int, k: int, d: int) -> Work:
    return Work(fp32_flops=B * k * (5.0 * d + 9), sfu_ops=2 * B * k,
                nbytes=4.0 * (B * d + B * k * d + B * k + B) + 4.0 * B * (2 + d))


# ---------------------------------------------------------------------------
# Necessary work of the windows' units, from the configuration's shapes
# ---------------------------------------------------------------------------


def steps_per_epoch(cfg: dict) -> int:
    return cfg["steps_per_epoch"] or max(1, -(-cfg["n_points"] // cfg["batch_size"]))


def capacity(cfg: dict) -> int:
    return max(int(cfg["capacity_slack"] * cfg["n_points"] / cfg["n_clusters"]), cfg["n_neighbors"] + 2)


def train_step_work(cfg: dict) -> Work:
    """One SGD step: the loss of B heads over the K means, k positives and
    S in-cell negatives, forward and backward (K1's counts), and the sparse
    update reading and writing the (1 + k + S) rows it touched."""
    B, k, S, K, d = (cfg["batch_size"], cfg["n_neighbors"], cfg["n_exact_negatives"], cfg["n_clusters"],
                     cfg["out_dim"])
    update = Work(nbytes=2 * 4.0 * B * (1 + k + S) * d)
    return k1_fwd(B, k, S, K, d) + k1_bwd(B, k, S, K, d) + update


def epoch_work(cfg: dict) -> Work:
    return train_step_work(cfg) * steps_per_epoch(cfg)


def build_work(cfg: dict, counts=None) -> Work:
    """What any index build of N rows must compute: one assignment pass of
    every row against the K centroids (the E-step that k-means ends on;
    the program's earlier E-steps depend on when it converges and are not
    counted), the assignment's candidate pass (the same product), and the
    in-cell kNN of each cell's real rows (``counts``; every cell full to
    N / K when not given)."""
    N, D, K = cfg["n_points"], cfg["dim"], cfg["n_clusters"]
    if counts is None:
        sq = K * (N / K) ** 2
    else:
        sq = float(sum(int(c) ** 2 for c in counts))
    knn = Work(tensor_flops=2.0 * sq * D + 4.0 * sq, nbytes=4.0 * (N * D + sq))
    return k2(N, K, D) + k3(1, N, K, D) + knn


def serve_batch_work(cfg: dict, rows: int) -> Work:
    """One placed batch of ``rows`` queries: the nearest centroid (K2's
    product), the query kNN in the cell (K3's row route over C rows), and
    ``transform_steps`` frozen steps, each the Cauchy walk over the K means
    forward and backward (K4) and the k attraction terms (K5)."""
    K, D, k, d, T = cfg["n_clusters"], cfg["dim"], cfg["n_neighbors"], cfg["out_dim"], cfg["transform_steps"]
    C = capacity(cfg)
    step = k4_fwd(rows, K, d) + k4_bwd(rows, K, d) + k5_fwd(rows, k, d) + k5_bwd(rows, k, d)
    return k2(rows, K, D) + k3(rows, 1, C, D, tensor=False) + step * T


def share_pct(bound_s: float, measured_s: float):
    """100 · bound / measured, or None where nothing was measured."""
    if not measured_s or measured_s <= 0 or not math.isfinite(measured_s):
        return None
    return 100.0 * bound_s / measured_s
