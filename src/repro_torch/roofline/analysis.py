"""Roofline terms on one NVIDIA H100 (the port's copy of the JAX package's
``roofline/analysis.py``, with the H100's peaks in place of the TPU's).

The report analysed is the step's own op-level cost on one card
(:mod:`repro_torch.roofline.op_cost`), so its numbers are per device and
the three terms are per-device times:

  compute    = flops_dev / peak_flops
  memory     = bytes_dev / hbm_bw
  collective = coll_bytes_dev / ici_bw       (0 on one card)

MODEL_FLOPS (the "useful work" yardstick) is 6·N·D for training and 2·N·D
for single forward passes (N = active params, D = tokens), plus the
attention term, and for decode the KV-cache term. ``MODEL_FLOPS /
(op FLOPs·chips)`` exposes remat, padding and capacity waste. Every
function takes the hardware table ``hw``; the formulas are the JAX
package's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.roofline.op_cost import CostReport

# NVIDIA H100 SXM data sheet (dense, no sparsity). ``sfu_rate`` is the
# special-function units' reciprocals and logs: 132 SMs × 16 a clock ×
# 1.98 GHz (the SM's top clock); ``ici_bw`` is NVLink's rate one way,
# unused on one card.
HW_H100 = {
    "peak_flops": 989e12,  # bf16 FLOP/s on the tensor cores
    "peak_flops_tf32": 495e12,  # TF32 FLOP/s on the tensor cores
    "peak_flops_fp32": 67e12,  # fp32 FLOP/s on the CUDA cores
    "hbm_bw": 3.35e12,  # B/s, HBM3
    "sfu_rate": 132 * 16 * 1.98e9,  # SFU operations a second (4.18e12)
    "hbm_bytes": 80e9,  # device memory
    "ici_bw": 450e9,  # B/s a direction, NVLink
    "name": "h100-sxm",
}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline lower-bound step time (terms overlap perfectly)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: 1.0 = perfectly compute-bound
        with zero waste."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops / self.hlo_flops_global * self.compute_s if self.hlo_flops_global else 0.0
        return ideal / self.bound_s


def roofline_terms(report: CostReport, n_chips: int, model_fl: float, hw: dict = HW_H100) -> RooflineTerms:
    compute_s = report.flops / hw["peak_flops"]
    memory_s = report.bytes / hw["hbm_bw"]
    collective_s = report.collective_bytes / hw["ici_bw"]
    hlo_global = report.flops * n_chips
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops=model_fl,
        hlo_flops_global=hlo_global,
        useful_ratio=(model_fl / hlo_global) if hlo_global else 0.0,
    )


def kernel_roofline(flops: float, bytes_: float, us: float, hw: dict = HW_H100) -> dict:
    """Achieved-vs-roofline summary for ONE kernel call: achieved GFLOP/s
    and GB/s, their fractions of the peaks, the roofline-bound time at
    those peaks, the achieved fraction of it, and which resource bounds
    the kernel. ``us`` is the measured wall time in µs."""
    s = us * 1e-6
    compute_s = flops / hw["peak_flops"]
    memory_s = bytes_ / hw["hbm_bw"]
    roofline_s = max(compute_s, memory_s)
    return {
        "gflops": flops / s / 1e9 if s > 0 else 0.0,
        "gbs": bytes_ / s / 1e9 if s > 0 else 0.0,
        "frac_peak_flops": (flops / s) / hw["peak_flops"] if s > 0 else 0.0,
        "frac_peak_bw": (bytes_ / s) / hw["hbm_bw"] if s > 0 else 0.0,
        "roofline_us": roofline_s * 1e6,
        "roofline_frac": roofline_s / s if s > 0 else 0.0,
        "bound": "compute" if compute_s >= memory_s else "memory",
    }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        flops += 2.0 * _attention_flops(cfg, B, S) * 3  # fwd + 2×bwd
        return flops
    if shape.kind == "prefill":
        tokens = B * S
        return 2.0 * n_active * tokens + 2.0 * _attention_flops(cfg, B, S)
    # decode: one token per sequence + full-cache attention reads
    flops = 2.0 * n_active * B
    Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if cfg.n_heads:
        n_attn_layers = sum(1 for l in range(cfg.n_layers) if cfg.layer_is_attention(l))
        flops += 4.0 * B * cfg.n_heads * cfg.head_dim * Sc * n_attn_layers
    if cfg.ssm_state:
        n_ssm = cfg.n_layers - sum(1 for l in range(cfg.n_layers) if cfg.layer_is_attention(l))
        flops += 6.0 * B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * n_ssm
    return flops


def _attention_flops(cfg: ArchConfig, B: int, S: int) -> float:
    """Score+PV matmul FLOPs for one forward pass (causal halving applied)."""
    if not cfg.n_heads:
        return 0.0
    n_attn = sum(1 for l in range(cfg.n_layers) if cfg.layer_is_attention(l))
    eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
    per_query = eff if cfg.sliding_window else S / 2  # causal triangle
    return 4.0 * B * S * per_query * cfg.n_heads * cfg.head_dim * n_attn


def nomad_model_flops(n_points, batch, k_nn, n_exact, n_clusters, steps) -> float:
    """Useful FLOPs of one NOMAD epoch: Cauchy affinities of positives,
    exact negatives, and the B×K mean term, fwd+bwd (×3)."""
    per_step = batch * (k_nn + n_exact + n_clusters) * 8.0  # ~8 flops/affinity
    return 3.0 * per_step * steps


def nomad_analytic_terms(cfg, n_chips: int, steps: int, hw: dict = HW_H100) -> dict:
    """Kernel-true per-device roofline terms for one NOMAD epoch: per step,
    the gathered/scattered θ rows (heads + kNN tails + exact negatives,
    read + write) plus the fused step kernel's own I/O (θ_i, μ, w in; s,
    dθ out), plus one full pass over the device's θ per mean refresh. The
    collective term is the means exchange of a multi-device fit, kept as
    the formula has it; one card sends nothing."""
    d = cfg.out_dim
    B = cfg.batch_size  # per shard
    touched = B * (1 + cfg.n_neighbors + cfg.n_exact_negatives)
    per_step = (
        2 * touched * d * 4  # gather + scatter of positions
        + touched * 4 * 2  # index reads
        + 2 * B * d * 4  # kernel θ_i in, dθ out
        + 2 * cfg.n_clusters * (d + 1) * 4  # μ, w (+ recompute in bwd)
        + 2 * B * 4  # s out / ḡ in
    )
    rows_local = (cfg.n_clusters // n_chips) * cfg.cluster_capacity
    refreshes = max(steps // (cfg.mean_refresh_steps or steps), 1)
    mem_bytes = per_step * steps + refreshes * rows_local * d * 4
    coll_bytes = refreshes * cfg.n_clusters * (d + 1) * 4
    flops = 3.0 * B * (cfg.n_neighbors + cfg.n_exact_negatives + cfg.n_clusters) * 8.0 * steps
    return {
        "compute_s": flops / hw["peak_flops"],
        "memory_s": mem_bytes / hw["hbm_bw"],
        "collective_s": coll_bytes / hw["ici_bw"],
    }
