"""Roofline of the port on one H100: the step's op-level cost
(:mod:`repro_torch.roofline.op_cost`) and the terms at the card's peaks
(:mod:`repro_torch.roofline.analysis`)."""

from repro_torch.roofline.analysis import HW_H100, RooflineTerms, model_flops, roofline_terms
from repro_torch.roofline.op_cost import CostReport, analyze_ops, memory_analysis

__all__ = ["CostReport", "HW_H100", "RooflineTerms", "analyze_ops", "memory_analysis", "model_flops",
           "roofline_terms"]
