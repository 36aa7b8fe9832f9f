"""Llama-4 Scout 17B-active / 16-expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
with one shared expert (Llama-4 MoE recipe), early-fusion multimodal family —
we model the text backbone. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_period=1,
    rope_theta=5e5,
    accum_steps=8,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)
