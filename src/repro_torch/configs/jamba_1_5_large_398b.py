"""Jamba 1.5 Large (398B total params).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; hybrid Mamba +
attention with a 1:7 interleave (one attention layer per 8-layer meta-block)
and MoE (16 experts, top-2) on every second layer, per the Jamba recipe.
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,  # layer l is attention iff l % 8 == 0  (1 attn : 7 mamba)
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    accum_steps=8,
    grad_accum_dtype="bfloat16",
    source="arXiv:2403.19887",
)
