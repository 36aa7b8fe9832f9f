"""Qwen3-14B.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936; qk-norm + GQA.
[hf:Qwen/Qwen3-8B family scaling; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    accum_steps=8,
    source="hf:Qwen/Qwen3-14B",
)
