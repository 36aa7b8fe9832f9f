"""Mixtral 8x7B.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding-window attention (w=4096). SWA makes the arch sub-quadratic, so it
runs the ``long_500k`` cell (the KV cache is a 4096-token ring buffer).
[arXiv:2401.04088; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    n_experts=8,
    top_k=2,
    moe_period=1,
    sliding_window=4096,
    rope_theta=1e6,
    accum_steps=8,
    source="arXiv:2401.04088",
)
