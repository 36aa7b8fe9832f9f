"""Yi-34B (llama-architecture GQA).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. [arXiv:2403.04652; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    rope_theta=5e6,
    accum_steps=8,
    source="arXiv:2403.04652",
)
