"""Mamba-2 2.7B (SSD — state-space duality).

64L d_model=2560, attention-free, no dense MLP block (the Mamba-2 block is
the whole layer), vocab=50280, ssm_state=128. [arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no separate MLP block
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    accum_steps=8,
    source="arXiv:2405.21060 (unverified)",
)
