"""InternVL2-76B backbone (InternViT + Llama-3-70B-class LM).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision frontend
(InternViT) is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings which are prepended to the text embeddings
(n_vision_patches of the seq_len budget). [arXiv:2404.16821; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    n_vision_patches=256,
    rope_theta=5e5,
    accum_steps=8,
    source="arXiv:2404.16821 (unverified)",
)
