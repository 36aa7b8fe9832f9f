"""HuBERT X-Large (encoder-only audio transformer).

48L d_model=1280 16H (kv=16, i.e. MHA) d_ff=5120 vocab=504 (cluster targets).
Encoder-only ⇒ bidirectional attention, no decode step. The conv waveform
frontend is a stub per the assignment: ``input_specs`` provides precomputed
frame embeddings. [arXiv:2106.07447; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    accum_steps=4,
    source="arXiv:2106.07447 (unverified)",
)
