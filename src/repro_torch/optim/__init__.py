"""Optimisers of the port: the float32 AdamW and the learning-rate
schedules the inverse head trains with (``repro.optim``'s, in PyTorch)."""

from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import constant, linear_decay, warmup_cosine

__all__ = ["AdamW", "constant", "linear_decay", "warmup_cosine"]
