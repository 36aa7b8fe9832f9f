"""The model zoo's sequence forward, the embed pipeline's embedder (the port
of the JAX package's ``repro.models``; the training steps, caches and
decode wait)."""

from repro_torch.models import attention, convert, layers, lm, moe, ssm

__all__ = ["attention", "convert", "layers", "lm", "moe", "ssm"]
