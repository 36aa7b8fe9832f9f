"""The model zoo (the port of the JAX package's ``repro.models``): the
sequence forward the embed pipeline runs, and the serving path, prefill
into a KV/SSM cache then ``decode_step``. The training steps wait."""

from repro_torch.models import attention, convert, layers, lm, moe, ssm, steps

__all__ = ["attention", "convert", "layers", "lm", "moe", "ssm", "steps"]
