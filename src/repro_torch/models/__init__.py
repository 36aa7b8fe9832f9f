"""The model zoo (the port of the JAX package's ``repro.models``): the
sequence forward the embed pipeline runs, the serving path (prefill into
a KV/SSM cache then ``decode_step``) and the training step (``steps``:
the cross-entropy loss and the microbatched train step)."""

from repro_torch.models import attention, convert, layers, lm, moe, ssm, steps

__all__ = ["attention", "convert", "layers", "lm", "moe", "ssm", "steps"]
