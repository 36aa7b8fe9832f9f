"""Optimisers of the port (``repro.optim``'s, in PyTorch): AdamW with
float32, bfloat16 or int8 moments, SGD with optional momentum, the int8
quantiser of the moments and the learning-rate schedules. The inverse head
and the zoo's train step use them."""

from repro_torch.optim.adamw import AdamW
from repro_torch.optim.quantized import QTensor, dequantize_int8, quantize_int8
from repro_torch.optim.schedules import constant, linear_decay, warmup_cosine
from repro_torch.optim.sgd import SGD

__all__ = [
    "AdamW",
    "SGD",
    "constant",
    "linear_decay",
    "warmup_cosine",
    "quantize_int8",
    "dequantize_int8",
    "QTensor",
]
