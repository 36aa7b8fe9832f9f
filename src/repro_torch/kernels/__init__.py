"""Hand-written Hopper kernels, their plain PyTorch versions, and the
registry that picks between them by device (see ``registry``)."""
