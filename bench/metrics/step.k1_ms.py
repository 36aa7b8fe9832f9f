"""step.k1_ms: the host milliseconds a step spends in K1's forward and
backward (the program's ``nomad.step.k1`` spans: the loss through
``torch.autograd.grad``) in the profiled epochs, over the count of
steps."""

from bench.program_trace import step_ms


def read(ctx):
    return step_ms(ctx, "nomad.step.k1")
